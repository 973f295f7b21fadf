"""Config dataclasses and kwargs handlers of the training path.

A subset of :mod:`accelerate_tpu.utils.dataclasses`: the precision policy
(fp8 included, with ``Fp8RecipeKwargs``), the autocast and grad-scaler
handlers, the runtime telemetry's knobs (``TelemetryKwargs``), the tracker
types (``LoggerType``), gradient accumulation, the data loader
configuration, the RNG types, the project (checkpoint directory)
configuration, the fault-tolerance handler, the serving scheduler's
knobs (``ServingSchedulerKwargs``), and a ``ParallelismPlugin`` that
takes the one-device layout only. The other
layouts (data, fsdp, tensor, seq, pipe, expert axes), ZeRO, gradient
compression and optimizer offload raise ``NotImplementedError``: they are
queued in ROADMAP.md.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch


class PrecisionType(str, enum.Enum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"

    def __str__(self) -> str:
        return self.value


class LoggerType(str, enum.Enum):
    """The trackers ``Accelerator(log_with=...)`` takes (``"all"``: every
    one whose package is installed)."""

    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    MLFLOW = "mlflow"
    AIM = "aim"
    COMETML = "comet_ml"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    SWANLAB = "swanlab"
    TRACKIO = "trackio"
    JSONL = "jsonl"

    def __str__(self) -> str:
        return self.value


class KwargsHandler:
    """Base for kwargs containers passed to ``Accelerator(kwargs_handlers=[...])``."""

    def to_dict(self) -> dict:
        return copy.deepcopy(dataclasses.asdict(self))

    def to_kwargs(self) -> dict:
        """Only the fields that differ from the defaults."""
        default = self.__class__()
        this = dataclasses.asdict(self)
        return {k: v for k, v in this.items() if getattr(default, k) != v}


@dataclass
class AutocastKwargs(KwargsHandler):
    """Compute-dtype policy tweaks: parameters whose name contains one of
    ``keep_fp32_patterns`` (lower-cased) keep their f32 master as the
    compute copy under mixed precision."""

    enabled: bool = True
    keep_fp32_patterns: tuple = ("layernorm", "layer_norm", "ln_", "norm", "embedding_norm")


@dataclass
class ProfileKwargs(KwargsHandler):
    """``Accelerator.profile`` options, the JAX package's fields mapped onto
    ``torch.profiler``. The trace is a Chrome trace
    (``{output_trace_dir}/rank<i>.pt.trace.json``), which Perfetto and
    TensorBoard open, so ``create_perfetto_trace`` is always honoured.
    ``host_tracer_level`` 0 leaves out the host (CPU) activity, 1-2 trace
    it and 3 also records operator input shapes; ``python_tracer_level`` 1
    records Python stacks; ``device_tracer_level`` 1 traces the card (on a
    CUDA device). ``create_perfetto_link`` has no torch counterpart: it is
    dropped with one warning a process. ``on_trace_ready(trace_dir)`` runs
    once the trace is written."""

    output_trace_dir: Optional[str] = None
    create_perfetto_link: bool = False
    create_perfetto_trace: bool = True
    host_tracer_level: int = 2
    python_tracer_level: int = 0
    device_tracer_level: int = 1
    on_trace_ready: Optional[Callable] = None

    def profiler_kwargs(self, cuda: bool) -> dict:
        """Keyword arguments of ``torch.profiler.profile`` for these fields."""
        from torch.profiler import ProfilerActivity

        if self.create_perfetto_link:
            _warn_dropped_profile_options(["create_perfetto_link"])
        activities = []
        if self.host_tracer_level > 0:
            activities.append(ProfilerActivity.CPU)
        if self.device_tracer_level > 0 and cuda:
            activities.append(ProfilerActivity.CUDA)
        return {
            "activities": activities or [ProfilerActivity.CPU],
            "record_shapes": self.host_tracer_level >= 3,
            "with_stack": self.python_tracer_level > 0,
        }


_dropped_profile_options_warned = False


def _warn_dropped_profile_options(fields) -> None:
    """One warning a process for ProfileKwargs fields torch cannot honour."""
    global _dropped_profile_options_warned
    if _dropped_profile_options_warned:
        return
    _dropped_profile_options_warned = True
    logging.getLogger(__name__).warning(
        "ProfileKwargs: torch.profiler has no counterpart of %s; ignored", ", ".join(fields)
    )


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss-scaling knobs for fp16 (torch GradScaler semantics)."""

    init_scale: float = 2.0**15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class Fp8RecipeKwargs(KwargsHandler):
    """The fp8 recipe (TransformerEngine's knobs, as the JAX package keeps
    them). ``delayed_scaling=True`` keeps an amax history per tensor (the
    buffers of :class:`~..ops.fp8.FP8Dense`, threaded through the train
    step as ``Model.state``) and scales by ``max(history) * 2**margin``;
    ``False`` takes each tensor's amax on every call (the dynamic recipe,
    no state). A bare ``mixed_precision="fp8"`` runs the dynamic recipe;
    pass this handler for the delayed one."""

    delayed_scaling: bool = True
    amax_history_len: int = 16
    amax_compute_algo: str = "max"  # "max" | "most_recent"
    margin: int = 0

    def __post_init__(self):
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError(f"amax_compute_algo must be max|most_recent, got {self.amax_compute_algo!r}")
        if self.amax_history_len < 1:
            raise ValueError(f"amax_history_len must be >= 1, got {self.amax_history_len}")


@dataclass
class TelemetryKwargs(KwargsHandler):
    """The runtime telemetry's knobs, read by ``Accelerator.telemetry``
    (:mod:`..telemetry`).

    ``output_path=None`` writes ``{logging_dir}/telemetry.jsonl``
    (``runs/telemetry.jsonl`` without a logging or project dir);
    ``fence=False`` drops the per-step ``torch.cuda.synchronize`` (the
    data-wait / dispatch / execute split then degrades);
    ``forward_to_trackers_every=N`` pushes a rolling summary through
    ``Accelerator.log`` every N steps (0: never); ``nonfinite_every=N``
    probes the loss and the gradient norm for NaN/inf every N steps of
    the train step (a host sync each; 0, the default, is off).

    The request-tracing and flight-recorder fields (``trace_*``,
    ``flight_*``) are kept with their defaults: the serving tracer and the
    flight recorder are ROADMAP.md Queue 1 item 10, so any other value
    raises."""

    enabled: bool = True
    output_path: Optional[str] = None
    # 2, not 1, as in the JAX package: its second call may compile a second
    # program variant; the port keeps the count so both warm up alike
    warmup_steps: int = 2
    fence: bool = True
    recompile_watchdog: bool = True
    hbm_sample_every: int = 10
    forward_to_trackers_every: int = 10
    nonfinite_every: int = 0
    main_process_only: bool = True
    trace_requests: bool = False
    trace_max_traces: int = 4096
    trace_drift_check: bool = True
    flight_recorder: bool = True
    flight_capacity: int = 256
    flight_dump_dir: Optional[str] = None

    def __post_init__(self):
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if self.hbm_sample_every < 0 or self.forward_to_trackers_every < 0:
            raise ValueError("hbm_sample_every / forward_to_trackers_every must be >= 0")
        if self.nonfinite_every < 0:
            raise ValueError(f"nonfinite_every must be >= 0, got {self.nonfinite_every}")
        changed = [
            f.name for f in dataclasses.fields(self)
            if f.name.startswith(("trace_", "flight_")) and getattr(self, f.name) != f.default
        ]
        if changed:
            raise NotImplementedError(
                f"TelemetryKwargs({', '.join(changed)}): request tracing and the flight recorder are not ported "
                "to accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 10)"
            )

    def trace_config(self):
        """None: request tracing is off (the only setting the port takes)."""
        return None


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """``sync_with_dataloader`` forces a sync on the last batch of each
    dataloader pass."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(f"gradient accumulation num_steps must be >= 1, got {self.num_steps}")


@dataclass
class MixedPrecisionPolicy(KwargsHandler):
    """Params stay in ``param_dtype`` (the f32 master copy), the forward
    runs on a ``compute_dtype`` copy, the loss comes back in f32.
    ``softmax_dtype`` is the einsum attention path's softmax dtype (None:
    f32), as in the JAX package; the flash path computes its softmax in
    f32 whatever it says."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    output_dtype: str = "float32"
    softmax_dtype: Optional[str] = None
    # fp8: the blanket cast stays bf16 (raw e4m3 casts without per-tensor
    # scales would destroy training); the dense products take the scaled
    # e4m3 path of ops/fp8.py
    fp8: bool = False

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "MixedPrecisionPolicy":
        mp = PrecisionType(mixed_precision or "no")
        if mp == PrecisionType.FP8:
            return cls(compute_dtype="bfloat16", fp8=True)
        return cls(compute_dtype={"no": "float32", "bf16": "bfloat16", "fp16": "float16"}[mp.value])

    @staticmethod
    def torch_dtype(name: str) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """How ``prepare`` wraps data: ``split_batches`` (the batch size is the
    global one), ``dispatch_batches`` (one reader hands out every batch),
    ``even_batches`` (the last batch wraps round to a full one),
    ``use_seedable_sampler``, ``prefetch_size`` (batches copied to the card
    ahead of the one yielded) and ``non_blocking`` (copies from pinned
    memory without waiting). ``auto_bucketing`` raises: the shape bucketer
    is ROADMAP.md Queue 1 item 9."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    prefetch_size: int = 2
    non_blocking: bool = True
    auto_bucketing: bool = False

    def __post_init__(self):
        if self.auto_bucketing:
            raise NotImplementedError(
                "DataLoaderConfiguration(auto_bucketing=True): aot/bucketing.py is not ported to "
                "accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 9)"
            )


@dataclass
class ProjectConfiguration(KwargsHandler):
    """Checkpoint/log directory layout, as the JAX package's: with
    ``automatic_checkpoint_naming`` saves go to
    ``{project_dir}/{checkpoints_dir_name}/checkpoint_{iteration}`` and
    ``total_limit`` keeps the newest ones. ``compile_cache_dir_name`` is
    kept for the compile cache (ROADMAP.md Queue 1 item 9); nothing of the
    port reads it yet."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False
    checkpoints_dir_name: str = "checkpoints"
    compile_cache_dir_name: str = "compile_cache"

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


@dataclass
class FaultToleranceKwargs(KwargsHandler):
    """Fault-tolerance knobs, as the JAX package's. Passing this handler to
    ``Accelerator(kwargs_handlers=[...])`` installs the SIGTERM/SIGINT
    preemption handler (``handle_preemption``). The atomic commit protocol
    is always on; the other knobs tune its IO retries, its GC and its
    resume check, and ``tracker_retries`` retries a failing tracker in
    ``Accelerator.log``. ``agree_preemption`` is kept for multi-process
    training (ROADMAP.md Queue 1 item 8): one process has no other rank to
    agree with."""

    #: install a PreemptionHandler so SIGTERM/SIGINT surface as
    #: ``Accelerator.should_checkpoint`` / ``should_stop``
    handle_preemption: bool = True
    preemption_signals: tuple = ("SIGTERM", "SIGINT")
    agree_preemption: bool = True
    #: jittered-exponential-backoff attempts for checkpoint filesystem IO
    io_retries: int = 3
    retry_base_delay: float = 0.1
    retry_max_delay: float = 5.0
    tracker_retries: int = 3
    #: sweep stale ``checkpoint_*.tmp`` leftovers at the start of each
    #: automatic-naming save (recovering any fully committed one)
    gc_tmp_on_save: bool = True
    #: deep-verify manifests (sizes + crc32) during auto-resume discovery;
    #: False trusts manifest presence alone (faster on huge checkpoints)
    verify_on_resume: bool = True

    def __post_init__(self):
        if self.io_retries < 1 or self.tracker_retries < 1:
            raise ValueError("io_retries / tracker_retries must be >= 1")
        if self.retry_base_delay < 0 or self.retry_max_delay < self.retry_base_delay:
            raise ValueError("need 0 <= retry_base_delay <= retry_max_delay")


@dataclass
class ServingSchedulerKwargs(KwargsHandler):
    """Continuous-batching scheduler knobs for
    :class:`~accelerate_tpu_torch.serving.ServingEngine`, the kwargs-handler
    mirror of :class:`~accelerate_tpu_torch.scheduling.SchedulerConfig`:
    pass it as ``ServingEngine(..., scheduler=ServingSchedulerKwargs(...))``.

    ``token_budget``: model-compute tokens a tick; active decodes claim
    ``n_decoding x tick_block`` first and prefill chunks take the rest
    (``None``: unlimited, prefills complete at admission).
    ``max_queue_depth`` / ``max_queue_wait_s``: SLO shed thresholds for
    priorities >= ``shed_priority_floor`` (``shed_action`` rejects with a
    :class:`~accelerate_tpu_torch.scheduling.ShedError` or demotes to
    ``deprioritize_to``). ``enable_preemption``: evict the youngest decode
    with priority >= ``preempt_priority_floor`` when a strictly more
    important request cannot admit; it requeues and resumes by recompute.
    ``speculative_priorities``: with a draft model, the classes that
    speculate. ``mode="fifo"`` pins strict FIFO (the benchmark baseline)."""

    mode: str = "continuous"
    token_budget: Optional[int] = None
    max_queue_depth: Optional[int] = None
    max_queue_wait_s: Optional[float] = None
    shed_priority_floor: int = 1
    shed_action: str = "reject"
    deprioritize_to: int = 99
    enable_preemption: bool = False
    preempt_priority_floor: int = 1
    speculative_priorities: Optional[tuple] = None

    def to_scheduler_config(self):
        """The :class:`~accelerate_tpu_torch.scheduling.SchedulerConfig` the
        engine consumes (validation happens there)."""
        from ..scheduling import SchedulerConfig

        return SchedulerConfig(**dataclasses.asdict(self))


class RNGType(str, enum.Enum):
    """The RNGs a loader synchronises at the start of each pass
    (``generator``: the ``torch.Generator`` it was given)."""

    TORCH = "torch"
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"

    def __str__(self) -> str:
        return self.value


@dataclass
class MeshConfig:
    """Logical mesh shape, as :class:`accelerate_tpu.parallel.mesh.MeshConfig`
    names it; ``-1`` fills with the devices left, which on one card is 1."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    num_devices: Optional[int] = None


@dataclass
class ParallelismPlugin(KwargsHandler):
    """The one-device layout. Any mesh axis above 1, ZeRO, optimizer-state
    sharding, offload and gradient compression raise: multi-card training
    is ROADMAP.md Queue 1 item 8."""

    mesh_config: MeshConfig = field(default_factory=MeshConfig)
    sharding_rules: Optional[object] = None
    shard_optimizer_state: bool = False
    zero_stage: int = 0
    offload_optimizer: bool = False
    remat_policy: Optional[str] = None
    donate_state: bool = True
    grad_compression: Optional[str] = None

    def __post_init__(self):
        wide = {
            f.name: getattr(self.mesh_config, f.name)
            for f in dataclasses.fields(self.mesh_config)
            if f.name != "num_devices" and getattr(self.mesh_config, f.name) not in (-1, 1)
        }
        if wide or (self.mesh_config.num_devices or 1) != 1:
            raise NotImplementedError(
                f"accelerate_tpu_torch trains on one card only (mesh {wide or self.mesh_config}); "
                "multi-card layouts are queued in ROADMAP.md Queue 1 item 8"
            )
        for knob in ("sharding_rules", "remat_policy", "grad_compression"):
            if getattr(self, knob) is not None:
                raise NotImplementedError(f"ParallelismPlugin.{knob} is not ported yet (ROADMAP.md Queue 1 item 8)")
        if self.zero_stage or self.shard_optimizer_state or self.offload_optimizer:
            raise NotImplementedError(
                "ZeRO, optimizer-state sharding and optimizer offload are not ported yet (ROADMAP.md Queue 1 item 8)"
            )
