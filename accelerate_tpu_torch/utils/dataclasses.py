"""Config dataclasses and kwargs handlers of the training path.

A subset of :mod:`accelerate_tpu.utils.dataclasses`: the precision policy,
the autocast and grad-scaler handlers, gradient accumulation, the data
loader configuration, the RNG types, and a ``ParallelismPlugin`` that
takes the one-device layout only. The other
layouts (data, fsdp, tensor, seq, pipe, expert axes), ZeRO, gradient
compression and optimizer offload raise ``NotImplementedError``: they are
queued in ROADMAP.md.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional

import torch


class PrecisionType(str, enum.Enum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"

    def __str__(self) -> str:
        return self.value


class KwargsHandler:
    """Base for kwargs containers passed to ``Accelerator(kwargs_handlers=[...])``."""

    def to_dict(self) -> dict:
        return copy.deepcopy(dataclasses.asdict(self))


@dataclass
class AutocastKwargs(KwargsHandler):
    """Compute-dtype policy tweaks: parameters whose name contains one of
    ``keep_fp32_patterns`` (lower-cased) keep their f32 master as the
    compute copy under mixed precision."""

    enabled: bool = True
    keep_fp32_patterns: tuple = ("layernorm", "layer_norm", "ln_", "norm", "embedding_norm")


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss-scaling knobs for fp16 (torch GradScaler semantics)."""

    init_scale: float = 2.0**15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


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
    fp8: bool = False

    def __post_init__(self):
        if self.fp8:
            raise NotImplementedError("fp8 mixed precision is not ported to accelerate_tpu_torch yet (ROADMAP.md)")

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "MixedPrecisionPolicy":
        mp = PrecisionType(mixed_precision or "no")
        if mp == PrecisionType.FP8:
            raise NotImplementedError("fp8 mixed precision is not ported to accelerate_tpu_torch yet (ROADMAP.md)")
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
    is ROADMAP.md Queue 1 E."""

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
                "multi-card layouts are queued in ROADMAP.md Queue 1 E"
            )
        for knob in ("sharding_rules", "remat_policy", "grad_compression"):
            if getattr(self, knob) is not None:
                raise NotImplementedError(f"ParallelismPlugin.{knob} is not ported yet (ROADMAP.md Queue 1 E)")
        if self.zero_stage or self.shard_optimizer_state or self.offload_optimizer:
            raise NotImplementedError(
                "ZeRO, optimizer-state sharding and optimizer offload are not ported yet (ROADMAP.md Queue 1 E)"
            )
