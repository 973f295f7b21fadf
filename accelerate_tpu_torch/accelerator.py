"""``Accelerator``: prepare a model, optimizer and data, build the train
and eval steps, gather metrics.

Counterpart of :class:`accelerate_tpu.accelerator.Accelerator`, the
one-device replicated path. A training script of the JAX package maps
line for line::

    accelerator = Accelerator(mixed_precision="bf16")
    model, optimizer, loader = accelerator.prepare(
        create_bert_model(cfg), torch.optim.AdamW(params, 2e-5), dataset_or_loader
    )
    step = accelerator.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
    for batch in loader:
        loss = step(batch)
    eval_step = accelerator.build_eval_step(lambda p, ids, mask: model.apply_fn(p, ids, mask))
    preds = accelerator.gather_for_metrics(eval_step(ids, mask).argmax(-1))
    accelerator.save_state()   # with ProjectConfiguration(automatic_checkpoint_naming=True)
    accelerator.load_state()   # in a new process: the newest checkpoint that verifies

The imperative loop of Accelerate maps too, with the JAX signature of
``backward`` (it takes the loss *function*)::

    model, optimizer = accelerator.prepare(model, optimizer)
    for batch in batches:
        with accelerator.accumulate(model):
            loss = accelerator.backward(loss_fn, batch)
            accelerator.clip_grad_norm_(model, 1.0)
            optimizer.step()
            optimizer.zero_grad()

The model's parameters are the f32 master copy. Each microbatch casts
them to the compute dtype (names matching
``AutocastKwargs.keep_fp32_patterns`` stay f32), runs ``loss_fn`` on that
copy, and autograd carries f32 gradients back to the masters: the JAX
package's semantics. Both paths add each microbatch's gradient,
``1/(loss scale x accum)``-weighted, into an f32 buffer
(:meth:`Accelerator._backward_into`) and apply it on a sync boundary
through one applier (:meth:`Accelerator._apply_gradients`): clipped to
``clip_grad_norm_``'s bound, the optimizer steps (under fp16 only if the
global norm is finite) and the buffer is dropped. So the two paths give
bit-equal parameters. The last batch of the loader being iterated forces
a sync boundary. ``build_train_step(has_state=True)`` threads the model's
mutable state (:attr:`~.modeling.Model.state`, ResNet's BatchNorm
statistics) through ``loss_fn(params, state, batch)``, which returns
``(loss, new_state)``; the state updates every microbatch, without
gradients.

Data goes through :func:`~.data_loader.prepare_data_loader` (batches on
``accelerator.device``); ``gather_for_metrics`` drops the rows a padded
last batch repeated. With one process the collectives return their input.

``save_state`` / ``load_state`` (:mod:`.checkpointing`) save and restore
the prepared models (their mutable state with them), optimizers,
schedulers and loaders, the registered custom objects, the step, the fp16
loss scale and the RNGs through an atomic commit; ``FaultToleranceKwargs``
installs a SIGTERM/SIGINT handler read through ``should_checkpoint`` /
``should_stop``.

``mixed_precision="fp8"`` runs every dense layer's product in fp8
(:mod:`.ops.fp8`): the dynamic recipe, or the delayed one with
``Fp8RecipeKwargs(delayed_scaling=True)``, whose amax histories are
``Model.state`` (train with ``build_train_step(..., has_state=True)``).
``log_with`` / ``init_trackers`` / ``log`` drive the trackers
(:mod:`.tracking`); :attr:`Accelerator.telemetry` is the run's event log,
step timeline, recompile watchdog, MFU and non-finite watchdog
(:mod:`.telemetry`, ``TelemetryKwargs``).

``CompileKwargs`` (or ``ACCELERATE_COMPILE_CACHE_DIR``) opens the program
cache (:mod:`.aot`, :attr:`Accelerator.program_cache`): the train and eval
steps route their calls through it, so a restarted process installs the
kernel libraries its steps recorded instead of running ``nvcc``.

A script started by the launcher (:mod:`.commands.launch`) is configured
through the environment, as in the JAX package: with no argument,
``Accelerator()`` takes ``ACCELERATE_MIXED_PRECISION``,
``ACCELERATE_GRADIENT_ACCUMULATION_STEPS``, the CPU under
``ACCELERATE_USE_CPU`` and the layout of ``ACCELERATE_MESH_*``.

Not ported (each raises ``NotImplementedError``, naming its ROADMAP.md
Queue 1 item): multi-card layouts and multi-process data, ZeRO, gradient
compression and optimizer offload (item 8).
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import os
from typing import Callable, Optional

import torch

from .data_loader import BaseDataLoader, prepare_data_loader
from .data_loader import skip_first_batches as _skip_first_batches
from .ft.preemption import PreemptionHandler
from .modeling import Model
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    AutocastKwargs,
    CompileKwargs,
    DataLoaderConfiguration,
    FaultToleranceKwargs,
    Fp8RecipeKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    MixedPrecisionPolicy,
    ParallelismPlugin,
    ProfileKwargs,
    ProjectConfiguration,
    TelemetryKwargs,
)
from .utils.operations import (
    _leaves,
    gather,
    gather_object,
    is_array_like,
    pad_across_processes,
    recursively_apply,
    reduce,
)
from .utils.random import generator_for_step

logger = logging.getLogger(__name__)


class Accelerator:
    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        log_with=None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        parallelism_plugin: Optional[ParallelismPlugin] = None,
        kwargs_handlers: Optional[list] = None,
        step_scheduler_with_optimizer: bool = True,
    ):
        self.autocast_handler = AutocastKwargs()
        self.scaler_handler = GradScalerKwargs()
        self.ft_handler = FaultToleranceKwargs()
        self.profile_handler = ProfileKwargs()
        self.telemetry_handler = TelemetryKwargs()
        self.compile_handler = CompileKwargs()
        self.fp8_recipe_handler = None
        # the preemption handler installs, and tracker logging retries, only when the handler was passed;
        # the program cache opens only when CompileKwargs was passed (or its environment variable is set)
        self._ft_explicit = False
        self._compile_explicit = False
        policy_override = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, FaultToleranceKwargs):
                self.ft_handler = handler
                self._ft_explicit = True
            elif isinstance(handler, ProfileKwargs):
                self.profile_handler = handler
            elif isinstance(handler, TelemetryKwargs):
                self.telemetry_handler = handler
            elif isinstance(handler, CompileKwargs):
                self.compile_handler = handler
                self._compile_explicit = True
            elif isinstance(handler, Fp8RecipeKwargs):
                self.fp8_recipe_handler = handler
            elif isinstance(handler, MixedPrecisionPolicy):
                policy_override = handler
            else:
                # the JAX package's other handler: DistributedInitKwargs (item 8)
                raise NotImplementedError(
                    f"{type(handler).__name__} is not ported to accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 8)"
                )
        if gradient_accumulation_plugin is None:
            # the launcher's --gradient_accumulation_steps reaches a script as this variable
            env_steps = int(os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", gradient_accumulation_steps))
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=env_steps)
        elif gradient_accumulation_steps != 1:
            raise ValueError("Pass either gradient_accumulation_steps or a GradientAccumulationPlugin, not both")

        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)

        self.state = AcceleratorState(
            mixed_precision=mixed_precision, cpu=cpu, parallelism_plugin=parallelism_plugin, _from_accelerator=True
        )
        if policy_override is not None:
            derived = self.state.dtype_policy
            for name in ("param_dtype", "compute_dtype", "output_dtype", "fp8"):
                if getattr(policy_override, name) != getattr(derived, name):
                    raise ValueError(
                        f"MixedPrecisionPolicy({name}={getattr(policy_override, name)!r}) conflicts with "
                        f"mixed_precision={self.state.mixed_precision!r} (which implies "
                        f"{name}={getattr(derived, name)!r}); set the field to match, or change mixed_precision"
                    )
            self.state.dtype_policy = policy_override
        if self.state.dtype_policy.fp8:
            # the recipe rides on the global policy, where the model zoo's
            # dense factory reads it; a bare mixed_precision="fp8" keeps the
            # stateless dynamic recipe (the delayed one needs its histories
            # threaded as model.state)
            self.state.dtype_policy.fp8_recipe = self.fp8_recipe_handler or Fp8RecipeKwargs(delayed_scaling=False)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(split_batches=split_batches)
        if split_batches:
            self.dataloader_config.split_batches = True
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer

        self._models: list[Model] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[BaseDataLoader] = []
        self._custom_objects: list = []
        self._save_model_hooks: list = []
        self._load_model_hooks: list = []
        self.step = 0
        self._clip_max_norm: Optional[float] = None
        self._last_grad_norm = None
        # the imperative path's f32 gradient buffers by id(model): a list of
        # tensors, or None once applied or zeroed (a zero buffer plus a
        # gradient is that gradient); a model that never ran backward has none
        self._grad_buffers: dict = {}
        self._trigger_flag = False
        # fp16 dynamic loss scale, kept on the host: the step reads the
        # gradient's finiteness on every sync boundary anyway
        self._loss_scale = self.scaler_handler.init_scale if self.mixed_precision == "fp16" else 1.0
        self._scale_growth_tracker = 0

        self.trackers: list = []
        self._log_with = log_with
        self._telemetry = None  # made on first access of the `telemetry` property

        # compile management (aot/): the shared ProgramCache and the persistent kernel library directory open
        # when a CompileKwargs handler was passed or ACCELERATE_COMPILE_CACHE_DIR is set; a bare Accelerator()
        # never writes cache files
        self._program_cache = None
        if self._compile_explicit or os.environ.get("ACCELERATE_COMPILE_CACHE_DIR"):
            from .aot import ExecutableStore, ProgramCache, configure_persistent_cache, resolve_cache_dir

            ch = self.compile_handler
            cache_dir = resolve_cache_dir(
                ch.cache_dir, self.project_dir, self.project_configuration.compile_cache_dir_name
            )
            store = None
            if cache_dir is not None and ch.executable_store:
                store = ExecutableStore(os.path.join(cache_dir, "executables"))
            self._program_cache = ProgramCache(store=store)
            if cache_dir is not None and ch.persistent_xla_cache:
                configure_persistent_cache(cache_dir, ch.min_compile_time_secs)

        # fault tolerance: the checkpoint this run resumed from (protected
        # from pruning), the one-final-checkpoint latch, the signal handler
        self._resumed_from: Optional[str] = None
        self._preempt_checkpointed = False
        self._preemption: Optional[PreemptionHandler] = None
        if self._ft_explicit and self.ft_handler.handle_preemption:

            def on_preempt(signame: str):
                if self._telemetry is not None:
                    self._telemetry.log.event("preempt", severity="warning", signal=signame)

            self._preemption = PreemptionHandler(signals=self.ft_handler.preemption_signals, on_preempt=on_preempt)
            self._preemption.install()

    # ------------------------------------------------------------------ #
    # state passthroughs
    # ------------------------------------------------------------------ #

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def num_processes(self) -> int:
        return self.state.partial_state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.partial_state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.partial_state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.partial_state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.partial_state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.partial_state.is_last_process

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    @property
    def save_iteration(self) -> int:
        return self.project_configuration.iteration

    @property
    def num_data_shards(self) -> int:
        """Shards of the batch dimension: one card, one shard."""
        return 1

    def print(self, *args, **kwargs):
        self.state.partial_state.print(*args, **kwargs)

    def wait_for_everyone(self):
        self.state.partial_state.wait_for_everyone()

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.partial_state.split_between_processes(inputs, apply_padding=apply_padding)

    def on_main_process(self, function):
        return self.state.partial_state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.partial_state.on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.partial_state.on_process(function, process_index)

    def on_last_process(self, function):
        return self.state.partial_state.on_last_process(function)

    def main_process_first(self):
        return self.state.partial_state.main_process_first()

    def local_main_process_first(self):
        return self.state.partial_state.local_main_process_first()

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int):
        self.gradient_state.plugin_kwargs.update({"num_steps": value})

    # ------------------------------------------------------------------ #
    # prepare
    # ------------------------------------------------------------------ #

    def prepare(self, *args):
        """Prepare models, then optimizers and data (loaders, datasets,
        iterables: :meth:`prepare_data_loader`), then schedulers, whatever
        the argument order; returns them in the order given."""
        staged = {}
        for i, obj in enumerate(args):
            if isinstance(obj, BaseDataLoader):  # made by prepare_data_loader: register it for checkpointing
                staged[i] = self.prepare_data_loader(obj)
            elif getattr(obj, "_is_accelerate_prepared", False):
                staged[i] = obj
            elif isinstance(obj, Model):
                staged[i] = self.prepare_model(obj)
        for i, obj in enumerate(args):
            if i in staged:
                continue
            if isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                staged[i] = self.prepare_optimizer(obj)
            elif hasattr(obj, "__iter__") or (hasattr(obj, "__getitem__") and hasattr(obj, "__len__")):
                staged[i] = self.prepare_data_loader(obj)
        for i, obj in enumerate(args):
            if i not in staged:
                staged[i] = self.prepare_scheduler(obj)
        if self._telemetry is not None:
            # telemetry already live: mark the prepare on the timeline (never
            # create it here: prepare() must not start writing files)
            self._telemetry.log.event(
                "prepare",
                models=len(self._models),
                optimizers=len(self._optimizers),
                dataloaders=len(self._dataloaders),
                schedulers=len(self._schedulers),
                mesh={"data": 1},
                mixed_precision=self.mixed_precision,
            )
        result = [staged[i] for i in range(len(args))]
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: Model, device_placement: Optional[bool] = None, evaluation_mode: bool = False):
        """Cast the floating parameters in place to the f32 master dtype (the
        ``Parameter`` objects stay, so an optimizer already built over them
        stays bound), move them and the buffers (mutable state) to the
        device, and turn training on unless ``evaluation_mode``."""
        if not isinstance(model, Model):
            raise TypeError(f"prepare_model takes an accelerate_tpu_torch Model, got {type(model).__name__}")
        if getattr(model, "_is_accelerate_prepared", False):
            return model
        if getattr(getattr(model, "config", None), "quant_method", None) is not None:
            raise NotImplementedError(
                f"model is weight-only quantized ({model.config.quant_method}): its integer codes cannot be cast "
                "to f32 masters or trained; prepare the float model, or serve the quantized one as it is "
                "(preparing a quantized model for sharded inference is queued in ROADMAP.md Queue 1 item 8)"
            )
        placement = self.device_placement if device_placement is None else device_placement
        param_dtype = MixedPrecisionPolicy.torch_dtype(self.state.dtype_policy.param_dtype)
        with torch.no_grad():
            for p in model.module.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(device=self.device if placement else p.device, dtype=param_dtype)
            if placement:
                for b in model.module.buffers():
                    b.data = b.data.to(self.device)
        model.module.requires_grad_(not evaluation_mode)
        model.module.train(not evaluation_mode)
        model._is_accelerate_prepared = True
        model.accelerator = self
        if not evaluation_mode:
            self._models.append(model)
        return model

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if isinstance(optimizer, AcceleratedOptimizer):
            opt = optimizer
        else:
            opt = AcceleratedOptimizer(optimizer, accelerator=self)
        if not opt._is_accelerate_prepared:
            opt._is_accelerate_prepared = True
            opt.accelerator = self
            opt._model = self._models[-1] if self._models else None  # the model prepared before it, as in JAX
            self._optimizers.append(opt)
        return opt

    def prepare_data_loader(self, data_loader, device_placement: Optional[bool] = None, **kwargs):
        """A loader whose batches land on this accelerator's device (unless
        ``device_placement`` is off), configured by ``dataloader_config``.
        Extra ``kwargs`` (``batch_size``, ``shuffle``, ``seed``,
        ``collate_fn``, ``drop_last``) pass to
        :func:`~.data_loader.prepare_data_loader` for a raw dataset."""
        if isinstance(data_loader, BaseDataLoader):
            if data_loader not in self._dataloaders:
                self._dataloaders.append(data_loader)
            return data_loader
        prepared = prepare_data_loader(
            data_loader,
            device=self.device,
            put_on_device=self.device_placement if device_placement is None else device_placement,
            data_loader_config=self.dataloader_config,
            **kwargs,
        )
        self._dataloaders.append(prepared)
        return prepared

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """Skip the first ``num_batches`` of the loader's next pass."""
        return _skip_first_batches(dataloader, num_batches)

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        if isinstance(scheduler, AcceleratedScheduler):
            return scheduler
        prepared = AcceleratedScheduler(
            scheduler,
            optimizers=self._optimizers,
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.split_batches,
        )
        prepared._is_accelerate_prepared = True
        self._schedulers.append(prepared)
        return prepared

    # ------------------------------------------------------------------ #
    # the train step
    # ------------------------------------------------------------------ #

    def _compute_cast(self, params: dict) -> dict:
        """f32 masters -> compute dtype, differentiably; parameters whose
        lower-cased name contains one of ``keep_fp32_patterns`` stay f32."""
        compute = MixedPrecisionPolicy.torch_dtype(self.state.dtype_policy.compute_dtype)
        if compute == torch.float32 or not self.autocast_handler.enabled:
            return params
        keep = tuple(self.autocast_handler.keep_fp32_patterns)
        return {
            name: p if not p.is_floating_point() or any(pat in name.lower() for pat in keep) else p.to(compute)
            for name, p in params.items()
        }

    @contextlib.contextmanager
    def _precision_ctx(self):
        """``mixed_precision="no"`` means real f32: torch lets cuDNN
        convolve f32 in TF32 by default (``torch.backends.cudnn.allow_tf32``,
        about 1e-3 relative error), and a user may have allowed TF32
        matmuls too. The steps run their forward and backward inside this
        context, which turns TF32 off for both and restores the flags after
        (the JAX package's ``_matmul_precision_ctx``); the 16-bit policies
        keep the defaults."""
        if self.mixed_precision != "no":
            yield
            return
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        old = cudnn.allow_tf32, matmul.allow_tf32
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = old

    def cast_to_compute(self, params: dict) -> dict:
        """``params`` in the compute dtype, as the steps see them."""
        return self._compute_cast(params)

    @contextlib.contextmanager
    def autocast(self, autocast_handler: Optional[AutocastKwargs] = None):
        """The compute-dtype cast lives in the steps (:meth:`cast_to_compute`);
        this context swaps its ``AutocastKwargs`` for the body."""
        old = self.autocast_handler
        if autocast_handler is not None:
            self.autocast_handler = autocast_handler
        try:
            yield
        finally:
            self.autocast_handler = old

    def build_eval_step(self, eval_fn: Callable, model: Optional[Model] = None) -> Callable:
        """``eval_fn(params, *args)`` -- ``eval_fn(params, state, *args)`` for
        a model with mutable state -- on the compute-dtype copy of the
        model's current parameters (and its current state), without
        autograd."""
        model = model or self._models[-1]

        def run(*args, **kwargs):
            with torch.no_grad(), self._precision_ctx():
                params, state = self._compute_cast(model.params), model.state
                if state is None:
                    return eval_fn(params, *args, **kwargs)
                return eval_fn(params, state, *args, **kwargs)

        if self._program_cache is not None and self.compile_handler.aot_train_step:
            return self._program_cache.wrap_jit(run, name="eval_step", key_salt=self._step_salt(model, eval_fn))
        return run

    def build_train_step(
        self,
        loss_fn: Callable,
        model: Optional[Model] = None,
        optimizer: Optional[AcceleratedOptimizer] = None,
        scheduler: Optional[AcceleratedScheduler] = None,
        has_aux: bool = False,
        has_state: bool = False,
        donate: bool = True,
    ) -> Callable:
        """``step(batch)`` -> loss (``(loss, aux)`` with ``has_aux``):
        ``loss_fn(params, batch)``, or ``loss_fn(params, batch, rng)`` with a
        per-step ``torch.Generator`` when it takes a third positional
        argument or one named ``rng``. With ``has_state`` the model's mutable
        state comes second, ``loss_fn(params, state, batch[, rng])``, and the
        loss function returns ``(loss, new_state)`` (``(loss, (new_state,
        aux))`` with ``has_aux``), which becomes ``model.state`` after the
        microbatch's backward. Updates the prepared model and optimizer in
        place. ``donate`` is accepted for the JAX signature (eager PyTorch
        frees what it no longer needs)."""
        model = model or self._models[-1]
        optimizer = optimizer or (self._optimizers[-1] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before building a train step")
        if has_state and model.state is None:
            raise ValueError(f"has_state=True, but {model.name} keeps no mutable state (Model.state is None)")
        scheduler = scheduler or (self._schedulers[-1] if self._schedulers else None)
        accum = self.gradient_accumulation_steps
        rng_mode = _rng_mode(loss_fn, lead=3 if has_state else 2)
        named = self._trainable(model)
        masters = [p for _, p in named]
        box = {"bufs": None, "micro": 0}

        def step(batch):
            gs = self.gradient_state
            do_sync = (box["micro"] + 1) % accum == 0
            if gs.sync_with_dataloader and gs.in_dataloader and gs.end_of_dataloader:
                do_sync = True
            gs._set_sync_gradients(do_sync)
            state = model.state if has_state else None

            def loss_of(params):
                lead = (params, state, batch) if has_state else (params, batch)
                if rng_mode == "positional":
                    out = loss_fn(*lead, generator_for_step(self.step, self.device))
                elif rng_mode == "keyword":
                    out = loss_fn(*lead, rng=generator_for_step(self.step, self.device))
                else:
                    out = loss_fn(*lead)
                if has_state:
                    loss, rest = out
                    return (loss, rest) if has_aux else (loss, (rest, None))
                return out if has_aux else (out, None)

            loss, aux, box["bufs"] = self._backward_into(named, box["bufs"], loss_of)
            if has_state:
                new_state, aux = aux
                model.state = new_state
            if do_sync:
                bufs, box["bufs"] = box["bufs"], None
                self._apply_gradients(optimizer, masters, bufs)
                if scheduler is not None:
                    scheduler.step()
            else:
                self._last_grad_norm = torch.zeros((), device=self.device)
            box["micro"] = 0 if do_sync else box["micro"] + 1
            self.step += 1
            if self._telemetry is not None and self._telemetry.nonfinite.enabled:
                # the opt-in finiteness probe: off-cadence steps read nothing back
                self._telemetry.nonfinite.observe(
                    self.step,
                    loss=loss,
                    grad_norm=self._last_grad_norm,
                    loss_scale=self._loss_scale if self.mixed_precision == "fp16" else None,
                    # an fp16 gradient overflow is the scaler's to handle (skip and back off)
                    scaler_handled=self.mixed_precision == "fp16",
                )
            return (loss, aux) if has_aux else loss

        if self._program_cache is not None and self.compile_handler.aot_train_step:
            # the warm start: a first-seen batch signature resolves through the shared ProgramCache, so a
            # restarted process re-creating this step installs its kernel libraries from the store instead of
            # running nvcc (the wrapper keeps `_cache_size` for the recompile watchdog)
            return self._program_cache.wrap_jit(
                step, name="train_step", key_salt=self._step_salt(model, loss_fn, has_aux, has_state, accum)
            )
        return step

    def _step_salt(self, model: Model, *extra) -> tuple:
        """What a step program closes over, for its cache key: the model's
        layout, the loss function and options, and the precision."""
        from .aot.program_cache import layout_salt

        return (layout_salt(model, *extra), self.mixed_precision)

    # ------------------------------------------------------------------ #
    # the two paths' shared arithmetic
    # ------------------------------------------------------------------ #

    @staticmethod
    def _trainable(model: Model) -> list:
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        if not named:
            raise ValueError("the model has no trainable parameters: prepare_model it first")
        return named

    def _backward_into(self, named: list, bufs: Optional[list], loss_of: Callable):
        """One microbatch, the same arithmetic on both paths: ``loss_of`` on
        the compute-dtype copy of ``named``'s masters gives ``(loss,
        extra)``; the backward of loss x the loss scale leaves f32 gradients
        on the masters, each divided by (scale x accum) and added into
        ``bufs`` (None: a zero buffer, which these gradients then are).
        Returns ``(detached loss, extra, bufs)``."""
        masters = [p for _, p in named]
        for p in masters:
            p.grad = None
        loss_scale = self._loss_scale
        with self._precision_ctx():
            loss, extra = loss_of(self._compute_cast(dict(named)))
            (loss.float() * loss_scale).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in masters]
        torch._foreach_div_(grads, max(loss_scale, 1.0) * self.gradient_accumulation_steps)
        if bufs is None:
            bufs = grads
        else:
            torch._foreach_add_(bufs, grads)
        for p in masters:
            p.grad = None
        return loss.detach(), extra, bufs

    def _apply_gradients(self, optimizer: AcceleratedOptimizer, masters: list, bufs: list) -> bool:
        """The sync boundary of both paths: the global norm of ``bufs``,
        scaled by ``min(1, bound / (norm + 1e-6))`` when ``clip_grad_norm_``
        set a bound (negative: off, 0 zeroes the gradient), then the masters'
        ``.grad`` set to it and the optimizer stepped -- under fp16 only when
        the norm is finite, and the loss scale updated. Returns whether the
        update was applied."""
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(bufs)))
        clip = self._clip_max_norm  # read at call time: clip_grad_norm_ in the loop applies next step
        if clip is not None and clip >= 0:
            torch._foreach_mul_(bufs, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
        use_fp16 = self.mixed_precision == "fp16"
        finite = bool(torch.isfinite(gnorm)) if use_fp16 else True
        if finite:
            for p, g in zip(masters, bufs):
                p.grad = g
            optimizer.optimizer.step()
        if use_fp16:
            self._update_loss_scale(finite)
        optimizer._step_was_skipped = not finite
        self._last_grad_norm = gnorm
        return finite

    def _update_loss_scale(self, finite: bool) -> None:
        """torch GradScaler's transition on a sync boundary: back off (never
        below 1) on an overflow, grow after ``growth_interval`` clean ones."""
        h = self.scaler_handler
        if not finite:
            self._loss_scale = max(1.0, self._loss_scale * h.backoff_factor)
            self._scale_growth_tracker = 0
            return
        self._scale_growth_tracker += 1
        if self._scale_growth_tracker >= h.growth_interval:
            self._loss_scale *= h.growth_factor
            self._scale_growth_tracker = 0

    # ------------------------------------------------------------------ #
    # the imperative path
    # ------------------------------------------------------------------ #

    def _do_sync(self) -> None:
        """The end of the loader being iterated syncs and restarts the count;
        otherwise every ``gradient_accumulation_steps``-th call does (every
        call with ``sync_each_batch``)."""
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            sync = self.step % self.gradient_accumulation_steps == 0
            gs._set_sync_gradients(sync or bool(gs.plugin_kwargs.get("sync_each_batch", False)))

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Gradient-accumulation bookkeeping for one microbatch: inside,
        ``backward`` adds into the buffer and ``optimizer.step()`` applies it
        on a sync boundary only. Once :attr:`telemetry` is live, each block
        is recorded as one step, fenced on the model's parameters."""
        self._do_sync()
        if self._telemetry is None:
            yield
            return
        with self._telemetry.steps.step() as handle:
            yield
            target = (models[0] if models else None) or (self._models[-1] if self._models else None)
            handle.done(None if target is None else target.params)

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Accumulate only, for the body: ``optimizer.step()`` applies
        nothing."""
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """Uneven batches never reach the step (the loader pads and masks
        them); this context overrides the prepared loaders' ``even_batches``
        for the body."""
        loaders = [dl for dl in self._dataloaders if hasattr(dl, "even_batches")]
        old = [dl.even_batches for dl in loaders]
        if even_batches is not None:
            for dl in loaders:
                dl.even_batches = even_batches
        try:
            yield
        finally:
            for dl, val in zip(loaders, old):
                dl.even_batches = val

    def backward(self, loss_fn: Callable, batch=None, model: Optional[Model] = None, **kwargs):
        """``loss_fn(params, batch)``'s gradient, scaled by
        ``1/gradient_accumulation_steps``, added into the model's f32
        buffer; returns the (unscaled) loss. The JAX signature: it takes the
        loss *function*, run on the compute-dtype copy of the masters."""
        model = model or self._models[-1]
        named = self._trainable(model)
        loss, _, self._grad_buffers[id(model)] = self._backward_into(
            named, self._grad_buffers.get(id(model)), lambda params: (loss_fn(params, batch), None)
        )
        return loss

    def _buffer_for(self, model: Optional[Model] = None):
        """``(key, buffer)`` for ``model`` (default: the single buffer, or
        the last prepared model's); the buffer is None once applied or
        zeroed, and the key None where no backward ran."""
        if model is not None:
            key = id(model)
        elif len(self._grad_buffers) == 1:
            key = next(iter(self._grad_buffers))
        elif self._models:
            key = id(self._models[-1])
        else:
            return None, None
        return (key, self._grad_buffers[key]) if key in self._grad_buffers else (None, None)

    def _zero_grad_buffer(self, model: Optional[Model]) -> None:
        model = model or (self._models[-1] if self._models else None)
        if id(model) in self._grad_buffers:
            self._grad_buffers[id(model)] = None

    def _apply_accumulated_gradients(self, opt: AcceleratedOptimizer) -> bool:
        """Apply the model's buffer through the shared applier and zero it.
        Returns False when fp16 skipped the update."""
        model = opt._model or self._models[-1]
        if id(model) not in self._grad_buffers:
            return True
        named = self._trainable(model)
        masters = [p for _, p in named]
        bufs = self._grad_buffers[id(model)]
        if bufs is None:  # applied or zeroed since its last backward: the update of a zero gradient
            bufs = [torch.zeros_like(p) for p in masters]
        self._grad_buffers[id(model)] = None
        return self._apply_gradients(opt, masters, bufs)

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Set the global-norm bound every sync boundary applies from now on
        (a negative bound turns clipping off, 0 zeroes the gradient). On the
        imperative path the buffer is also clipped in place now, and its
        pre-clip norm returned; otherwise the last boundary's pre-clip
        norm."""
        if norm_type != 2.0:
            raise NotImplementedError("only the L2 global norm is supported")
        self._clip_max_norm = max_norm
        key, bufs = self._buffer_for(parameters if isinstance(parameters, Model) else None)
        if key is None:
            return self._last_grad_norm
        if bufs is None:  # a zero buffer
            self._last_grad_norm = torch.zeros((), device=self.device)
            return self._last_grad_norm
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(bufs)))
        if max_norm >= 0:
            torch._foreach_mul_(bufs, torch.clamp(max_norm / (gnorm + 1e-6), max=1.0))
        self._last_grad_norm = gnorm
        return gnorm

    def clip_grad_value_(self, parameters, clip_value: float) -> None:
        """Clamp the imperative path's buffer to ``[-clip_value, clip_value]``."""
        _, bufs = self._buffer_for(parameters if isinstance(parameters, Model) else None)
        if bufs is not None:
            for b in bufs:
                b.clamp_(-clip_value, clip_value)

    # ------------------------------------------------------------------ #
    # triggers, memory, profiling
    # ------------------------------------------------------------------ #

    def set_trigger(self) -> None:
        """Raise a flag that :meth:`check_trigger` reads (and clears) on every
        process: one process's early stop stops all."""
        self._trigger_flag = True

    def check_trigger(self) -> bool:
        fired = any(gather_object([self._trigger_flag]))
        if fired:
            self._trigger_flag = False
        return fired

    def free_memory(self, *objects):
        """Forget the prepared objects, the imperative buffers and the step
        count, then :func:`~.utils.memory.release_memory` ``objects``."""
        from .utils.memory import release_memory

        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._grad_buffers.clear()
        self.step = 0
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    def end_training(self) -> None:
        """The end of the run: every tracker finishes (on the main process),
        then a barrier."""
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.finish()
        self.wait_for_everyone()

    # ------------------------------------------------------------------ #
    # runtime telemetry and trackers
    # ------------------------------------------------------------------ #

    @property
    def telemetry(self):
        """The run's :class:`~.telemetry.Telemetry` (made on first access
        from the ``TelemetryKwargs`` handler): the event log under
        ``logging_dir``, memory sampling, the recompile watchdog, the
        non-finite probe and forwarding to the trackers::

            step = accelerator.telemetry.wrap(accelerator.build_train_step(loss_fn))

        Once it is live, ``accumulate()`` blocks are timed as steps and the
        checkpoint events land in its log. ``TelemetryKwargs(enabled=False)``
        keeps it off the disk (the in-memory records still accumulate)."""
        if self._telemetry is None:
            from .telemetry import Telemetry, default_path

            h = self.telemetry_handler
            self._telemetry = Telemetry(
                (h.output_path or default_path(self.logging_dir)) if h.enabled else None,
                rank=self.process_index,
                main_process_only=h.main_process_only,
                warmup_steps=h.warmup_steps,
                fence=h.fence,
                watchdog=h.recompile_watchdog,
                n_devices=self.num_processes,
                hbm_sample_every=h.hbm_sample_every,
                forward_fn=lambda values, step: self.log(values, step=step),
                forward_every=h.forward_to_trackers_every,
                nonfinite_every=h.nonfinite_every,
            )
            if self._program_cache is not None:
                # compile_cache_* events land in the same run log as the step timeline
                self._program_cache.log = self._telemetry.log
        return self._telemetry

    @property
    def program_cache(self):
        """The shared :class:`~.aot.ProgramCache` (``None`` unless a
        :class:`~.utils.dataclasses.CompileKwargs` handler was passed or
        ``ACCELERATE_COMPILE_CACHE_DIR`` is set). When active,
        ``build_train_step`` and ``build_eval_step`` route their calls
        through it, so a restarted process installs the kernel libraries
        its steps recorded instead of running ``nvcc``."""
        return self._program_cache

    def init_trackers(self, project_name: str, config: Optional[dict] = None, init_kwargs: Optional[dict] = None):
        """Start the trackers ``log_with`` named (:func:`~.tracking.filter_trackers`)."""
        from .tracking import filter_trackers

        self.trackers = filter_trackers(self._log_with, self.logging_dir, project_name, config, init_kwargs or {})

    def get_tracker(self, name: str, unwrap: bool = False):
        """The active tracker ``name`` (its backend object with ``unwrap``).
        With no active tracker at all, a no-op blank tracker; a name
        missing among active ones raises ``ValueError``."""
        if self.trackers:
            for tracker in self.trackers:
                if tracker.name == name:
                    return tracker.tracker if unwrap else tracker
            raise ValueError(f"{name} is not an active tracker: {[t.name for t in self.trackers]}")
        from .tracking import GeneralTracker

        return GeneralTracker(_blank=True)

    def log(self, values: dict, step: Optional[int] = None, log_kwargs: Optional[dict] = None):
        """``values`` to every active tracker, on the main process. With a
        ``FaultToleranceKwargs`` handler a failing tracker is retried with
        backoff and, past its retries, logged and skipped (a
        ``tracker_retry`` / ``tracker_giveup`` event each when telemetry is
        live): losing metrics must not end a run."""
        if not self.is_main_process:
            return
        log_kwargs = log_kwargs or {}
        retries = self.ft_handler.tracker_retries if self._ft_explicit else 1
        for tracker in self.trackers:
            kw = log_kwargs.get(tracker.name, {})
            if retries <= 1:
                tracker.log(values, step=step, **kw)
                continue
            from .utils.retry import retry_call

            def on_retry(attempt, delay, exc, name=tracker.name):
                if self._telemetry is not None:
                    self._telemetry.log.event("tracker_retry", severity="warning", tracker=name, attempt=attempt,
                                              delay_s=round(delay, 3), error=str(exc))

            try:
                retry_call(tracker.log, values, step=step, attempts=retries,
                           base_delay=self.ft_handler.retry_base_delay, max_delay=self.ft_handler.retry_max_delay,
                           exceptions=(Exception,), on_retry=on_retry, **kw)
            except Exception as e:
                logger.warning(f"tracker {tracker.name}.log failed after {retries} attempts: {e}")
                if self._telemetry is not None:
                    self._telemetry.log.event("tracker_giveup", severity="error", tracker=tracker.name, error=str(e))

    def _media_trackers(self, method: str) -> list:
        """The active trackers that implement ``method`` (the base raises)."""
        from .tracking import GeneralTracker

        return [t for t in self.trackers if getattr(type(t), method) is not getattr(GeneralTracker, method)]

    def log_images(self, values: dict, step: Optional[int] = None, log_kwargs: Optional[dict] = None):
        """``{name: [images]}`` to every active tracker that logs images."""
        if self.is_main_process:
            for tracker in self._media_trackers("log_images"):
                tracker.log_images(values, step=step, **(log_kwargs or {}).get(tracker.name, {}))

    def log_table(self, table_name: str, columns: Optional[list] = None, data: Optional[list] = None,
                  dataframe=None, step: Optional[int] = None, log_kwargs: Optional[dict] = None):
        """A table to every active tracker that logs tables."""
        if self.is_main_process:
            for tracker in self._media_trackers("log_table"):
                tracker.log_table(table_name, columns=columns, data=data, dataframe=dataframe, step=step,
                                  **(log_kwargs or {}).get(tracker.name, {}))

    @contextlib.contextmanager
    def profile(self, profile_handler=None):
        """Trace the body with ``torch.profiler`` (yielded) and write a Chrome
        trace under ``output_trace_dir`` (a string is that directory), else
        ``{logging_dir}/profile``; then ``on_trace_ready(trace_dir)``."""
        if isinstance(profile_handler, str):
            profile_handler = ProfileKwargs(output_trace_dir=profile_handler)
        handler = profile_handler or self.profile_handler
        trace_dir = handler.output_trace_dir or os.path.join(self.logging_dir or ".", "profile")
        os.makedirs(trace_dir, exist_ok=True)
        with torch.profiler.profile(**handler.profiler_kwargs(cuda=self.device.type == "cuda")) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(trace_dir, f"rank{self.process_index}.pt.trace.json"))
        if handler.on_trace_ready is not None:
            handler.on_trace_ready(trace_dir)

    def kernel_check(
        self,
        step_fn: Callable,
        *sample_args,
        generation: Optional[str] = None,
        probe: bool = True,
        ignore=(),
    ):
        """Static analysis of the CUDA kernels ``step_fn`` launches, before
        any is built: ``step_fn`` is traced on ``meta`` copies of the
        sample arguments (only their shapes and dtypes are read), every
        launch site its kernel wrappers record (grid, tiles, index maps,
        shared memory, aliases) is checked with the TPU10xx rules
        (:mod:`.analysis.kernel_rules`: shared memory against the card's
        per-block maximum, tile alignment, index-map coverage and races,
        alias hazards, registered cost contracts), and with ``probe`` the
        function runs once on concrete operands on this accelerator's
        device (the kernels on the card, their plain versions on the CPU).

        Returns a :class:`~.analysis.KernelReport` (``.render_text()`` /
        ``.as_dict()``); error-severity findings are logged.
        """
        from .analysis import render_text
        from .analysis.kernelmodel import kernel_check as _kernel_check

        report = _kernel_check(
            step_fn, *sample_args, generation=generation, probe=probe, ignore=ignore, device=self.device
        )
        if not report.ok:
            logger.warning(
                "kernel-check found issues in %s:\n%s",
                getattr(step_fn, "__name__", "step_fn"),
                render_text(report.findings),
            )
        return report

    # ------------------------------------------------------------------ #
    # checkpointing and preemption
    # ------------------------------------------------------------------ #

    def register_for_checkpointing(self, *objects):
        """Save and restore ``objects`` (each with ``state_dict`` and
        ``load_state_dict``) with every checkpoint."""
        invalid = [o for o in objects if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(f"Objects must expose state_dict/load_state_dict: {invalid}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook):
        """``hook(models, weights, output_dir)`` runs before each save writes."""
        self._save_model_hooks.append(hook)
        return _RemovableHandle(self._save_model_hooks, hook)

    def register_load_state_pre_hook(self, hook):
        """``hook(models, input_dir)`` runs before each load restores."""
        self._load_model_hooks.append(hook)
        return _RemovableHandle(self._load_model_hooks, hook)

    def save_state(self, output_dir: Optional[str] = None, **save_model_func_kwargs):
        """Atomic checkpoint save (tmp-dir write -> manifest -> rename; see
        :mod:`.checkpointing`). ``async_save=True`` returns once the tensors
        are copied to the host; the file writes continue in the background
        and commit when drained (:meth:`wait_for_checkpoint`, the next save
        or load). Under preemption the async request is demoted to a
        synchronous save: the grace window is for committing, not for
        queueing."""
        from .checkpointing import save_accelerator_state

        if self.preempted:
            save_model_func_kwargs.pop("async_save", None)
        out = save_accelerator_state(self, output_dir, **save_model_func_kwargs)
        if self.preempted:
            self._preempt_checkpointed = True
        return out

    def wait_for_checkpoint(self):
        """Block until pending ``save_state(async_save=True)`` writes commit;
        raises the first failure of one."""
        from .checkpointing import wait_for_checkpoint

        wait_for_checkpoint()

    def load_state(self, input_dir: Optional[str] = None, **load_model_func_kwargs):
        """Restore a checkpoint into the prepared objects, in place. With
        ``input_dir=None``, **auto-resume**: the newest checkpoint under
        ``{project_dir}/checkpoints`` whose integrity manifest verifies
        (walking back past corrupt or uncommitted ones), and the
        ``checkpoint_N`` numbering continues from there."""
        from .checkpointing import load_accelerator_state

        out = load_accelerator_state(self, input_dir, **load_model_func_kwargs)
        if self._program_cache is not None:
            # the warm start after a restore: how warm the store is, so a resume that did build kernels is
            # explainable from the telemetry
            stats = self._program_cache.stats()
            if self._telemetry is not None:
                self._telemetry.log.event("compile_cache_warmstart", **stats)
            logger.info(
                "compile cache at resume: %s stored entries, %s deserialized this process",
                stats.get("store_entries", 0), stats.get("deserialized", 0),
            )
        return out

    @property
    def checkpoint_manager(self):
        """A :class:`~.ft.CheckpointManager` over this project's
        automatic-naming checkpoint directory (``None`` without a
        ``project_dir``)."""
        if self.project_dir is None:
            return None
        from .ft.manager import CheckpointManager

        return CheckpointManager(os.path.join(self.project_dir, self.project_configuration.checkpoints_dir_name))

    @property
    def preemption_handler(self) -> Optional[PreemptionHandler]:
        """The installed :class:`~.ft.PreemptionHandler`, or ``None`` (pass
        ``FaultToleranceKwargs()`` to install one)."""
        return self._preemption

    @property
    def preempted(self) -> bool:
        """True once SIGTERM/SIGINT was received (always False without a
        preemption handler)."""
        return self._preemption is not None and self._preemption.preempted

    @property
    def should_checkpoint(self) -> bool:
        """True when a preemption signal arrived and the final synchronous
        checkpoint has not been taken yet; check after each step::

            if accelerator.should_checkpoint:
                accelerator.save_state()   # drains async saves, saves sync
            if accelerator.should_stop:
                break

        One process: the local flag is the job's (the JAX package agrees
        it across processes; multi-process training is ROADMAP.md Queue 1
        item 8)."""
        return self.preempted and not self._preempt_checkpointed

    @property
    def should_stop(self) -> bool:
        """True once preemption was signalled: exit the training loop at the
        next step boundary (after the :attr:`should_checkpoint` save)."""
        return self.preempted

    def save_model(self, model, save_directory: str, max_shard_size="10GB", safe_serialization: bool = True):
        """Export ``model``'s weights as safetensors (:func:`.checkpointing.save_model`)."""
        from .checkpointing import save_model as _save_model

        return _save_model(model, save_directory, max_shard_size=max_shard_size, safe_serialization=safe_serialization)

    # ------------------------------------------------------------------ #
    # metrics and collectives
    # ------------------------------------------------------------------ #

    def gather(self, tensor):
        return gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """Gather, then drop the rows that the padded last batch of the
        loader being iterated repeated (its ``remainder``)."""
        if use_gather_object or not any(is_array_like(x) for x in _leaves(input_data)):
            data = gather_object(input_data if isinstance(input_data, list) else [input_data])
        else:
            data = gather(input_data)
        if self.gradient_state.end_of_dataloader and self.gradient_state.remainder > 0:
            rem = self.gradient_state.remainder
            return recursively_apply(lambda x: x[:rem] if x.ndim >= 1 else x, data)
        return data

    def reduce(self, tensor, reduction: str = "mean", scale: float = 1.0):
        return reduce(tensor, reduction, scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
        return pad_across_processes(tensor, dim, pad_index, pad_first)

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """Models are never wrapped; returns ``model``."""
        return model

    def __repr__(self) -> str:
        return f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r})"


class _RemovableHandle:
    """What the register-hook methods return: ``remove()`` unregisters."""

    def __init__(self, hooks_list: list, hook):
        self.hooks_list = hooks_list
        self.hook = hook

    def remove(self):
        if self.hook in self.hooks_list:
            self.hooks_list.remove(self.hook)


def _rng_mode(loss_fn: Callable, lead: int = 2) -> str:
    """``"positional"`` when ``loss_fn`` takes a required positional argument
    after its ``lead`` ones (params and batch; params, state and batch),
    ``"keyword"`` when it has a parameter named ``rng``, else ``"none"``
    (arguments bound by ``functools.partial`` do not count)."""
    try:
        params = inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return "none"
    required = sum(
        1
        for p in params.values()
        if p.default is inspect.Parameter.empty
        and p.kind in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    )
    if required > lead:
        return "positional"
    return "keyword" if "rng" in params else "none"
