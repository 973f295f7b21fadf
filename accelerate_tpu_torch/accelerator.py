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

The model's parameters are the f32 master copy. Each step casts them to
the compute dtype (names matching ``AutocastKwargs.keep_fp32_patterns``
stay f32), runs ``loss_fn`` on that copy, and autograd carries f32
gradients back to the masters: the JAX package's semantics. Gradients
accumulate ``1/accum``-weighted in f32; on a sync boundary they are
clipped to ``clip_grad_norm_``'s bound, the optimizer steps (under fp16
only if the global norm is finite) and the buffer is dropped. The last
batch of the loader being iterated forces a sync boundary.

Data goes through :func:`~.data_loader.prepare_data_loader` (batches on
``accelerator.device``); ``gather_for_metrics`` drops the rows a padded
last batch repeated. With one process the collectives return their input.

``save_state`` / ``load_state`` (:mod:`.checkpointing`) save and restore
the prepared models, optimizers, schedulers and loaders, the registered
custom objects, the step, the fp16 loss scale and the RNGs through an
atomic commit; ``FaultToleranceKwargs`` installs a SIGTERM/SIGINT handler
read through ``should_checkpoint`` / ``should_stop``.

Not ported (each raises ``NotImplementedError``): mutable model state
(``has_state``), multi-card layouts and multi-process data, ZeRO,
gradient compression, optimizer offload, the program cache, trackers
(``log_with``), the shape bucketer and the imperative path
(``accumulate``/``backward``); ROADMAP.md queues them.
"""

from __future__ import annotations

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
    DataLoaderConfiguration,
    FaultToleranceKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    MixedPrecisionPolicy,
    ParallelismPlugin,
    ProjectConfiguration,
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
        if log_with is not None:
            raise NotImplementedError(
                f"log_with={log_with!r}: trackers (tracking.py, init_trackers, log) are not ported to "
                "accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 9)"
            )
        self.autocast_handler = AutocastKwargs()
        self.scaler_handler = GradScalerKwargs()
        self.ft_handler = FaultToleranceKwargs()
        ft_explicit = False  # the preemption handler installs only when the handler was passed
        policy_override = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, FaultToleranceKwargs):
                self.ft_handler = handler
                ft_explicit = True
            elif isinstance(handler, MixedPrecisionPolicy):
                policy_override = handler
            else:
                raise NotImplementedError(
                    f"{type(handler).__name__} is not ported to accelerate_tpu_torch yet (ROADMAP.md)"
                )
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gradient_accumulation_steps)
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
            for name in ("param_dtype", "compute_dtype", "output_dtype"):
                if getattr(policy_override, name) != getattr(derived, name):
                    raise ValueError(
                        f"MixedPrecisionPolicy({name}={getattr(policy_override, name)!r}) conflicts with "
                        f"mixed_precision={self.state.mixed_precision!r} (which implies "
                        f"{name}={getattr(derived, name)!r}); set the field to match, or change mixed_precision"
                    )
            self.state.dtype_policy = policy_override
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
        # fp16 dynamic loss scale, kept on the host: the step reads the
        # gradient's finiteness on every sync boundary anyway
        self._loss_scale = self.scaler_handler.init_scale if self.mixed_precision == "fp16" else 1.0
        self._scale_growth_tracker = 0

        # fault tolerance: the checkpoint this run resumed from (protected
        # from pruning), the one-final-checkpoint latch, the signal handler
        self._resumed_from: Optional[str] = None
        self._preempt_checkpointed = False
        self._preemption: Optional[PreemptionHandler] = None
        if ft_explicit and self.ft_handler.handle_preemption:
            self._preemption = PreemptionHandler(signals=self.ft_handler.preemption_signals)
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
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def num_data_shards(self) -> int:
        """Shards of the batch dimension: one card, one shard."""
        return 1

    def print(self, *args, **kwargs):
        self.state.partial_state.print(*args, **kwargs)

    def wait_for_everyone(self):
        self.state.partial_state.wait_for_everyone()

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
        result = [staged[i] for i in range(len(args))]
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: Model, device_placement: Optional[bool] = None, evaluation_mode: bool = False):
        """Cast the floating parameters in place to the f32 master dtype (the
        ``Parameter`` objects stay, so an optimizer already built over them
        stays bound), move them to the device, and turn training on unless
        ``evaluation_mode``."""
        if not isinstance(model, Model):
            raise TypeError(f"prepare_model takes an accelerate_tpu_torch Model, got {type(model).__name__}")
        if getattr(model, "_is_accelerate_prepared", False):
            return model
        if getattr(getattr(model, "config", None), "quant_method", None) is not None:
            raise NotImplementedError(
                f"model is weight-only quantized ({model.config.quant_method}): its integer codes cannot be cast "
                "to f32 masters or trained; prepare the float model, or serve the quantized one as it is "
                "(preparing a quantized model for sharded inference is queued in ROADMAP.md)"
            )
        placement = self.device_placement if device_placement is None else device_placement
        param_dtype = MixedPrecisionPolicy.torch_dtype(self.state.dtype_policy.param_dtype)
        with torch.no_grad():
            for p in model.module.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(device=self.device if placement else p.device, dtype=param_dtype)
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

    def build_eval_step(self, eval_fn: Callable, model: Optional[Model] = None) -> Callable:
        """``eval_fn(params, *args)`` on the compute-dtype copy of the model's
        current parameters, without autograd."""
        model = model or self._models[-1]

        def run(*args, **kwargs):
            with torch.no_grad():
                return eval_fn(self._compute_cast(model.params), *args, **kwargs)

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
        argument or one named ``rng``. Updates the prepared model and
        optimizer in place. ``donate`` is accepted for the JAX signature
        (eager PyTorch frees what it no longer needs)."""
        if has_state:
            raise NotImplementedError(
                "has_state (mutable model state: BatchNorm, fp8 amax histories) is not ported to "
                "accelerate_tpu_torch yet (ROADMAP.md Queue 1 B)"
            )
        model = model or self._models[-1]
        optimizer = optimizer or (self._optimizers[-1] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before building a train step")
        scheduler = scheduler or (self._schedulers[-1] if self._schedulers else None)
        accum = self.gradient_accumulation_steps
        use_fp16 = self.mixed_precision == "fp16"
        rng_mode = _rng_mode(loss_fn)
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        if not named:
            raise ValueError("the model has no trainable parameters: prepare_model it first")
        masters = [p for _, p in named]
        box = {"bufs": None, "micro": 0}

        def step(batch):
            gs = self.gradient_state
            do_sync = (box["micro"] + 1) % accum == 0
            if gs.sync_with_dataloader and gs.in_dataloader and gs.end_of_dataloader:
                do_sync = True
            gs._set_sync_gradients(do_sync)

            for p in masters:
                p.grad = None
            compute = self._compute_cast(dict(named))
            if rng_mode == "positional":
                out = loss_fn(compute, batch, generator_for_step(self.step, self.device))
            elif rng_mode == "keyword":
                out = loss_fn(compute, batch, rng=generator_for_step(self.step, self.device))
            else:
                out = loss_fn(compute, batch)
            loss, aux = out if has_aux else (out, None)
            loss_scale = self._loss_scale
            (loss.float() * loss_scale).backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in masters]
            torch._foreach_div_(grads, max(loss_scale, 1.0) * accum)
            if box["bufs"] is None:  # a zeroed buffer plus these grads is these grads
                box["bufs"] = grads
            else:
                torch._foreach_add_(box["bufs"], grads)
            for p in masters:
                p.grad = None

            if do_sync:
                bufs, box["bufs"] = box["bufs"], None
                gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(bufs)))
                clip = self._clip_max_norm  # read at call time: clip_grad_norm_ in the loop applies next step
                if clip is not None and clip >= 0:
                    torch._foreach_mul_(bufs, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
                finite = bool(torch.isfinite(gnorm)) if use_fp16 else True
                if finite:
                    for p, g in zip(masters, bufs):
                        p.grad = g
                    optimizer.optimizer.step()
                if use_fp16:
                    self._update_loss_scale(finite)
                    optimizer._step_was_skipped = not finite
                self._last_grad_norm = gnorm
                if scheduler is not None:
                    scheduler.step()
            else:
                self._last_grad_norm = torch.zeros((), device=self.device)
            box["micro"] = 0 if do_sync else box["micro"] + 1
            self.step += 1
            loss = loss.detach()
            return (loss, aux) if has_aux else loss

        return step

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

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Set the global-norm bound the next sync boundary applies (a
        negative bound turns clipping off, 0 zeroes the gradient); returns
        the last boundary's pre-clip norm."""
        if norm_type != 2.0:
            raise NotImplementedError("only the L2 global norm is supported")
        self._clip_max_norm = max_norm
        return self._last_grad_norm

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

        return load_accelerator_state(self, input_dir, **load_model_func_kwargs)

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


def _rng_mode(loss_fn: Callable) -> str:
    """``"positional"`` when ``loss_fn`` takes a required third positional
    argument, ``"keyword"`` when it has a parameter named ``rng``, else
    ``"none"`` (arguments bound by ``functools.partial`` do not count)."""
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
    if required >= 3:
        return "positional"
    return "keyword" if "rng" in params else "none"
