"""Process and precision singletons: ``PartialState``, ``AcceleratorState``
and ``GradientState``.

Counterpart of :mod:`accelerate_tpu.state`, single process only: a
``WORLD_SIZE`` above 1 raises (multi-process training is ROADMAP.md Queue
1 item 8). The borg pattern is kept: every instance constructed in the process
shares one state, and ``_reset_state`` clears it. The device is ``cuda``,
or ``cpu`` when ``cpu=True`` is passed; with no card and no ``cpu=True``
construction raises.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch

from .utils.dataclasses import MixedPrecisionPolicy, ParallelismPlugin, PrecisionType
from .utils.environment import resolve_device

logger = logging.getLogger(__name__)


class PartialState:
    """The process: one, on one device."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: accelerate_tpu_torch runs one process on one card; "
                "multi-process training is queued in ROADMAP.md Queue 1 item 8"
            )
        self._cpu = cpu
        self.device = resolve_device("cpu" if cpu else None)
        self.num_processes = 1
        self.process_index = 0
        self.local_process_index = 0
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool):
        self._shared_state["_initialized"] = value

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self) -> None:
        """A barrier across processes: with one process, nothing to wait for."""

    @contextmanager
    def main_process_first(self):
        """The main process runs the body first, the others wait for it
        (dataset download and caching)."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self):
        if not self.is_local_main_process:
            self.wait_for_everyone()
        yield
        if self.is_local_main_process:
            self.wait_for_everyone()

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's share of a list, tuple, dict or tensor split
        evenly across processes; ``apply_padding`` repeats the last element
        so every share has one length. One process: all of ``inputs``."""
        yield inputs

    def on_main_process(self, function: Callable) -> Callable:
        """Decorator: run ``function`` on the main process only."""

        def wrapper(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_local_main_process(self, function: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if self.is_local_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_process(self, function: Optional[Callable] = None, process_index: Optional[int] = None) -> Callable:
        def wrapper(*args, **kwargs):
            if self.process_index == process_index:
                return function(*args, **kwargs)

        return wrapper

    def on_last_process(self, function: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if self.is_last_process:
                return function(*args, **kwargs)

        return wrapper

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process only."""
        if self.is_main_process:
            print(*args, **kwargs)

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()


class AcceleratorState:
    """Adds the precision policy and the parallelism plugin to
    :class:`PartialState`."""

    _shared_state: dict[str, Any] = {}

    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        cpu: bool = False,
        parallelism_plugin: Optional[ParallelismPlugin] = None,
        _from_accelerator: bool = False,
        **kwargs,
    ):
        self.__dict__ = self._shared_state
        if self.initialized:
            if mixed_precision is not None and mixed_precision != self.mixed_precision:
                logger.warning(
                    "AcceleratorState already initialized with mixed_precision=%s; ignoring %s",
                    self.mixed_precision, mixed_precision,
                )
            return
        self.partial_state = PartialState(cpu=cpu, **kwargs)
        if mixed_precision is None:
            mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION", "no")
        self.mixed_precision = str(PrecisionType(mixed_precision))
        self.dtype_policy = MixedPrecisionPolicy.from_mixed_precision(self.mixed_precision)
        self.parallelism_plugin = parallelism_plugin or ParallelismPlugin()
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool):
        self._shared_state["_initialized"] = value

    @property
    def device(self) -> torch.device:
        return self.partial_state.device

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False):
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation bookkeeping: the ``sync_gradients`` flag and the
    registry of loaders being iterated. The active (innermost) loader's
    last batch forces a sync, and its ``remainder`` (the real rows of a
    padded last batch, -1 when nothing was padded) drives
    ``Accelerator.gather_for_metrics``'s truncation."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin=None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = [None]
            self.plugin_kwargs = {}
            self.initialized = True
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_dict()

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool):
        self._shared_state["_initialized"] = value

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and bool(self.active_dataloader.end_of_dataloader)

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader):
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader):
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()
