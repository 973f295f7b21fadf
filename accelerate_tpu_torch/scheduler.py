"""LR scheduler wrapper.

Counterpart of :mod:`accelerate_tpu.scheduler`: the scheduler advances
only when the optimizer stepped (a sync boundary that was not skipped).
It wraps a ``torch.optim.lr_scheduler`` object (anything with ``step()``)
or a schedule function ``step -> lr``, whose value is written into the
wrapped optimizers' parameter groups at each advance. One process, one
card: a step is one batch's worth of data.
"""

from __future__ import annotations

from typing import Callable, Union

from .state import GradientState


class AcceleratedScheduler:
    def __init__(
        self,
        scheduler: Union[Callable[[int], float], object],
        optimizers=None,
        step_with_optimizer: bool = True,
        split_batches: bool = False,
    ):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers] if optimizers else []
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.step_count = 0
        self._is_accelerate_prepared = False
        self.gradient_state = GradientState()
        if not hasattr(scheduler, "step"):
            self._write_lr()

    def step(self, *args, **kwargs) -> None:
        if self.step_with_optimizer:
            if not self.gradient_state.sync_gradients:
                return
            if any(getattr(opt, "_step_was_skipped", False) for opt in self.optimizers):
                return
        self._advance(1)

    def _advance(self, n: int) -> None:
        self.step_count += n
        if hasattr(self.scheduler, "step"):
            for _ in range(n):
                self.scheduler.step()
        else:
            self._write_lr()

    def _write_lr(self) -> None:
        lr = float(self.scheduler(self.step_count))
        for opt in self.optimizers:
            for group in opt.param_groups:
                group["lr"] = lr

    def get_last_lr(self):
        if hasattr(self.scheduler, "get_last_lr"):
            return self.scheduler.get_last_lr()
        return [float(self.scheduler(self.step_count))]

    def state_dict(self) -> dict:
        state = {"step_count": self.step_count}
        if hasattr(self.scheduler, "state_dict"):
            state["scheduler"] = self.scheduler.state_dict()
        return state

    def load_state_dict(self, state_dict: dict) -> None:
        self.step_count = int(state_dict["step_count"])
        if "scheduler" in state_dict:
            self.scheduler.load_state_dict(state_dict["scheduler"])
