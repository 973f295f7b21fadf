"""Optimizer wrapper over a ``torch.optim.Optimizer``.

Counterpart of :mod:`accelerate_tpu.optimizer`. The wrapped optimizer holds
the f32 master parameters of a prepared model (``prepare_model`` casts
them in place, so an optimizer built over ``model.parameters()`` before
``prepare`` stays bound to them). ``Accelerator.build_train_step`` sets
their ``.grad`` to the accumulated, clipped gradient on a sync boundary and
calls ``step`` of the wrapped optimizer; under fp16 a non-finite gradient
skips it and :attr:`step_was_skipped` says so. The imperative path
(``Accelerator.accumulate``/``backward`` with ``optimizer.step()``) is not
ported yet (ROADMAP.md Queue 1 B).
"""

from __future__ import annotations

import torch

from .state import GradientState


class AcceleratedOptimizer:
    """Wraps a ``torch.optim.Optimizer``."""

    def __init__(self, optimizer: torch.optim.Optimizer, scaler=None, accelerator=None):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"AcceleratedOptimizer wraps a torch.optim.Optimizer, got {type(optimizer).__name__}")
        self.optimizer = optimizer
        self.scaler = scaler
        self.accelerator = accelerator
        self._is_accelerate_prepared = False
        self._step_was_skipped = False
        self.gradient_state = GradientState()

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def step_was_skipped(self) -> bool:
        """True when the last sync boundary dropped its update because the
        gradient was not finite (fp16 overflow)."""
        return bool(self._step_was_skipped)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the master gradients; a no-op inside an accumulation window
        (``sync_gradients`` false), as in the JAX package."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        raise NotImplementedError(
            "the imperative path (Accelerator.accumulate/backward + optimizer.step) is not ported yet "
            "(ROADMAP.md Queue 1 B); train through Accelerator.build_train_step"
        )

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict)

    def __repr__(self) -> str:
        return f"AcceleratedOptimizer({self.optimizer})"
