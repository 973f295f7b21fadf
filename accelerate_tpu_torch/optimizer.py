"""Optimizer wrapper over a ``torch.optim.Optimizer``.

Counterpart of :mod:`accelerate_tpu.optimizer`. The wrapped optimizer holds
the f32 master parameters of a prepared model (``prepare_model`` casts
them in place, so an optimizer built over ``model.parameters()`` before
``prepare`` stays bound to them). On a sync boundary both training paths
apply the accumulated f32 gradient through one applier
(``Accelerator._apply_gradients``): clipped, their ``.grad`` set to it,
``step`` of the wrapped optimizer called; under fp16 a non-finite gradient
skips it and :attr:`step_was_skipped` says so. ``build_train_step`` calls
it itself; on the imperative path (``Accelerator.accumulate`` /
``backward``) :meth:`AcceleratedOptimizer.step` does, and is a no-op inside
an accumulation window.
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
        self._model = None  # the model whose gradient buffer step() applies, set by prepare
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
        """Clear the imperative path's gradient buffer and the master
        gradients; a no-op inside an accumulation window (``sync_gradients``
        false), so the loop ``backward; step; zero_grad`` keeps what it
        buffered, as in the JAX package."""
        if not self.gradient_state.sync_gradients:
            return
        if self.accelerator is not None:
            self.accelerator._zero_grad_buffer(self._model)
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        """Apply the gradient ``Accelerator.backward`` accumulated, on a sync
        boundary; inside an accumulation window nothing happens and
        :attr:`step_was_skipped` is False."""
        if self.accelerator is None:
            raise RuntimeError("This optimizer was not prepared by an Accelerator.")
        if not self.gradient_state.sync_gradients:
            self._step_was_skipped = False
            return
        self._step_was_skipped = not self.accelerator._apply_accumulated_gradients(self)

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict)

    def __repr__(self) -> str:
        return f"AcceleratedOptimizer({self.optimizer})"
