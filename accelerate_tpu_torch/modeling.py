"""The model container: an ``nn.Module`` with its config and device.

Counterpart of :mod:`accelerate_tpu.modeling`. The JAX package pairs an
``apply_fn`` with a parameter pytree; here the parameters live in the
module, and :class:`Model` keeps the call contract the serving engine
relies on: ``model(ids, positions=..., decode=True, cache=...) ->
(logits, cache)``. For training it keeps the JAX call contract too:
``model.apply_fn(params, input_ids)`` runs the module on ``params``, a
dict of tensors by parameter name (``torch.func.functional_call``), so a
loss is written ``loss_fn(params, batch)`` as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.func import functional_call


class Model:
    """An ``nn.Module`` plus its ``config``. Calling it forwards to the
    module (``decode=True`` threads a KV cache and returns ``(logits,
    cache)``)."""

    def __init__(self, module: nn.Module, config: Any, name: Optional[str] = None):
        self.module = module
        self.config = config
        self.name = name or type(module).__name__

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        """The stream dtype: the first floating-point parameter's (the
        embedding table, for the models of the zoo)."""
        return next(p.dtype for p in self.module.parameters() if p.is_floating_point())

    def __call__(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    @property
    def params(self) -> dict:
        """The module's parameters by name (the tensors themselves)."""
        return dict(self.module.named_parameters())

    def apply_fn(self, params: dict, input_ids: torch.Tensor, *args, **kwargs):
        """The module's forward on ``params`` (a dict of tensors by name)
        in place of its own parameters."""
        return functional_call(self.module, params, (input_ids, *args), kwargs)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def state_dict(self) -> dict:
        return self.module.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        """Copy ``state_dict`` into the module, keeping each parameter's
        device and dtype; every key must match."""
        self.module.load_state_dict(state_dict, strict=True)

    def __repr__(self) -> str:
        return f"Model({self.name}, params={self.num_parameters():,}, device={self.device})"
