"""The model container: an ``nn.Module`` with its config and device.

Counterpart of :mod:`accelerate_tpu.modeling`. The JAX package pairs an
``apply_fn`` with a parameter pytree; here the parameters live in the
module, and :class:`Model` keeps the call contract the serving engine
relies on: ``model(ids, positions=..., decode=True, cache=...) ->
(logits, cache)``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn


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
        """The stream dtype (the embedding table's)."""
        return self.module.embed_tokens.weight.dtype

    def __call__(self, *args, **kwargs):
        return self.module(*args, **kwargs)

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
