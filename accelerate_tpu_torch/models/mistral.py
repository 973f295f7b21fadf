"""Mistral: the llama architecture + sliding-window attention.

Counterpart of :mod:`accelerate_tpu.models.mistral`: :class:`MistralConfig`
subclasses :class:`~.llama.LlamaConfig` with the same fields, defaults and
presets, and the module, loss, decode and serving surfaces are the llama
ones (:mod:`.llama`). Weights cross from the JAX package through
:func:`~.convert.llama_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..modeling import Model
from .llama import LlamaConfig, create_llama_model


@dataclasses.dataclass
class MistralConfig(LlamaConfig):
    """Llama config with Mistral-7B-v0.1 defaults: 32k context with a
    4096-token window, theta 1e4. v0.2/v0.3 dropped the window and
    raised theta — use :meth:`mistral_7b_v3` for those checkpoints (the
    wrong variant means wrong rotary angles or a spurious band mask)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = 4096

    @classmethod
    def tiny(cls, **kw) -> "MistralConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("max_position_embeddings", 128)
        kw.setdefault("sliding_window", 8)
        return cls(**kw)

    @classmethod
    def mistral_7b_v1(cls, **kw) -> "MistralConfig":
        """Mistral-7B-v0.1: theta 1e4, sliding window 4096."""
        return cls(**kw)

    @classmethod
    def mistral_7b_v3(cls, **kw) -> "MistralConfig":
        """Mistral-7B-v0.2/v0.3: theta 1e6, NO sliding window (the v0.2
        change); v0.3 only grew the vocab for tool tokens."""
        kw.setdefault("vocab_size", 32768)
        kw.setdefault("rope_theta", 1e6)
        kw.setdefault("sliding_window", None)
        return cls(**kw)


def create_mistral_model(
    config: Optional[MistralConfig] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Mistral's band
    (``sliding_window``), on seeded random weights
    (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or MistralConfig.tiny(), seed=seed, device=device, dtype=dtype)
