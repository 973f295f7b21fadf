"""Phi-3: the llama architecture with fused checkpoint projections.

Counterpart of :mod:`accelerate_tpu.models.phi3`: :class:`Phi3Config`
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
class Phi3Config(LlamaConfig):
    """Llama config with phi-3-mini-4k defaults (MHA, 2047-token window)."""

    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = 2047

    @classmethod
    def tiny(cls, **kw) -> "Phi3Config":
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
    def phi3_mini_4k(cls, **kw) -> "Phi3Config":
        return cls(**kw)


def create_phi3_model(
    config: Optional[Phi3Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Phi-3's widths and window, on
    seeded random weights (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or Phi3Config.tiny(), seed=seed, device=device, dtype=dtype)
