"""Qwen2: the llama architecture + biased q/k/v projections.

Counterpart of :mod:`accelerate_tpu.models.qwen2`: :class:`Qwen2Config`
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
class Qwen2Config(LlamaConfig):
    """Llama config with Qwen2-7B defaults (qkv bias on, window off)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    qkv_bias: bool = True

    @classmethod
    def tiny(cls, **kw) -> "Qwen2Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    @classmethod
    def qwen2_7b(cls, **kw) -> "Qwen2Config":
        return cls(**kw)


def create_qwen2_model(
    config: Optional[Qwen2Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Qwen2's biased q/k/v
    projections, on seeded random weights
    (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or Qwen2Config.tiny(), seed=seed, device=device, dtype=dtype)
