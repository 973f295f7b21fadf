"""Qwen3: the llama architecture + per-head q/k RMSNorm.

Counterpart of :mod:`accelerate_tpu.models.qwen3`: :class:`Qwen3Config`
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
class Qwen3Config(LlamaConfig):
    """Llama config with Qwen3-8B defaults (qk-norm on, explicit head_dim)."""

    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = 128
    max_position_embeddings: int = 40960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    qk_norm: bool = True

    @classmethod
    def tiny(cls, **kw) -> "Qwen3Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    @classmethod
    def qwen3_8b(cls, **kw) -> "Qwen3Config":
        return cls(**kw)


def create_qwen3_model(
    config: Optional[Qwen3Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Qwen3's per-head q/k norms, on
    seeded random weights (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or Qwen3Config.tiny(), seed=seed, device=device, dtype=dtype)
