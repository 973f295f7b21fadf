"""Gemma: the llama skeleton with Google's four deviations.

Counterpart of :mod:`accelerate_tpu.models.gemma`: :class:`GemmaConfig`
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
class GemmaConfig(LlamaConfig):
    """Llama config with gemma-2b defaults (MQA, head_dim 256, GeGLU,
    (1+scale) norms, scaled embeddings)."""

    vocab_size: int = 256000
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: Optional[int] = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    mlp_activation: str = "gelu_tanh"
    norm_plus_one: bool = True
    scale_embeddings: bool = True
    tie_word_embeddings: bool = True

    @classmethod
    def tiny(cls, **kw) -> "GemmaConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 1)  # MQA like gemma-2b
        kw.setdefault("head_dim", 32)  # != hidden/heads on purpose
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    @classmethod
    def gemma_2b(cls, **kw) -> "GemmaConfig":
        return cls(**kw)

    @classmethod
    def gemma_7b(cls, **kw) -> "GemmaConfig":
        kw.setdefault("hidden_size", 3072)
        kw.setdefault("intermediate_size", 24576)
        kw.setdefault("num_hidden_layers", 28)
        kw.setdefault("num_attention_heads", 16)
        kw.setdefault("num_key_value_heads", 16)
        return cls(**kw)


def create_gemma_model(
    config: Optional[GemmaConfig] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Gemma's head width, GeGLU,
    (1+scale) norms and scaled embeddings, on seeded random weights
    (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or GemmaConfig.tiny(), seed=seed, device=device, dtype=dtype)
