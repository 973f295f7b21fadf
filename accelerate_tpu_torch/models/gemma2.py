"""Gemma2: the llama skeleton with Google's second-generation deviations.

Counterpart of :mod:`accelerate_tpu.models.gemma2`: :class:`Gemma2Config`
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


def _alternating(n_layers: int) -> tuple:
    """HF Gemma2 layer pattern: odd layers slide, even layers are global."""
    return tuple(
        "sliding_attention" if bool((i + 1) % 2) else "full_attention" for i in range(n_layers)
    )


@dataclasses.dataclass
class Gemma2Config(LlamaConfig):
    """Llama config with gemma2-9b defaults (sandwich norms, softcaps,
    alternating 4096-token window)."""

    vocab_size: int = 256000
    hidden_size: int = 3584
    intermediate_size: int = 14336
    num_hidden_layers: int = 42
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: Optional[int] = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    mlp_activation: str = "gelu_tanh"
    norm_plus_one: bool = True
    scale_embeddings: bool = True
    tie_word_embeddings: bool = True
    sandwich_norm: bool = True
    attn_logit_softcap: Optional[float] = 50.0
    final_logit_softcap: Optional[float] = 30.0
    query_pre_attn_scalar: Optional[float] = 256.0  # transformers Gemma2Config default
    sliding_window: Optional[int] = 4096
    layer_types: Optional[tuple] = None  # filled per num_hidden_layers below
    scan_layers: bool = False  # per-layer attention kinds need the unrolled stack

    def __post_init__(self):
        if self.layer_types is None:
            self.layer_types = _alternating(self.num_hidden_layers)
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for "
                f"{self.num_hidden_layers} layers — pass both together (or neither)"
            )

    @classmethod
    def tiny(cls, **kw) -> "Gemma2Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)  # one sliding + one full layer
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("max_position_embeddings", 128)
        kw.setdefault("sliding_window", 8)  # small enough for the band to bite
        kw.setdefault("query_pre_attn_scalar", 32.0)  # != head_dim: scale is load-bearing
        return cls(**kw)

    @classmethod
    def gemma2_9b(cls, **kw) -> "Gemma2Config":
        return cls(**kw)


def create_gemma2_model(
    config: Optional[Gemma2Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Gemma2's sandwich norms,
    softcaps and alternating windows, on seeded random weights
    (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or Gemma2Config.tiny(), seed=seed, device=device, dtype=dtype)
