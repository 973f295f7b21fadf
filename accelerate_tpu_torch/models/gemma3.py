"""Gemma3 (text): the gemma lineage's third generation on the llama core.

Counterpart of :mod:`accelerate_tpu.models.gemma3`: :class:`Gemma3Config`
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


def _five_to_one(n_layers: int) -> tuple:
    """HF Gemma3 pattern: every 6th layer is global, the rest slide."""
    return tuple(
        "full_attention" if (i + 1) % 6 == 0 else "sliding_attention" for i in range(n_layers)
    )


@dataclasses.dataclass
class Gemma3Config(LlamaConfig):
    """Llama config with google/gemma-3-1b text defaults (5:1 local/global,
    dual rope bases, per-head qk-norm, MQA, 512-token window)."""

    vocab_size: int = 262144
    hidden_size: int = 1152
    intermediate_size: int = 6912
    num_hidden_layers: int = 26
    num_attention_heads: int = 4
    num_key_value_heads: int = 1
    head_dim: Optional[int] = 256
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    mlp_activation: str = "gelu_tanh"
    norm_plus_one: bool = True
    scale_embeddings: bool = True
    tie_word_embeddings: bool = True
    sandwich_norm: bool = True
    qk_norm: bool = True
    query_pre_attn_scalar: Optional[float] = 256.0
    sliding_window: Optional[int] = 512
    rope_theta: float = 1_000_000.0
    rope_local_theta: Optional[float] = 10_000.0
    layer_types: Optional[tuple] = None  # filled per num_hidden_layers below
    scan_layers: bool = False  # per-layer attention kinds need the unrolled stack

    def __post_init__(self):
        if self.layer_types is None:
            self.layer_types = _five_to_one(self.num_hidden_layers)
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for "
                f"{self.num_hidden_layers} layers — pass both together (or neither)"
            )

    @classmethod
    def tiny(cls, **kw) -> "Gemma3Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("max_position_embeddings", 128)
        kw.setdefault("sliding_window", 8)  # small enough for the band to bite
        kw.setdefault("query_pre_attn_scalar", 32.0)  # != head_dim: load-bearing
        kw.setdefault("layer_types", ("sliding_attention", "full_attention"))
        return cls(**kw)

    @classmethod
    def gemma3_1b(cls, **kw) -> "Gemma3Config":
        return cls(**kw)


def create_gemma3_model(
    config: Optional[Gemma3Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with Gemma3's dual rope bases,
    qk-norms and 5:1 attention pattern, on seeded random weights
    (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or Gemma3Config.tiny(), seed=seed, device=device, dtype=dtype)
