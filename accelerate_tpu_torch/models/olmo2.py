"""OLMo2: the llama architecture with post-norms and flat q/k RMSNorm.

Counterpart of :mod:`accelerate_tpu.models.olmo2`: :class:`Olmo2Config`
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
class Olmo2Config(LlamaConfig):
    """Llama config with OLMo2-7B defaults (post-norms, flat qk-norm)."""

    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 500000.0
    norm_after: bool = True
    qk_norm_flat: bool = True

    @classmethod
    def tiny(cls, **kw) -> "Olmo2Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    @classmethod
    def olmo2_7b(cls, **kw) -> "Olmo2Config":
        return cls(**kw)


def create_olmo2_model(
    config: Optional[Olmo2Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A llama :class:`~..modeling.Model` with OLMo2's post-norm layout and
    flat q/k norms, on seeded random weights
    (:func:`~.llama.create_llama_model`)."""
    return create_llama_model(config or Olmo2Config.tiny(), seed=seed, device=device, dtype=dtype)
