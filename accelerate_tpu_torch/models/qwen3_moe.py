"""Qwen3-MoE: Qwen3 attention plus top-k routed experts on the Mixtral core.

Counterpart of :mod:`accelerate_tpu.models.qwen3_moe`: the Mixtral
architecture (:mod:`.mixtral`) with Qwen3's attention (per-head q/k
RMSNorm, an explicit ``head_dim``, no qkv biases), a separate expert FF
width (``moe_intermediate_size``), combine weights renormalised over the
selected experts when ``norm_topk`` is set, and many small experts (128,
top-8). The module, the loss and the converter are Mixtral's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..modeling import Model
from .mixtral import MixtralConfig, MixtralModel, create_mixtral_model, mixtral_lm_loss

Qwen3MoeModel = MixtralModel
qwen3_moe_lm_loss = mixtral_lm_loss


@dataclasses.dataclass
class Qwen3MoeConfig(MixtralConfig):
    """Mixtral config with Qwen3-30B-A3B's defaults (128 experts, top-8,
    qk-norm, 768-wide experts)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 48
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = 128
    num_local_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: Optional[int] = 768
    max_position_embeddings: int = 40960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    router_aux_loss_coef: float = 0.001  # transformers Qwen3MoeConfig default
    qk_norm: bool = True
    norm_topk: bool = True  # released checkpoints set norm_topk_prob

    @classmethod
    def tiny(cls, **kw) -> "Qwen3MoeConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 96)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("num_local_experts", 4)
        kw.setdefault("num_experts_per_tok", 2)
        kw.setdefault("moe_intermediate_size", 48)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    @classmethod
    def qwen3_30b_a3b(cls, **kw) -> "Qwen3MoeConfig":
        return cls(**kw)


def create_qwen3_moe_model(
    config: Optional[Qwen3MoeConfig] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A :class:`~..modeling.Model` running the Mixtral module with Qwen3's
    attention and routing conventions, on seeded random weights
    (:func:`~.mixtral.create_mixtral_model`)."""
    return create_mixtral_model(config or Qwen3MoeConfig.tiny(), seed=seed, device=device, dtype=dtype)
