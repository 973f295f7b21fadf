"""Mixtral-style sparse-MoE decoder: Llama attention plus top-k routed
experts.

Counterpart of :mod:`accelerate_tpu.models.mixtral`. A layer is the
port's :class:`~.llama.LlamaAttention` (built from
:meth:`MixtralConfig.as_llama`, so Qwen3-MoE's per-head q/k norms and
explicit head width come with it) and a :class:`~..ops.moe.MoEBlock`,
each behind its RMSNorm (``input_norm``, ``post_attn_norm``); the head is
a separate ``lm_head`` computed in f32. There is no remat knob and no
decode path, as in the reference: this family is the expert-axis
training surface.

The reference sows each layer's router aux loss into ``intermediates``;
here ``forward(input_ids, with_aux=True)`` returns ``(logits, [aux per
layer])``, which :func:`mixtral_lm_loss` adds to the cross entropy as the
reference does. Weights cross from the JAX package through
:func:`~.convert.mixtral_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from ..modeling import Model
from ..ops.moe import MoEBlock
from ..utils.environment import resolve_device
from .llama import (
    LlamaAttention,
    LlamaConfig,
    RMSNorm,
    _check_supported,
    causal_lm_loss,
    next_token_cross_entropy,
    rope_cos_sin,
)


@dataclasses.dataclass
class MixtralConfig:
    """A copy of :class:`accelerate_tpu.models.mixtral.MixtralConfig` (same
    fields and defaults)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    router_aux_loss_coef: float = 0.02
    attention_impl: str = "auto"
    # Qwen3-MoE variations through the same machinery: per-head q/k
    # RMSNorm, an explicit head width, a separate expert FF width, and the
    # raw-softmax (non-renormalised) combine weights
    qk_norm: bool = False
    head_dim: Optional[int] = None
    moe_intermediate_size: Optional[int] = None
    norm_topk: bool = True

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 96)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("num_local_experts", 4)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
            attention_impl=self.attention_impl,
            qk_norm=self.qk_norm,
            head_dim=self.head_dim,
        )


class MixtralLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg.as_llama())
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.moe = MoEBlock(
            cfg.hidden_size, cfg.num_local_experts, cfg.moe_intermediate_size or cfg.intermediate_size,
            num_selected=cfg.num_experts_per_tok, capacity_factor=cfg.capacity_factor, norm_topk=cfg.norm_topk,
        )

    def forward(self, hidden, cos, sin):
        """``(new hidden, this layer's router aux loss)``."""
        hidden = hidden + self.attn(self.input_norm(hidden), cos, sin)
        out, aux = self.moe(self.post_attn_norm(hidden))
        return hidden + out, aux


class MixtralModel(nn.Module):
    """``forward(input_ids, with_aux=False)``: logits ``[B, S, V]`` (f32),
    or ``(logits, [aux loss per layer])``."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        _check_supported(cfg.as_llama())
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([MixtralLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids, with_aux: bool = False):
        cfg = self.config
        b, s = input_ids.shape
        hidden = self.embed_tokens(input_ids.long())
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
        head_dim = cfg.head_dim or cfg.hidden_size // cfg.num_attention_heads
        cos, sin = rope_cos_sin(positions, head_dim, cfg.rope_theta)
        auxes = []
        for layer in self.layers:
            hidden, aux = layer(hidden, cos, sin)
            auxes.append(aux)
        logits = self.final_norm(hidden).float() @ self.lm_head.weight.float().T
        return (logits, auxes) if with_aux else logits


def create_mixtral_model(
    config: Optional[MixtralConfig] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A Mixtral with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for). Every weight draws ``N(0, 1/fan_in)`` from a
    ``torch.Generator`` seeded with ``seed``, fan_in being the width its
    product contracts: a projection's input, the embedding's width, and for
    the stacked experts ``[E, d, ff]`` / ``[E, ff, d]`` the per-expert
    input (``d``, ``ff``), not flax ``lecun_normal``'s ``E * d`` over the
    stack. Parameters are in ``dtype`` except the LM head, kept in f32;
    norms start at one."""
    config = config or MixtralConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = MixtralModel(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                fan_in = p.shape[-2] if p.ndim == 3 else p.shape[-1]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            if name.startswith("lm_head"):
                p.data = p.data.to(dtype).float()  # f32 storage of values drawn at the stream's precision
            else:
                p.data = p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()
    return Model(module, config, name="mixtral")


def mixtral_lm_loss(params, batch, apply_fn=None, module=None, aux_coef: Optional[float] = None):
    """Causal-LM loss plus the router load-balance term, from one forward:
    ``aux_coef`` (default: the config's ``router_aux_loss_coef``) times the
    mean of the layers' aux losses. ``module`` is the model's ``nn.Module``
    (``model.module``), run on ``params``; without it this is
    :func:`~.llama.causal_lm_loss` through ``apply_fn``, as in the
    reference."""
    if module is None:
        return causal_lm_loss(params, batch, apply_fn)
    if aux_coef is None:
        aux_coef = module.config.router_aux_loss_coef
    logits, auxes = functional_call(module, params, (batch["input_ids"],), {"with_aux": True})
    loss = next_token_cross_entropy(logits, batch)
    if auxes:
        loss = loss + aux_coef * sum(auxes) / len(auxes)
    return loss
