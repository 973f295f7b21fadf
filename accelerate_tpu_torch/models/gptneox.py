"""GPT-NeoX decoder in PyTorch: partial rotary, parallel residual, an
untied head.

Counterpart of :mod:`accelerate_tpu.models.gptneox`:

* the rotary embedding turns the first ``int(head_dim * rotary_pct)``
  dims of each head with the Llama :func:`~.llama.rope` (interleaved
  pairs, f32), and the tail passes through (:func:`partial_rope`);
* ``use_parallel_residual`` gives ``x + attn(ln1(x)) + mlp(ln2(x))``,
  otherwise the residual is sequential;
* the MLP's GELU is exact (erf);
* LayerNorms, biased :class:`~..ops.fp8.PolicyLinear` projections and the
  decode contract are GPT-2's (:mod:`.gpt2`); the head is an untied f32
  ``embed_out``.

The rotary tables are computed once a forward and shared by the layers.
Weights cross from the JAX package through
:func:`~.convert.gptneox_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..modeling import Model
from ..ops.kv_cache import KVCache
from ..utils.environment import resolve_device
from .gpt2 import GPT2Attention, GPT2MLP, LayerNorm, _init, remat_block
from .llama import apply_rope, rope_cos_sin


@dataclasses.dataclass
class GPTNeoXConfig:
    """A copy of :class:`accelerate_tpu.models.gptneox.GPTNeoXConfig` (same
    fields and defaults)."""

    vocab_size: int = 50432
    hidden_size: int = 6144
    num_hidden_layers: int = 44
    num_attention_heads: int = 64
    intermediate_size: Optional[int] = None  # defaults to 4*hidden
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    remat: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def neox_20b(cls, **kw) -> "GPTNeoXConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "GPTNeoXConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``2 * cos.shape[-1]`` dims of ``x [B, S, H, D]``."""
    rotary_dims = 2 * cos.shape[-1]
    if rotary_dims >= x.shape[-1]:
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rotary_dims], cos, sin), x[..., rotary_dims:]], dim=-1)


def partial_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, rotary_dims: int) -> torch.Tensor:
    """Rotary embedding on the first ``rotary_dims`` of the head dim of ``x
    [B, S, H, D]``; the tail passes through (GPT-NeoX ``rotary_pct``)."""
    cos, sin = rope_cos_sin(positions, min(rotary_dims, x.shape[-1]), theta)
    return _rotate(x, cos, sin)


class GPTNeoXBlock(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig):
        super().__init__()
        self.parallel = cfg.use_parallel_residual
        self.input_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = GPT2Attention(cfg.hidden_size, cfg.num_attention_heads)
        self.post_attn_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = GPT2MLP(cfg.hidden_size, cfg.intermediate_size, "none")

    def forward(self, hidden, cos, sin, cache=None, layer: int = 0):
        attn_out = self.attn(self.input_norm(hidden), cache, layer, rotate=lambda x: _rotate(x, cos, sin))
        if self.parallel:  # both branches read the same residual stream
            return hidden + attn_out + self.mlp(self.post_attn_norm(hidden))
        hidden = hidden + attn_out
        return hidden + self.mlp(self.post_attn_norm(hidden))


class GPTNeoXModel(nn.Module):
    """``forward(input_ids, positions=None, decode=False, cache=None)``, as
    :class:`~.gpt2.GPT2Model`'s."""

    def __init__(self, cfg: GPTNeoXConfig):
        super().__init__()
        self.config = cfg
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([GPTNeoXBlock(cfg) for _ in range(cfg.num_hidden_layers)])
        self.final_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.embed_out = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids, positions=None, decode: bool = False, cache=None):
        cfg = self.config
        b, s = input_ids.shape
        hidden = self.embed_in(input_ids.long())
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None]
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        cos, sin = rope_cos_sin(positions, min(int(head_dim * cfg.rotary_pct), head_dim), cfg.rope_theta)
        if decode and cache is None:
            cache = KVCache.empty(cfg, b, cfg.max_position_embeddings, hidden.dtype, hidden.device)
        remat = cfg.remat and self.training and not decode and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                hidden = remat_block(layer, hidden, cos, sin)
            else:
                hidden = layer(hidden, cos, sin, cache if decode else None, i)
        logits = self.final_norm(hidden).float() @ self.embed_out.weight.float().T
        if not decode:
            return logits
        cache.advance(s)
        return logits, cache


def create_gptneox_model(
    config: Optional[GPTNeoXConfig] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A GPT-NeoX with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), in ``dtype`` but for ``embed_out``, kept in
    f32 (:func:`~.gpt2.create_gpt2_model`'s draws)."""
    config = config or GPTNeoXConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = GPTNeoXModel(config)
    module.to_empty(device=dev)
    _init(module, dtype, seed, dev, "embed_out")
    return Model(module, config, name="gptneox")
