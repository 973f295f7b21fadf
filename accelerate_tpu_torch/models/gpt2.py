"""GPT-2 decoder in PyTorch: learned positions, pre-LayerNorm, a tanh-GELU
MLP, biased projections and a tied head.

Counterpart of :mod:`accelerate_tpu.models.gpt2`, with its arithmetic:

* ``wpe`` is read at the given ``positions`` (a decode step's own), added
  to the token embedding in the stream dtype; ``embd_pdrop`` is never
  applied, as in the reference;
* every LayerNorm (``ln_1``, ``ln_2``, ``ln_f``) computes in f32 and casts
  back to the stream dtype (flax ``nn.LayerNorm(dtype=hidden.dtype)``);
* every projection is a :class:`~..ops.fp8.PolicyLinear` with a bias, so
  under fp8 it takes the policy's product as the reference's
  ``policy_dot_general()`` does (the reference builds no delayed-scaling
  layer here: under that recipe the product is the dynamic one too);
* the head is tied and computed in f32 (``hidden.float() @
  wte.float().T``), or an untied f32 ``lm_head``;
* ``remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``).

``forward(input_ids, positions=None, decode=False, cache=None)`` is
:class:`~.llama.LlamaModel`'s decode contract: with ``decode=True`` it
returns ``(logits, cache)`` over the dense cache (``cache=None`` starts
one of ``max_position_embeddings`` rows) or a
:class:`~..ops.paged_kv.PagedKVCache`, so ``generate`` and the
``ServingEngine`` serve it. Weights cross from the JAX package through
:func:`~.convert.gpt2_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..ops.fp8 import PolicyLinear
from ..ops.kv_cache import KVCache, cached_attention
from ..utils.environment import resolve_device


@dataclasses.dataclass
class GPT2Config:
    """A copy of :class:`accelerate_tpu.models.gpt2.GPT2Config` (same fields
    and defaults)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None  # defaults to 4*hidden
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    embd_pdrop: float = 0.1
    tie_word_embeddings: bool = True
    remat: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 from any input dtype, cast back."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


class GPT2Attention(nn.Module):
    """Multi-head attention with biased projections: the einsum or flash
    path without a cache, :func:`~..ops.kv_cache.cached_attention` with one."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (
            PolicyLinear(hidden_size, hidden_size, bias=True) for _ in range(4)
        )

    def forward(self, hidden, cache=None, layer: int = 0, rotate=None):
        """``rotate(x) -> x`` is applied to the split q and k (GPT-NeoX's
        partial rope)."""
        b, s, width = hidden.shape
        q, k, v = (p(hidden).view(b, s, self.num_heads, width // self.num_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if rotate is not None:
            q, k = rotate(q), rotate(k)
        if cache is not None:
            out = cached_attention(cache, layer, q, k, v)
        else:
            out = dot_product_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, width))


class GPT2MLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, approximate: str):
        super().__init__()
        self.approximate = approximate
        self.fc_in = PolicyLinear(hidden_size, intermediate_size, bias=True)
        self.fc_out = PolicyLinear(intermediate_size, hidden_size, bias=True)

    def forward(self, hidden):
        return self.fc_out(F.gelu(self.fc_in(hidden), approximate=self.approximate))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = GPT2Attention(cfg.hidden_size, cfg.num_attention_heads)
        self.ln_2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = GPT2MLP(cfg.hidden_size, cfg.intermediate_size, "tanh")

    def forward(self, hidden, cache=None, layer: int = 0):
        hidden = hidden + self.attn(self.ln_1(hidden), cache, layer)
        return hidden + self.mlp(self.ln_2(hidden))


def remat_block(block: nn.Module, *inputs):
    """``block(*inputs)`` with its activations recomputed in the backward;
    its current parameter tensors (under ``Model.apply_fn``, the
    compute-dtype copies) go in as inputs and are bound again for the
    recompute, as :func:`~.llama._remat_layer` does."""
    names, tensors = zip(*block.named_parameters())
    n = len(inputs)

    def run(*args):
        return functional_call(block, dict(zip(names, args[n:])), args[:n])

    return checkpoint(run, *inputs, *tensors, use_reentrant=False)


def _init(module: nn.Module, dtype: torch.dtype, seed: int, dev, f32_head: str) -> None:
    """Seeded weights: every weight and embedding ``N(0, 1/fan_in)`` from a
    ``torch.Generator``, norms at one, biases at zero; everything in
    ``dtype`` but the untied head ``f32_head``, kept in f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=gen)
            p.data = p.data.to(dtype).float() if name.startswith(f32_head) else p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()


class GPT2Model(nn.Module):
    """``forward(input_ids, positions=None, decode=False, cache=None)``:
    logits ``[B, S, V]`` (f32), or with ``decode=True`` ``(logits, cache)``;
    the cache is updated in place."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.layers = nn.ModuleList([GPT2Block(cfg) for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids, positions=None, decode: bool = False, cache=None):
        cfg = self.config
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None]
        hidden = self.wte(input_ids.long()) + self.wpe(positions.long())
        if decode and cache is None:
            cache = KVCache.empty(cfg, b, cfg.max_position_embeddings, hidden.dtype, hidden.device)
        remat = cfg.remat and self.training and not decode and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            hidden = remat_block(layer, hidden) if remat else layer(hidden, cache if decode else None, i)
        head = self.wte.weight if cfg.tie_word_embeddings else self.lm_head.weight
        logits = self.ln_f(hidden).float() @ head.float().T
        if not decode:
            return logits
        cache.advance(s)
        return logits, cache


def create_gpt2_model(
    config: Optional[GPT2Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A GPT-2 with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), in ``dtype`` but for an untied ``lm_head``,
    kept in f32 (a tied head is the embedding table)."""
    config = config or GPT2Config.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = GPT2Model(config)
    module.to_empty(device=dev)
    _init(module, dtype, seed, dev, "lm_head")
    return Model(module, config, name="gpt2")
