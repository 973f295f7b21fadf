"""Llama decoder in PyTorch: RMSNorm, RoPE, GQA, SwiGLU.

Counterpart of :mod:`accelerate_tpu.models.llama`, plain pre-norm Llama
only. The arithmetic follows the JAX module step for step, so converted
weights (:mod:`.convert`) give the same logits:

* RMSNorm normalises in f32, casts to the stream dtype, then scales;
* rotary embedding uses the interleaved pair layout ``x[..., ::2]`` /
  ``x[..., 1::2]`` (not HF's rotate-half), computed in f32;
* the LM head runs in f32 whatever the stream dtype (its weight is kept
  in f32; a tied head casts the embedding table).

The knobs other families need (Qwen3/OLMo2 q/k norms, Gemma norms and
softcaps, per-layer attention kinds, quantized projections, ...) raise
``NotImplementedError``: they are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..ops.kv_cache import KVCache, cached_attention
from ..utils.environment import resolve_device


@dataclasses.dataclass
class LlamaConfig:
    """A copy of :class:`accelerate_tpu.models.llama.LlamaConfig` (same
    fields and defaults, so a config converts with ``dataclasses.asdict``)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    original_max_position_embeddings: Optional[int] = None
    scan_layers: bool = True
    remat: bool = True
    attention_impl: str = "auto"
    sliding_window: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    qk_norm_flat: bool = False
    norm_after: bool = False
    sandwich_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    layer_types: Optional[tuple] = None
    rope_local_theta: Optional[float] = None
    head_dim: Optional[int] = None
    mlp_activation: str = "silu"
    norm_plus_one: bool = False
    scale_embeddings: bool = False
    tie_word_embeddings: bool = False
    quant_method: Optional[str] = None
    quant_group_size: Optional[int] = None

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


# knob -> the plain-Llama value the port supports
_PLAIN = {
    "qkv_bias": False,
    "qk_norm": False,
    "qk_norm_flat": False,
    "norm_after": False,
    "sandwich_norm": False,
    "attn_logit_softcap": None,
    "final_logit_softcap": None,
    "query_pre_attn_scalar": None,
    "layer_types": None,
    "rope_local_theta": None,
    "mlp_activation": "silu",
    "norm_plus_one": False,
    "scale_embeddings": False,
    "quant_method": None,
}


def _check_supported(cfg: LlamaConfig) -> None:
    for knob, plain in _PLAIN.items():
        if getattr(cfg, knob) != plain:
            raise NotImplementedError(
                f"LlamaConfig.{knob}={getattr(cfg, knob)!r} is not ported to accelerate_tpu_torch yet "
                "(plain pre-norm Llama only; the model-zoo knobs are queued in ROADMAP.md)"
            )
    if cfg.attention_impl not in ("auto", "dense"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} needs context parallelism, queued in ROADMAP.md"
        )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # llama order: normalise in f32, cast to the stream dtype, then scale
        var = x.float().square().mean(dim=-1, keepdim=True)
        normed = (x * torch.rsqrt(var + self.eps)).to(x.dtype)
        return normed * self.weight.to(x.dtype)


def rope_frequencies(
    d: int,
    theta: float,
    scaling: Optional[dict] = None,
    *,
    max_pos: Optional[int] = None,
    seq_len: Optional[int] = None,
    orig_max: Optional[int] = None,
    device=None,
) -> tuple[torch.Tensor, float]:
    """``(inverse frequencies [d/2] f32, attention factor)`` with HF-style
    ``rope_scaling`` (default, linear, llama3, yarn, dynamic, longrope):
    the arithmetic of :func:`accelerate_tpu.models.llama.rope_frequencies`."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    if not scaling:
        return freqs, 1.0
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    if rope_type == "default":
        return freqs, 1.0
    if rope_type == "linear":
        return freqs / float(scaling["factor"]), 1.0
    if rope_type == "llama3":
        factor = float(scaling["factor"])
        low_freq_factor = float(scaling.get("low_freq_factor", 1.0))
        high_freq_factor = float(scaling.get("high_freq_factor", 4.0))
        orig = float(scaling.get("original_max_position_embeddings", 8192))
        low_freq_wavelen = orig / low_freq_factor
        high_freq_wavelen = orig / high_freq_factor
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
        smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
        scaled = torch.where(wavelen > low_freq_wavelen, freqs / factor, smoothed)
        return torch.where(wavelen < high_freq_wavelen, freqs, scaled), 1.0
    if rope_type == "yarn":
        factor = float(scaling["factor"])
        orig = float(scaling.get("original_max_position_embeddings") or orig_max or max_pos or 0)
        if not orig:
            raise ValueError("yarn rope_scaling needs original_max_position_embeddings or max_pos")
        attention_factor = scaling.get("attention_factor")
        mscale, mscale_all_dim = scaling.get("mscale"), scaling.get("mscale_all_dim")

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        if attention_factor is None:
            if mscale and mscale_all_dim:
                attention_factor = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
            else:
                attention_factor = get_mscale(factor)
        beta_fast = scaling.get("beta_fast") or 32
        beta_slow = scaling.get("beta_slow") or 1

        def correction_dim(num_rotations):
            return d * math.log(orig / (num_rotations * 2 * math.pi)) / (2 * math.log(theta))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if scaling.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, d - 1)
        if low == high:
            high += 0.001  # HF's singularity guard
        ramp = torch.clip((torch.arange(d // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
        extrapolation_factor = 1.0 - ramp
        inv = freqs / factor * (1 - extrapolation_factor) + freqs * extrapolation_factor
        return inv, float(attention_factor)
    if rope_type == "dynamic":
        factor = float(scaling["factor"])
        orig = float(scaling.get("original_max_position_embeddings") or orig_max or 0)
        if not orig:
            raise ValueError(
                "dynamic rope_scaling needs the ORIGINAL context length — put "
                "original_max_position_embeddings in the rope_scaling dict or set "
                "LlamaConfig.original_max_position_embeddings"
            )
        length = float(max(seq_len or 0, orig))
        base = theta * ((factor * length / orig) - (factor - 1)) ** (d / (d - 2))
        return 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)), 1.0
    if rope_type == "longrope":
        orig = int(scaling.get("original_max_position_embeddings") or orig_max or 0)
        if not orig:
            raise ValueError(
                "longrope rope_scaling needs original_max_position_embeddings — put it in "
                "the rope_scaling dict or set LlamaConfig.original_max_position_embeddings"
            )
        factor = scaling.get("factor")
        if max_pos:
            factor = max_pos / orig
        attention_factor = scaling.get("attention_factor")
        if attention_factor is None:
            attention_factor = (
                1.0 if not factor or factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(orig))
            )
        use_long = seq_len is not None and seq_len > orig
        ext = torch.as_tensor(scaling["long_factor" if use_long else "short_factor"], dtype=torch.float32, device=device)
        return freqs / ext, float(attention_factor)
    raise NotImplementedError(
        f"rope_scaling type {rope_type!r} is not supported "
        "(default/linear/llama3/yarn/longrope/dynamic are); "
        "a silent fallback would mis-rotate every position"
    )


def rope_cos_sin(
    positions: torch.Tensor, d: int, theta: float, scaling: Optional[dict] = None, **kw
) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``cos``/``sin`` ``[B, S, 1, d/2]`` for ``positions [B, S]``
    (attention factor folded in) — computed once per forward and shared
    by every layer."""
    freqs, attn_factor = rope_frequencies(d, theta, scaling, device=positions.device, **kw)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    if attn_factor != 1.0:
        cos, sin = cos * attn_factor, sin * attn_factor
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs ``(x[..., ::2], x[..., 1::2])`` of ``x [B, S, H, D]``."""
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    scaling: Optional[dict] = None,
    *,
    max_pos: Optional[int] = None,
    seq_len: Optional[int] = None,
    orig_max: Optional[int] = None,
) -> torch.Tensor:
    """Rotary embedding over the last dim of ``[B, S, H, D]``."""
    cos, sin = rope_cos_sin(
        positions, x.shape[-1], theta, scaling, max_pos=max_pos, seq_len=seq_len, orig_max=orig_max
    )
    return apply_rope(x, cos, sin)


def _head_dim(cfg: LlamaConfig) -> int:
    return cfg.head_dim or cfg.hidden_size // cfg.num_attention_heads


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        hd = _head_dim(cfg)
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_key_value_heads * hd, bias=False)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_key_value_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, cfg.hidden_size, bias=False)

    def forward(self, hidden, cos, sin, cache=None, layer: int = 0):
        cfg = self.config
        b, s, _ = hidden.shape
        hd = _head_dim(cfg)
        q = apply_rope(self.q_proj(hidden).view(b, s, cfg.num_attention_heads, hd), cos, sin)
        k = apply_rope(self.k_proj(hidden).view(b, s, cfg.num_key_value_heads, hd), cos, sin)
        v = self.v_proj(hidden).view(b, s, cfg.num_key_value_heads, hd)
        if cache is not None:
            out = cached_attention(cache, layer, q, k, v, sliding_window=cfg.sliding_window)
        else:
            out = dot_product_attention(q, k, v, causal=True, window=cfg.sliding_window)
        return self.o_proj(out.reshape(b, s, cfg.num_attention_heads * hd))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, hidden):
        return self.down_proj(F.silu(self.gate_proj(hidden)) * self.up_proj(hidden))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, hidden, cos, sin, cache=None, layer: int = 0):
        hidden = hidden + self.attn(self.input_norm(hidden), cos, sin, cache, layer)
        return hidden + self.mlp(self.post_attn_norm(hidden))


class LlamaModel(nn.Module):
    """``forward(input_ids, positions=None, decode=False, cache=None)``:
    logits ``[B, S, V]`` (f32), or with ``decode=True`` ``(logits,
    cache)``, where ``cache=None`` starts a dense cache of
    ``max_position_embeddings`` rows and a :class:`~..ops.paged_kv.PagedKVCache`
    selects the paged decode path. The cache is updated in place."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _check_supported(cfg)
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([LlamaLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids, positions=None, decode: bool = False, cache=None):
        cfg = self.config
        b, s = input_ids.shape
        hidden = self.embed_tokens(input_ids.long())
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        # longrope picks its table from a static length: the input length
        # for a plain forward, the cache capacity for every cached call
        rope_len = cfg.max_position_embeddings if decode else s
        cos, sin = rope_cos_sin(
            positions, _head_dim(cfg), cfg.rope_theta, cfg.rope_scaling,
            max_pos=cfg.max_position_embeddings, seq_len=rope_len, orig_max=cfg.original_max_position_embeddings,
        )
        if decode and cache is None:
            cache = KVCache.empty(cfg, b, cfg.max_position_embeddings, hidden.dtype, hidden.device)
        for i, layer in enumerate(self.layers):
            hidden = layer(hidden, cos, sin, cache if decode else None, i)
        hidden = self.final_norm(hidden)
        if cfg.tie_word_embeddings:
            logits = hidden.float() @ self.embed_tokens.weight.float().T
        else:
            logits = self.lm_head(hidden.float())  # f32 weight
        if not decode:
            return logits
        cache.advance(s)
        return logits, cache


def create_llama_model(
    config: Optional[LlamaConfig] = None,
    seed: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """A Llama with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for). Projections and the embedding draw
    ``N(0, 1/fan_in)`` from a ``torch.Generator`` seeded with ``seed``;
    norms start at one. Parameters are in ``dtype`` except the LM head,
    kept in f32."""
    config = config or LlamaConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = LlamaModel(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=gen)
    module.to(dtype)
    if not config.tie_word_embeddings:
        module.lm_head.float()
    module.requires_grad_(False)
    module.eval()
    return Model(module, config, name="llama")
