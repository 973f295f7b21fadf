"""Llama-family decoder in PyTorch: RMSNorm, RoPE, GQA, SwiGLU, and the
knobs of the families built on it.

Counterpart of :mod:`accelerate_tpu.models.llama`. The arithmetic follows
the JAX module step for step, so converted weights (:mod:`.convert`) give
the same logits:

* RMSNorm normalises in f32, casts to the stream dtype, then scales; with
  ``norm_plus_one`` (Gemma) it scales by ``1 + w`` in f32 and casts once;
* rotary embedding uses the interleaved pair layout ``x[..., ::2]`` /
  ``x[..., 1::2]`` (not HF's rotate-half), computed in f32;
* the LM head runs in f32 whatever the stream dtype: its weight (kept in
  f32 for serving, rounded to the compute dtype by a mixed-precision train
  step, as the JAX package's cast rounds ``lm_head/kernel``) is widened to
  f32 and so is the stream; a tied head does the same with the embedding
  table;
* in training mode with ``cfg.remat`` each layer is recomputed in the
  backward (``torch.utils.checkpoint``, the JAX module's ``nn.remat``).

The family knobs are the JAX config's, with its rounding points:
``qkv_bias`` (Qwen2), ``qk_norm`` per head and ``qk_norm_flat`` over the
flat projection (Qwen3, OLMo2), ``norm_after`` and ``sandwich_norm``
(OLMo2, Gemma2/3), ``query_pre_attn_scalar``, the attention and final
logit softcaps (Gemma2), ``mlp_activation="gelu_tanh"``,
``scale_embeddings`` (sqrt(hidden) in the stream dtype) and
``layer_types`` with per-layer windows, sliding layers rotating with
``rope_local_theta`` (Gemma2/3). The families themselves are thin configs
in :mod:`.mistral`, :mod:`.qwen2`, :mod:`.qwen3`, :mod:`.olmo2`,
:mod:`.gemma`, :mod:`.gemma2`, :mod:`.gemma3` and :mod:`.phi3`.

:func:`causal_lm_loss` and :func:`next_token_cross_entropy` are the JAX
package's loss, called as ``loss_fn(params, batch)`` through
``Model.apply_fn``.

With ``cfg.quant_method`` set, every block projection is a
:class:`~..ops.qdense.QuantDense` whose parameters are the packed codes
(:func:`quantize_llama_model` makes such a model from a float one).
Otherwise it is a :class:`~..ops.fp8.PolicyLinear` (fp8 products under
``mixed_precision="fp8"``), or, when the model is built under the
delayed-scaling fp8 recipe, an :class:`~..ops.fp8.FP8Dense` whose amax
histories are the model's ``fp8`` state: train it with
:func:`causal_lm_loss_state` through ``build_train_step(...,
has_state=True)``. The histories go into each layer (remat included) as
inputs and come out new beside its output, so a recomputed layer neither
rolls them twice nor quantizes with other scales.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..modeling import Model
from ..ops.attention import dot_product_attention, softcap
from ..ops.fp8 import FP8Dense, PolicyLinear, fp8_recipe
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


def _check_supported(cfg: LlamaConfig) -> None:
    """The JAX module's config checks, and the one path not ported yet."""
    if cfg.attention_impl not in ("auto", "ring", "all_to_all", "dense"):
        raise ValueError(f"attention_impl must be auto|ring|all_to_all|dense, got {cfg.attention_impl!r}")
    if cfg.attention_impl in ("ring", "all_to_all"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} needs context parallelism, queued in ROADMAP.md (Queue 1 item 8)"
        )
    if cfg.mlp_activation not in ("silu", "gelu_tanh"):
        raise ValueError(f"mlp_activation must be silu|gelu_tanh, got {cfg.mlp_activation!r}")
    if cfg.layer_types is not None and cfg.scan_layers:
        raise ValueError(
            "layer_types (per-layer sliding/full attention, Gemma2) requires "
            "scan_layers=False — a scanned block shares one static config"
        )
    if cfg.layer_types is not None and len(cfg.layer_types) != cfg.num_hidden_layers:
        raise ValueError(f"layer_types has {len(cfg.layer_types)} entries for {cfg.num_hidden_layers} layers")


class RMSNorm(nn.Module):
    """RMS normalisation over the last dim. ``plus_one`` (Gemma) keeps a
    zero-centred weight applied as ``1 + w``, normalising and scaling in
    f32 and casting once; otherwise the llama order: normalise in f32, cast
    to the stream dtype, then scale."""

    def __init__(self, dim: int, eps: float = 1e-5, plus_one: bool = False):
        super().__init__()
        self.eps = eps
        self.plus_one = plus_one
        self.weight = nn.Parameter(torch.zeros(dim) if plus_one else torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        if self.plus_one:
            return (x.float() * torch.rsqrt(var + self.eps) * (1.0 + self.weight.float())).to(x.dtype)
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


def _proj(cfg: LlamaConfig, in_features: int, features: int, bias: bool = False) -> nn.Module:
    """Block projection factory: a ``QuantDense`` when the config carries a
    weight-only quantization method (it computes in the stream dtype), an
    ``FP8Dense`` when the active precision policy asks for the
    delayed-scaling fp8 recipe, else a ``PolicyLinear`` (bias-free unless
    asked)."""
    if cfg.quant_method is not None:
        from ..ops.qdense import QuantDense

        return QuantDense(
            in_features, features, method=cfg.quant_method, group_size=cfg.quant_group_size, use_bias=bias
        )
    recipe = fp8_recipe()
    if recipe is not None and recipe.delayed_scaling:
        if bias:
            raise NotImplementedError("FP8Dense (delayed scaling) has no bias; qkv_bias models need the bf16 path")
        return FP8Dense(
            in_features, features, amax_history_len=recipe.amax_history_len,
            amax_compute_algo=recipe.amax_compute_algo, margin=recipe.margin,
        )
    return PolicyLinear(in_features, features, bias=bias)


def _project(proj: nn.Module, x: torch.Tensor, fp8: Optional[dict], new: dict, name: str) -> torch.Tensor:
    """``proj(x)``; an ``FP8Dense`` reads its histories from ``fp8[name]``
    (None: its buffers) and leaves the new ones in ``new[name]``."""
    if not isinstance(proj, FP8Dense):
        return proj(x)
    y, new[name] = proj(x, None if fp8 is None else fp8[name])
    return y


def _norm(cfg: LlamaConfig, dim: int) -> RMSNorm:
    return RMSNorm(dim, cfg.rms_norm_eps, cfg.norm_plus_one)


def _layer_kinds(cfg: LlamaConfig) -> list[tuple[Optional[int], bool]]:
    """Per layer ``(window, local rope)``: with ``layer_types`` the band is
    on the ``"sliding_attention"`` layers only, which rotate with
    ``rope_local_theta`` (and no scaling) when it is set; without it every
    layer takes ``sliding_window`` and the global rope."""
    if cfg.layer_types is None:
        return [(cfg.sliding_window, False)] * cfg.num_hidden_layers
    kinds = []
    for kind in cfg.layer_types:
        windowed = kind == "sliding_attention"
        kinds.append((cfg.sliding_window if windowed else None, windowed and cfg.rope_local_theta is not None))
    return kinds


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, window: Optional[int] = None):
        super().__init__()
        self.config = cfg
        self.window = window
        hd = _head_dim(cfg)
        self.q_proj = _proj(cfg, cfg.hidden_size, cfg.num_attention_heads * hd, cfg.qkv_bias)
        self.k_proj = _proj(cfg, cfg.hidden_size, cfg.num_key_value_heads * hd, cfg.qkv_bias)
        self.v_proj = _proj(cfg, cfg.hidden_size, cfg.num_key_value_heads * hd, cfg.qkv_bias)
        self.o_proj = _proj(cfg, cfg.num_attention_heads * hd, cfg.hidden_size)
        if cfg.qk_norm_flat:  # OLMo2: over the flat projection, all heads jointly
            self.q_norm = _norm(cfg, cfg.num_attention_heads * hd)
            self.k_norm = _norm(cfg, cfg.num_key_value_heads * hd)
        elif cfg.qk_norm:  # Qwen3, Gemma3: one [head_dim] scale shared by the heads
            self.q_norm = _norm(cfg, hd)
            self.k_norm = _norm(cfg, hd)

    def forward(self, hidden, cos, sin, cache=None, layer: int = 0, fp8=None, new=None):
        cfg = self.config
        b, s, _ = hidden.shape
        hd = _head_dim(cfg)
        new = {} if new is None else new
        q, k, v = (_project(getattr(self, n), hidden, fp8, new, n) for n in ("q_proj", "k_proj", "v_proj"))
        if cfg.qk_norm_flat:
            q, k = self.q_norm(q), self.k_norm(k)
        q = q.view(b, s, cfg.num_attention_heads, hd)
        k = k.view(b, s, cfg.num_key_value_heads, hd)
        v = v.view(b, s, cfg.num_key_value_heads, hd)
        if cfg.qk_norm and not cfg.qk_norm_flat:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        scale = None if cfg.query_pre_attn_scalar is None else float(cfg.query_pre_attn_scalar) ** -0.5
        if cache is not None:
            out = cached_attention(
                cache, layer, q, k, v, scale=scale, sliding_window=self.window, logit_softcap=cfg.attn_logit_softcap
            )
        else:
            out = dot_product_attention(
                q, k, v, causal=True, scale=scale, window=self.window, logit_softcap=cfg.attn_logit_softcap
            )
        return _project(self.o_proj, out.reshape(b, s, cfg.num_attention_heads * hd), fp8, new, "o_proj")


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gelu = cfg.mlp_activation == "gelu_tanh"
        self.gate_proj = _proj(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = _proj(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = _proj(cfg, cfg.intermediate_size, cfg.hidden_size)

    def forward(self, hidden, fp8=None, new=None):
        new = {} if new is None else new
        gate = _project(self.gate_proj, hidden, fp8, new, "gate_proj")
        act = F.gelu(gate, approximate="tanh") if self.gelu else F.silu(gate)
        return _project(self.down_proj, act * _project(self.up_proj, hidden, fp8, new, "up_proj"), fp8, new,
                        "down_proj")


class LlamaLayer(nn.Module):
    """One block, in the config's norm layout: pre-norm (``input_norm``
    before attention, ``post_attn_norm`` before the MLP), ``norm_after``
    (``post_attn_norm`` / ``post_ffn_norm`` on each sublayer's output, no
    input norms) or ``sandwich_norm`` (``input_norm`` / ``post_attn_norm``
    around attention, ``pre_ffn_norm`` / ``post_ffn_norm`` around the MLP).
    ``local_rope`` picks the sliding layers' rotary table."""

    def __init__(self, cfg: LlamaConfig, window: Optional[int] = None, local_rope: bool = False):
        super().__init__()
        self.layout = "after" if cfg.norm_after else "sandwich" if cfg.sandwich_norm else "pre"
        self.local_rope = local_rope
        if self.layout != "after":
            self.input_norm = _norm(cfg, cfg.hidden_size)
        self.attn = LlamaAttention(cfg, window)
        self.post_attn_norm = _norm(cfg, cfg.hidden_size)
        if self.layout == "sandwich":
            self.pre_ffn_norm = _norm(cfg, cfg.hidden_size)
        if self.layout != "pre":
            self.post_ffn_norm = _norm(cfg, cfg.hidden_size)
        self.mlp = LlamaMLP(cfg)

    def forward(self, hidden, cos, sin, cache=None, layer: int = 0, fp8=None):
        """The new hidden state; with ``fp8`` (this layer's amax histories,
        ``{"attn": {...}, "mlp": {...}}``) ``(hidden, new histories)``."""
        new = {"attn": {}, "mlp": {}}
        hist = fp8 or {}

        def attn(x):
            return self.attn(x, cos, sin, cache, layer, hist.get("attn"), new["attn"])

        def mlp(x):
            return self.mlp(x, hist.get("mlp"), new["mlp"])

        if self.layout == "after":
            hidden = hidden + self.post_attn_norm(attn(hidden))
            hidden = hidden + self.post_ffn_norm(mlp(hidden))
        elif self.layout == "sandwich":
            hidden = hidden + self.post_attn_norm(attn(self.input_norm(hidden)))
            hidden = hidden + self.post_ffn_norm(mlp(self.pre_ffn_norm(hidden)))
        else:
            hidden = hidden + attn(self.input_norm(hidden))
            hidden = hidden + mlp(self.post_attn_norm(hidden))
        return hidden if fp8 is None else (hidden, new)


class LlamaModel(nn.Module):
    """``forward(input_ids, positions=None, decode=False, cache=None,
    state=None)``: logits ``[B, S, V]`` (f32), or with ``decode=True``
    ``(logits, cache)``, where ``cache=None`` starts a dense cache of
    ``max_position_embeddings`` rows and a :class:`~..ops.paged_kv.PagedKVCache`
    selects the paged decode path. The cache is updated in place.

    Built under the delayed fp8 recipe, the model keeps mutable state, the
    ``fp8`` collection of amax histories (``state_collection``). Passing
    ``state`` (``{"fp8": ...}``, as :attr:`~..modeling.Model.state` holds
    it) to a forward that is not a decode returns ``(logits,
    new_state)``; without it the layers read their own buffers and the new
    histories are dropped, as a decode drops them."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _check_supported(cfg)
        self.config = cfg
        # the table is drawn by create_llama_model (or loaded): handing nn.Embedding its storage skips its own
        # init, which on a meta tensor imports torch._dynamo (6.4 s of a process's first build on the H100 host)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         _weight=torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList([LlamaLayer(cfg, *kind) for kind in _layer_kinds(cfg)])
        self.final_norm = _norm(cfg, cfg.hidden_size)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        if any(isinstance(m, FP8Dense) for m in self.modules()):
            self.state_collection = "fp8"

    def forward(self, input_ids, positions=None, decode: bool = False, cache=None, state=None):
        cfg = self.config
        b, s = input_ids.shape
        hidden = self.embed_tokens(input_ids.long())
        if cfg.scale_embeddings:  # sqrt(hidden), rounded to the stream dtype first (the JAX module's order)
            hidden = hidden * torch.tensor(cfg.hidden_size**0.5, dtype=hidden.dtype, device=hidden.device)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        # longrope picks its table from a static length: the input length
        # for a plain forward, the cache capacity for every cached call
        rope_kw = dict(
            max_pos=cfg.max_position_embeddings, seq_len=cfg.max_position_embeddings if decode else s,
            orig_max=cfg.original_max_position_embeddings,
        )
        tables = {False: rope_cos_sin(positions, _head_dim(cfg), cfg.rope_theta, cfg.rope_scaling, **rope_kw)}
        if any(layer.local_rope for layer in self.layers):
            tables[True] = rope_cos_sin(positions, _head_dim(cfg), cfg.rope_local_theta, None, **rope_kw)
        if decode and cache is None:
            cache = KVCache.empty(cfg, b, cfg.max_position_embeddings, hidden.dtype, hidden.device)
        remat = cfg.remat and self.training and not decode and torch.is_grad_enabled()
        threaded = state is not None and not decode and hasattr(self, "state_collection")
        hists = state[self.state_collection]["layers"] if threaded else None
        new_hists = {}
        for i, layer in enumerate(self.layers):
            cos, sin = tables[layer.local_rope]
            if threaded:
                if remat:
                    hidden, new_hists[str(i)] = _remat_layer(layer, hidden, cos, sin, hists[str(i)])
                else:
                    hidden, new_hists[str(i)] = layer(hidden, cos, sin, None, i, hists[str(i)])
            elif remat:
                hidden = _remat_layer(layer, hidden, cos, sin)
            else:
                hidden = layer(hidden, cos, sin, cache if decode else None, i)
        hidden = self.final_norm(hidden)
        head = self.embed_tokens.weight if cfg.tie_word_embeddings else self.lm_head.weight
        logits = hidden.float() @ head.float().T
        if cfg.final_logit_softcap is not None:
            logits = softcap(logits, cfg.final_logit_softcap)
        if not decode:
            if state is None:
                return logits
            return logits, ({self.state_collection: {"layers": new_hists}} if threaded else state)
        cache.advance(s)
        return logits, cache


def _remat_layer(layer: LlamaLayer, hidden, cos, sin, fp8=None):
    """``layer(hidden, cos, sin)`` with its activations recomputed in the
    backward. The layer's current parameter tensors are passed in as inputs
    and bound again for the recompute: under ``Model.apply_fn`` they are
    the compute-dtype copies, which ``functional_call`` has unbound again
    by the time the backward runs. With ``fp8`` (the layer's amax
    histories) it returns ``(hidden, new histories)``: the recompute reads
    the same input histories, so it quantizes with the forward's scales,
    and its own new histories are dropped."""
    names, tensors = zip(*layer.named_parameters())

    def run(hidden, cos, sin, fp8, *tensors):
        return functional_call(layer, dict(zip(names, tensors)), (hidden, cos, sin), {"fp8": fp8})

    return checkpoint(run, hidden, cos, sin, fp8, *tensors, use_reentrant=False)


def create_llama_model(
    config: Optional[LlamaConfig] = None,
    seed: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """A Llama with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for). Projections and the embedding draw
    ``N(0, 1/fan_in)`` from a ``torch.Generator`` seeded with ``seed``.
    Parameters are in ``dtype`` except the LM head,
    kept in f32. Norms start at the identity (one, or zero offsets under
    ``norm_plus_one``) and biases at zero, as the JAX module's initialisers
    do. With ``config.quant_method`` set the projections start as
    the reference's do, zero codes and unit f32 scales: real values come
    from :func:`quantize_llama_model` or a state dict."""
    config = config or LlamaConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = LlamaModel(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for b in module.buffers():  # the fp8 amax histories start at zero
            b.zero_()
        for name, p in module.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(0.0 if config.norm_plus_one else 1.0)
            elif name.endswith((".qscale", "_proj.bias")):
                p.fill_(1.0 if name.endswith(".qscale") else 0.0)
            elif name.endswith(".qdata"):
                p.zero_()
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=gen)
            if name.startswith("lm_head"):
                p.data = p.data.to(dtype).float()  # f32 storage of values drawn at the stream's precision
            elif p.is_floating_point() and not name.endswith(".qscale"):
                p.data = p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()
    return Model(module, config, name="llama")


_PROJ_WEIGHT_RE = re.compile(r"^(.*\.(?:q|k|v|o|gate|up|down)_proj)\.weight$")


@torch.no_grad()
def quantize_llama_model(model: Model, qconfig=None) -> Model:
    """Weight-only quantize every block projection of a llama
    :class:`Model` into :class:`~..ops.qdense.QuantDense` parameters; the
    packed codes are the new model's weights. The other parameters
    (embedding, norms, LM head) are shared with ``model``, not copied, and
    the new model lives on ``model``'s device."""
    from ..utils.quantization import QuantizationConfig, quantize

    qcfg = qconfig or QuantizationConfig()
    if model.config.quant_method is not None:
        # quantizing again would reinterpret the packed codes under the new decoder
        raise ValueError(
            f"model is already quantized ({model.config.quant_method}); "
            "quantize the original float model instead"
        )
    new_cfg = dataclasses.replace(model.config, quant_method=qcfg.method, quant_group_size=qcfg.group_size)
    with torch.device("meta"):
        module = LlamaModel(new_cfg)
    state = {}
    for name, p in model.module.named_parameters():
        match = _PROJ_WEIGHT_RE.match(name)
        if match is None:
            state[name] = p.detach()
        else:  # nn.Linear keeps [out, in]; the codes group the contraction dim of [in, out]
            qt = quantize(p.detach().T, qcfg)
            state[f"{match.group(1)}.qdata"], state[f"{match.group(1)}.qscale"] = qt.data, qt.scale
    module.load_state_dict(state, strict=True, assign=True)
    module.requires_grad_(False)
    module.eval()
    return Model(module, new_cfg, name=model.name)


def causal_lm_loss(params: dict, batch: dict, apply_fn) -> torch.Tensor:
    """Next-token cross entropy; labels are the input shifted left and
    padding is masked by ``loss_mask``. When labels are derived from the
    input, the last position (whose target would be made up) is masked."""
    return next_token_cross_entropy(apply_fn(params, batch["input_ids"]), batch)


def causal_lm_loss_state(params: dict, state: dict, batch: dict, apply_fn):
    """:func:`causal_lm_loss` for a model with mutable state (the delayed
    fp8 recipe's amax histories): the ``build_train_step(has_state=True)``
    contract, ``(loss, new_state)``."""
    logits, new_state = apply_fn(params, batch["input_ids"], state=state)
    return next_token_cross_entropy(logits, batch), new_state


def next_token_cross_entropy(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The cross-entropy part of :func:`causal_lm_loss`: log-softmax in f32,
    the masked mean of the negative log-likelihood."""
    mask = batch.get("loss_mask")
    if "labels" in batch:
        labels = batch["labels"]
    else:
        ids = batch["input_ids"]
        labels = F.pad(ids[:, 1:], (0, 1))
        last = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
        last[:, -1] = True
        keep = torch.ones(labels.shape, device=labels.device) if mask is None else mask.float()
        mask = torch.where(last, torch.zeros_like(keep), keep)
    nll = F.cross_entropy(logits.float().flatten(0, -2), labels.long().flatten(), reduction="none")
    nll = nll.view(labels.shape)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
