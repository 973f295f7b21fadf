"""T5 encoder-decoder in PyTorch: the relative position bias, RMS-style
LayerNorm, a ReLU FFN and cross-attention.

Counterpart of :mod:`accelerate_tpu.models.t5`, with its arithmetic:

* the relative bias table lives only in layer 0's attention of each stack
  (``relative_bias``, ``[num_buckets, heads]``); layer 0 computes the
  ``[1, H, Q, K]`` f32 bias and hands it to every later layer, and
  cross-attention carries none;
* the bucket ids are T5's log bins (:func:`_bucketize`), truncated from an
  f32 quotient that lands exactly on a bin edge at some distances, so a
  one-ulp difference in ``log`` or in a division would move a bucket:
  :func:`relative_position_buckets` computes them on the host, where the
  CPU's result is the reference's, and moves the finished ids to the
  device;
* scores are not scaled by ``1/sqrt(D)``; the bias is added to the f32
  scores, padding and the causal mask replace masked scores with
  ``finfo(f32).min`` (a fully masked row softmaxes to uniform weights,
  not NaN), and the weights are cast to the stream dtype before P.V;
* every projection is a :class:`~..ops.fp8.PolicyLinear` without a bias
  (the reference's ``policy_dot_general()``: fp8 products under
  ``mixed_precision="fp8"``), the norms are :class:`~.llama.RMSNorm`;
* the tied head scales the decoder output by ``hidden_size**-0.5`` in the
  stream dtype, then multiplies in f32; an untied ``lm_head`` is kept in
  f32.

``forward(input_ids, decoder_input_ids, attention_mask=None, decode=False,
cache=None)``: logits ``[B, S_dec, V]`` (f32), or with ``decode=True``
``(logits, cache)`` over a :class:`~..ops.kv_cache.Seq2SeqCache`. With
``cache=None`` the encoder runs, its output is stored in f32 beside the
mask, and every layer's cross-attention K/V is projected once and stored
in f32 (the prefill); a call with a cache skips the encoder and the
cross projections, and its decoder self-attention adds the bias over
absolute positions (the cache index plus the step) through
:func:`~..ops.kv_cache.cached_attention`'s ``bias_fn``. ``generate_seq2seq``
drives it. Weights cross from the JAX package through
:func:`~.convert.t5_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..modeling import Model
from ..ops.fp8 import PolicyLinear
from ..ops.kv_cache import Seq2SeqCache, cached_attention, cached_cross_kv
from ..utils.environment import resolve_device
from .gpt2 import _init, remat_block
from .llama import RMSNorm


@dataclasses.dataclass
class T5Config:
    """A copy of :class:`accelerate_tpu.models.t5.T5Config` (same fields and
    defaults)."""

    vocab_size: int = 32128
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 6  # per stack (encoder and decoder)
    num_attention_heads: int = 8
    head_dim: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    remat: bool = False
    # decoder KV-cache length for incremental generation
    max_decode_len: int = 128

    @classmethod
    def small(cls, **kw) -> "T5Config":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("head_dim", 16)
        return cls(**kw)


def _bucketize(rel: torch.Tensor, num_buckets: int, max_distance: int, bidirectional: bool) -> torch.Tensor:
    """T5's log-binned bucket of each relative position ``rel = key_pos -
    query_pos`` (an integer tensor), computed where ``rel`` lies: the
    reference's formula, its quotient in f32 truncated to int32."""
    buckets = 0
    if bidirectional:
        num_buckets //= 2
        buckets = torch.where(rel > 0, num_buckets, 0)
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    scaled = (
        torch.log(torch.clamp(rel, min=1).float() / max_exact)
        / float(np.log(max_distance / max_exact))
        * (num_buckets - max_exact)
    )
    log_bucket = torch.clamp(max_exact + scaled.to(torch.int32), max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, log_bucket)


@functools.lru_cache(maxsize=32)
def relative_position_buckets(
    q_len: int, k_len: int, num_buckets: int, max_distance: int, bidirectional: bool, device="cpu"
) -> torch.Tensor:
    """Bucket ids ``[q_len, k_len]`` of ``key_pos - query_pos``, int64,
    computed on the host and moved to ``device`` once (the result is kept:
    they depend only on the shapes)."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    return _bucketize(rel, num_buckets, max_distance, bidirectional).long().to(device)


class T5Attention(nn.Module):
    """Self- or cross-attention without biases; layer 0's self-attention
    holds the relative bias table."""

    def __init__(self, cfg: T5Config, causal: bool = False, has_relative_bias: bool = False):
        super().__init__()
        self.config = cfg
        self.causal = causal
        self.has_relative_bias = has_relative_bias
        inner = cfg.num_attention_heads * cfg.head_dim
        self.q_proj, self.k_proj, self.v_proj = (PolicyLinear(cfg.hidden_size, inner, bias=False) for _ in range(3))
        self.o_proj = PolicyLinear(inner, cfg.hidden_size, bias=False)
        if has_relative_bias:
            self.relative_bias = nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_attention_heads))

    def _bias(self, buckets: torch.Tensor) -> torch.Tensor:
        return self.relative_bias[buckets].permute(2, 0, 1)[None].float()

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(*x.shape[:-1], self.config.num_attention_heads, self.config.head_dim)

    def forward(self, hidden, kv=None, mask=None, position_bias=None, cache: Optional[Seq2SeqCache] = None,
                layer: int = 0, prime: bool = True):
        """Returns ``(out, position_bias)``. With a ``cache``, causal
        self-attention goes through the decoder cache and cross-attention
        reads the stored K/V (projected from ``kv`` only when ``prime``)."""
        cfg = self.config
        b, s, _ = hidden.shape
        q = self._split(self.q_proj(hidden))
        if cache is not None and not self.causal:
            k, v = cached_cross_kv(cache, layer, lambda: self._split(self.k_proj(kv)),
                                   lambda: self._split(self.v_proj(kv)), prime)
            k, v = k.to(q.dtype), v.to(q.dtype)
        else:
            src = hidden if kv is None else kv
            k, v = self._split(self.k_proj(src)), self._split(self.v_proj(src))

        if cache is not None and self.causal:
            out, position_bias = self._cached_causal(q, k, v, position_bias, cache, layer)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
            if position_bias is None and self.has_relative_bias:
                buckets = relative_position_buckets(
                    q.shape[1], k.shape[1], cfg.relative_attention_num_buckets,
                    cfg.relative_attention_max_distance, not self.causal, q.device,
                )
                position_bias = self._bias(buckets)
            if position_bias is not None:
                logits = logits + position_bias
            low = torch.finfo(torch.float32).min
            if self.causal:
                live = torch.arange(q.shape[1], device=q.device)[:, None] >= torch.arange(k.shape[1], device=q.device)
                logits = logits.masked_fill(~live, low)
            if mask is not None:
                logits = logits.masked_fill(~mask[:, None, None, :], low)
            weights = torch.softmax(logits, dim=-1).to(hidden.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.o_proj(out.reshape(b, s, -1)), position_bias

    def _cached_causal(self, q, k, v, position_bias, cache: Seq2SeqCache, layer: int):
        """Incremental self-attention: ``scale=1.0`` and, in layer 0, the
        relative bias over absolute positions, read from the host-built
        ``[max_len, max_len]`` bucket ids at the queries' rows."""
        cfg = self.config
        computed = {"bias": position_bias}

        def bias_fn(q_pos, key_pos):
            if computed["bias"] is None and self.has_relative_bias:
                max_len = cache.self_kv.key.shape[2]
                table = relative_position_buckets(max_len, max_len, cfg.relative_attention_num_buckets,
                                                  cfg.relative_attention_max_distance, False, q_pos.device)
                computed["bias"] = self._bias(table[q_pos][:, key_pos])
            return computed["bias"]

        out = cached_attention(cache.self_kv, layer, q, k, v, scale=1.0, bias_fn=bias_fn)
        return out, computed["bias"]


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi = PolicyLinear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.wo = PolicyLinear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, hidden):
        return self.wo(F.relu(self.wi(hidden)))


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.attn = T5Attention(cfg, causal=False, has_relative_bias=has_relative_bias)
        self.ln_ffn = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn = T5FFN(cfg)

    def forward(self, hidden, mask, position_bias=None):
        attn_out, position_bias = self.attn(self.ln_attn(hidden), mask=mask, position_bias=position_bias)
        hidden = hidden + attn_out
        return hidden + self.ffn(self.ln_ffn(hidden)), position_bias


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.ln_self = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = T5Attention(cfg, causal=True, has_relative_bias=has_relative_bias)
        self.ln_cross = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.cross_attn = T5Attention(cfg, causal=False)
        self.ln_ffn = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn = T5FFN(cfg)

    def forward(self, hidden, enc_out, enc_mask, position_bias=None, cache=None, layer: int = 0, prime: bool = True):
        self_out, position_bias = self.self_attn(self.ln_self(hidden), position_bias=position_bias, cache=cache,
                                                 layer=layer)
        hidden = hidden + self_out
        cross_out, _ = self.cross_attn(self.ln_cross(hidden), kv=enc_out, mask=enc_mask, cache=cache, layer=layer,
                                       prime=prime)
        hidden = hidden + cross_out
        return hidden + self.ffn(self.ln_ffn(hidden)), position_bias


class T5Model(nn.Module):
    """``forward(input_ids, decoder_input_ids, attention_mask=None,
    decode=False, cache=None)``; :meth:`encode` runs the encoder stack
    alone."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.enc_layers = nn.ModuleList([T5EncoderLayer(cfg, i == 0) for i in range(cfg.num_layers)])
        self.enc_final_norm = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dec_layers = nn.ModuleList([T5DecoderLayer(cfg, i == 0) for i in range(cfg.num_layers)])
        self.dec_final_norm = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def _remat(self, decode: bool) -> bool:
        return self.config.remat and self.training and not decode and torch.is_grad_enabled()

    def encode(self, input_ids, attention_mask, remat: bool = False) -> torch.Tensor:
        """The encoder stack's output ``[B, S, hidden]`` in the stream dtype
        (layer 0 computes the bidirectional bias, the rest reuse it)."""
        hidden = self.shared(input_ids.long())
        bias = None
        for layer in self.enc_layers:
            hidden, bias = remat_block(layer, hidden, attention_mask, bias) if remat else layer(
                hidden, attention_mask, bias)
        return self.enc_final_norm(hidden)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None, decode: bool = False, cache=None):
        cfg = self.config
        remat = self._remat(decode)
        dtype = self.shared.weight.dtype
        prime = cache is None
        enc_out = None
        if not decode or prime:
            if attention_mask is None:
                attention_mask = torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device)
            attention_mask = attention_mask.bool()
            enc_out = self.encode(input_ids, attention_mask, remat)
        if decode:
            if prime:
                cache = Seq2SeqCache.start(cfg, enc_out, attention_mask, cfg.max_decode_len, dtype)
                enc_out = cache.enc_out.to(dtype)  # the stored f32 output, cast back as the reference reads it
            attention_mask = cache.enc_mask

        hidden = self.shared(decoder_input_ids.long())
        bias = None
        for i, layer in enumerate(self.dec_layers):
            if remat:
                hidden, bias = remat_block(layer, hidden, enc_out, attention_mask, bias)
            else:
                hidden, bias = layer(hidden, enc_out, attention_mask, bias, cache if decode else None, i, prime)
        hidden = self.dec_final_norm(hidden)
        if cfg.tie_word_embeddings:
            logits = (hidden * cfg.hidden_size**-0.5).float() @ self.shared.weight.float().T
        else:
            logits = hidden.float() @ self.lm_head.weight.float().T
        if not decode:
            return logits
        cache.advance(decoder_input_ids.shape[1])
        return logits, cache


def create_t5_model(
    config: Optional[T5Config] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A T5 with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), in ``dtype`` but for an untied ``lm_head``,
    kept in f32 (a tied head is the shared embedding)."""
    config = config or T5Config.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = T5Model(config)
    module.to_empty(device=dev)
    _init(module, dtype, seed, dev, "lm_head")
    return Model(module, config, name="t5")


def seq2seq_lm_loss(params, batch, apply_fn):
    """Teacher-forced seq2seq cross entropy, the reference's: the decoder
    input is ``decoder_input_ids``, or the labels shifted right with a 0
    start (and 0 for a ``-100`` that shifts in); positions whose label is
    ``-100`` or whose ``decoder_loss_mask`` is 0 are left out of the mean."""
    labels = batch["labels"]
    dec_in = batch.get("decoder_input_ids")
    if dec_in is None:
        dec_in = F.pad(labels[:, :-1], (1, 0))
        dec_in = torch.where(dec_in == -100, 0, dec_in)
    logits = apply_fn(params, batch["input_ids"], dec_in, batch.get("attention_mask"))
    mask = (labels != -100).float()
    if "decoder_loss_mask" in batch:
        mask = mask * batch["decoder_loss_mask"].float()
    safe = torch.where(labels == -100, 0, labels).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
