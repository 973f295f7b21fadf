"""Whisper-style speech encoder-decoder in PyTorch: a convolutional front
end over log-mel features, fixed sinusoidal encoder positions, learned
decoder positions, pre-LayerNorm blocks and cached incremental decoding.

Counterpart of :mod:`accelerate_tpu.models.whisper`, with its arithmetic:

* ``input_features`` are feature-last, ``[B, frames, num_mel_bins]``;
  ``conv1`` (3 taps, pad 1) and ``conv2`` (3 taps, stride 2, pad 1), each
  followed by exact-erf GELU, give ``(frames + 1) // 2`` encoder
  positions;
* every dense layer and convolution computes in the dtype of the stream
  it belongs to (flax's ``dtype=``): the encoder in the features' dtype,
  the decoder in the embedding's; cross-attention's K/V projections take
  the decoder's dtype, or at the prefill the dtype of the stored encoder
  output cast back to the embedding's;
* q, v and out projections carry a bias, k does not;
* LayerNorm statistics are f32 (:class:`~.gpt2.LayerNorm`);
* the encoder positions are :func:`sinusoids`, a constant (a
  non-persistent buffer, never a parameter); the decoder's table
  ``dec_pos`` is learned and read at the decoder's absolute positions;
* the head is the tied embedding, in f32.

Past ``max_target_positions`` the JAX package's gather clamps to the last
row; the port raises ``ValueError`` naming the limit instead.

``forward(input_features, decoder_input_ids, attention_mask=None,
decode=False, cache=None)`` is :class:`~.t5.T5Model`'s contract (the mask
is accepted and unused, as in the reference): with ``decode=True`` and
``cache=None`` the encoder runs once, its output is stored in f32 and
every layer's cross K/V is projected once; later calls read them from the
:class:`~..ops.kv_cache.Seq2SeqCache`, whose write index is the decoder
position (the reference's ``dec_pos``). Weights cross from the JAX
package through :func:`~.convert.whisper_params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..ops.kv_cache import Seq2SeqCache, cached_attention, cached_cross_kv
from ..utils.environment import resolve_device
from .gpt2 import LayerNorm


@dataclasses.dataclass
class WhisperConfig:
    """A copy of :class:`accelerate_tpu.models.whisper.WhisperConfig` (same
    fields, defaults and refusal)."""

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5
    max_decode_len: int = 128

    def __post_init__(self):
        if self.max_decode_len > self.max_target_positions:
            raise ValueError(
                f"max_decode_len ({self.max_decode_len}) exceeds max_target_positions "
                f"({self.max_target_positions})"
            )

    @classmethod
    def tiny(cls, **kw) -> "WhisperConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("num_mel_bins", 8)
        kw.setdefault("d_model", 32)
        kw.setdefault("encoder_layers", 2)
        kw.setdefault("decoder_layers", 2)
        kw.setdefault("encoder_attention_heads", 4)
        kw.setdefault("decoder_attention_heads", 4)
        kw.setdefault("encoder_ffn_dim", 64)
        kw.setdefault("decoder_ffn_dim", 64)
        kw.setdefault("max_source_positions", 32)
        kw.setdefault("max_target_positions", 32)
        kw.setdefault("max_decode_len", 32)
        return cls(**kw)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal table: ``[length, channels]`` f32, sin |
    cos halves over log-spaced timescales."""
    if channels % 2 != 0:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with the input, the weight and the bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class WhisperAttention(nn.Module):
    """Multi-head attention with Whisper's biases: the einsum path without
    a cache, the decoder cache for causal decode, the stored cross K/V for
    cross-attention in decode."""

    def __init__(self, d_model: int, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(*x.shape[:-1], self.num_heads, x.shape[-1] // self.num_heads)

    def forward(self, hidden, kv=None, cache: Optional[Seq2SeqCache] = None, layer: int = 0, prime: bool = True):
        dtype = hidden.dtype
        b, s, width = hidden.shape
        q = self._split(_dense(self.q_proj, hidden, dtype))
        if cache is not None and not self.causal:
            k, v = cached_cross_kv(cache, layer, lambda: self._split(_dense(self.k_proj, kv, kv.dtype)),
                                   lambda: self._split(_dense(self.v_proj, kv, kv.dtype)), prime)
            k, v = k.to(q.dtype), v.to(q.dtype)
        else:
            src = hidden if kv is None else kv
            k, v = self._split(_dense(self.k_proj, src, dtype)), self._split(_dense(self.v_proj, src, dtype))
        if cache is not None and self.causal:
            out = cached_attention(cache.self_kv, layer, q, k, v)
        else:
            out = dot_product_attention(q, k, v, causal=self.causal)
        return _dense(self.out_proj, out.reshape(b, s, width), dtype)


def _ffn(layer: nn.Module, hidden: torch.Tensor) -> torch.Tensor:
    """``fc2(gelu(fc1(hidden)))`` of ``layer``, exact-erf GELU."""
    return _dense(layer.fc2, F.gelu(_dense(layer.fc1, hidden, hidden.dtype)), hidden.dtype)


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.ln_self = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.self_attn = WhisperAttention(cfg.d_model, cfg.encoder_attention_heads)
        self.ln_ffn = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.d_model, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, cfg.d_model)

    def forward(self, hidden):
        hidden = hidden + self.self_attn(self.ln_self(hidden))
        return hidden + _ffn(self, self.ln_ffn(hidden))


class WhisperDecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.ln_self = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.self_attn = WhisperAttention(cfg.d_model, cfg.decoder_attention_heads, causal=True)
        self.ln_cross = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.cross_attn = WhisperAttention(cfg.d_model, cfg.decoder_attention_heads)
        self.ln_ffn = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.d_model, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, cfg.d_model)

    def forward(self, hidden, enc_out, cache=None, layer: int = 0, prime: bool = True):
        hidden = hidden + self.self_attn(self.ln_self(hidden), cache=cache, layer=layer)
        hidden = hidden + self.cross_attn(self.ln_cross(hidden), kv=enc_out, cache=cache, layer=layer, prime=prime)
        return hidden + _ffn(self, self.ln_ffn(hidden))


class WhisperModel(nn.Module):
    """``forward(input_features, decoder_input_ids, attention_mask=None,
    decode=False, cache=None)``; :meth:`encode` runs the front end and the
    encoder stack alone."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.config = cfg
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        self.register_buffer("enc_pos", torch.empty(cfg.max_source_positions, cfg.d_model), persistent=False)
        self.enc_layers = nn.ModuleList([WhisperEncoderLayer(cfg) for _ in range(cfg.encoder_layers)])
        self.enc_final_norm = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.dec_pos = nn.Parameter(torch.empty(cfg.max_target_positions, cfg.d_model))
        self.dec_layers = nn.ModuleList([WhisperDecoderLayer(cfg) for _ in range(cfg.decoder_layers)])
        self.dec_final_norm = LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)

    def encode(self, input_features: torch.Tensor) -> torch.Tensor:
        """The encoder's output ``[B, (frames + 1) // 2, d_model]`` in the
        features' dtype."""
        cfg, dtype = self.config, input_features.dtype
        x = input_features.transpose(1, 2)
        x = F.gelu(F.conv1d(x, self.conv1.weight.to(dtype), self.conv1.bias.to(dtype), padding=1))
        x = F.gelu(F.conv1d(x, self.conv2.weight.to(dtype), self.conv2.bias.to(dtype), stride=2, padding=1))
        x = x.transpose(1, 2)
        if x.shape[1] > cfg.max_source_positions:
            raise ValueError(f"{input_features.shape[1]} frames give {x.shape[1]} encoder positions, past "
                             f"max_source_positions ({cfg.max_source_positions})")
        x = x + self.enc_pos[: x.shape[1]].to(dtype)
        for layer in self.enc_layers:
            x = layer(x)
        return self.enc_final_norm(x)

    def forward(self, input_features, decoder_input_ids, attention_mask=None, decode: bool = False, cache=None):
        cfg = self.config
        dtype = self.embed_tokens.weight.dtype
        prime = cache is None
        enc_out = self.encode(input_features) if not decode or prime else None
        start = 0
        if decode:
            if prime:
                cache = Seq2SeqCache.start(cfg, enc_out, None, cfg.max_decode_len, dtype)
                enc_out = cache.enc_out.to(dtype)  # the stored f32 output, cast back as the reference reads it
            start = int(cache.self_kv.index)
        s = decoder_input_ids.shape[1]
        if start + s > cfg.max_target_positions:
            raise ValueError(f"decoder positions {start}..{start + s - 1} run past max_target_positions "
                             f"({cfg.max_target_positions})")
        positions = torch.arange(start, start + s, device=decoder_input_ids.device)
        hidden = self.embed_tokens(decoder_input_ids.long()) + self.dec_pos[positions][None].to(dtype)
        for i, layer in enumerate(self.dec_layers):
            hidden = layer(hidden, enc_out, cache if decode else None, i, prime)
        logits = self.dec_final_norm(hidden).float() @ self.embed_tokens.weight.float().T
        if not decode:
            return logits
        cache.advance(s)
        return logits, cache


def _init(module: WhisperModel, dtype: torch.dtype, seed: int, dev) -> None:
    """Seeded weights: every weight, table and convolution ``N(0,
    1/fan_in)`` from a ``torch.Generator`` (a convolution's fan-in is its
    input channels times its taps), norms at one, biases at zero, all in
    ``dtype``; the sinusoids computed in f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(math.prod(p.shape[1:])), generator=gen)
            p.data = p.data.to(dtype)
        cfg = module.config
        module.enc_pos.copy_(torch.from_numpy(sinusoids(cfg.max_source_positions, cfg.d_model)))
    module.requires_grad_(False)
    module.eval()


def create_whisper_model(
    config: Optional[WhisperConfig] = None, seed: int = 0, device=None, dtype: torch.dtype = torch.float32
) -> Model:
    """A Whisper with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), in ``dtype``."""
    config = config or WhisperConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = WhisperModel(config)
    module.to_empty(device=dev)
    _init(module, dtype, seed, dev)
    return Model(module, config, name="whisper")
