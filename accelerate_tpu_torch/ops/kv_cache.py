"""KV-cache incremental attention for the decode path.

Counterpart of :mod:`accelerate_tpu.ops.kv_cache`. A :class:`KVCache`
holds every layer's dense ``[B, max_len, H_kv, D]`` buffers and a write
index: one int for the whole batch (``generate``, prefill, beam search),
or a ``[B]`` tensor of per-row frontiers (the serving engine's dense
slots and speculative decoding, where the JAX package ``vmap``s a
batch-1 step over the rows, each with its own scalar index). Prefill
(``S_new`` = prompt or chunk) and single-token steps share
:func:`cached_attention`. Where the JAX package rebuilds its cache
pytree, the port writes into the buffers in place. A
:class:`~.paged_kv.PagedKVCache` routes to the paged decode path, as
``paged_mode`` does in the JAX package. The encoder-decoder families
decode over a :class:`Seq2SeqCache`: the decoder's own :class:`KVCache`,
the encoder's output and mask, and each layer's cross-attention K/V,
projected once at the prefill (:func:`cached_cross_kv`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch


def kv_layout(config) -> tuple[int, int]:
    """``(KV heads, head dim)`` of a decoder config: its
    ``num_key_value_heads`` and ``head_dim`` where it has them (the Llama
    families; T5, whose ``heads x head_dim`` need not be its width), else
    multi-head attention over ``hidden_size // num_attention_heads``
    (GPT-2, GPT-NeoX) or, for Whisper's decoder, ``d_model //
    decoder_attention_heads``."""
    if hasattr(config, "decoder_attention_heads"):
        return config.decoder_attention_heads, config.d_model // config.decoder_attention_heads
    head_dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
    return getattr(config, "num_key_value_heads", None) or config.num_attention_heads, head_dim


def cache_layers(config) -> int:
    """The decoder layers a cache holds: ``num_hidden_layers``, or the
    decoder stack's ``num_layers`` (T5) / ``decoder_layers`` (Whisper)."""
    for name in ("num_hidden_layers", "decoder_layers", "num_layers"):
        if hasattr(config, name):
            return getattr(config, name)
    raise ValueError(f"{type(config).__name__} names no decoder layer count")


@dataclasses.dataclass
class KVCache:
    """Dense cache: ``key``/``value`` ``[L, B, max_len, H_kv, D]`` and
    the write ``index`` (rows ``< index`` are valid): an int shared by
    the rows, or an int64 ``[B]`` tensor on the buffers' device, one
    frontier a row."""

    key: torch.Tensor
    value: torch.Tensor
    index: Union[int, torch.Tensor] = 0

    @classmethod
    def empty(cls, config, batch: int, max_len: int, dtype: torch.dtype, device, per_row: bool = False) -> "KVCache":
        """Zeroed buffers; ``per_row`` gives a ``[batch]`` index of zeros."""
        kv_heads, head_dim = kv_layout(config)
        shape = (cache_layers(config), batch, max_len, kv_heads, head_dim)
        index = torch.zeros(batch, dtype=torch.int64, device=device) if per_row else 0
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device),
                   index)

    def advance(self, n: int) -> None:
        """Move the write index (every row's) past the ``n`` rows every
        layer just wrote."""
        self.index = self.index + n

    def row(self, i: int) -> "KVCache":
        """A batch-1 view of row ``i``'s buffers (writes land in this
        cache) with an int index of 0."""
        return KVCache(self.key[:, i : i + 1], self.value[:, i : i + 1], 0)

    def insert(self, row: "KVCache", i: int) -> None:
        """Copy a batch-1 cache into row ``i`` (its rows past ``row``'s
        length keep what they held: they lie beyond the frontier) and
        set row ``i``'s frontier to ``row``'s index. The counterpart of
        the JAX engine's ``insert`` into its slot axis."""
        n = row.key.shape[2]
        self.key[:, i, :n] = row.key[:, 0]
        self.value[:, i, :n] = row.value[:, 0]
        self.index[i] = int(row.index)

    def repeat_rows(self, k: int) -> "KVCache":
        """Each row repeated ``k`` times along the batch axis (``[r0, r0,
        .., r1, r1, ..]``, ``jnp.repeat``'s order): a new cache."""
        index = self.index.repeat_interleave(k) if isinstance(self.index, torch.Tensor) else self.index
        return KVCache(self.key.repeat_interleave(k, dim=1), self.value.repeat_interleave(k, dim=1), index)

    def host_rows(self, n: int) -> dict:
        """The first ``n`` positions of a batch-1 cache on the host: ``key``
        / ``value`` ``[L, 1, n, H_kv, D]`` (fresh host tensors, never a view
        of the buffers) and each layer's write index (int32 ``[L]``, all
        ``n``), as the JAX package's row cache carries one a layer. A
        serving fleet's KV handoff payload: rows past ``n`` never ship."""
        rows = {}
        for name, buf in (("key", self.key), ("value", self.value)):
            part = buf[:, :, :n]
            rows[name] = torch.empty(part.shape, dtype=part.dtype).copy_(part)
        rows["index"] = torch.full((self.key.shape[0],), n, dtype=torch.int32)
        return rows

    @classmethod
    def from_host_rows(cls, rows: dict, device) -> "KVCache":
        """:meth:`host_rows`' payload back on ``device``: a batch-1 cache
        holding just those rows, its index their count (a paste or a dense
        insert takes as many rows as it holds)."""
        key = rows["key"].to(device, copy=True)
        return cls(key, rows["value"].to(device, copy=True), key.shape[2])

    def gather_rows(self, rows: torch.Tensor) -> "KVCache":
        """The rows ``rows`` (int64 ``[B']``) along the batch axis: a new cache."""
        index = self.index[rows] if isinstance(self.index, torch.Tensor) else self.index
        return KVCache(self.key.index_select(1, rows), self.value.index_select(1, rows), index)


def cached_attention(
    cache, layer: int, q, k, v, scale: Optional[float] = None, sliding_window=None, logit_softcap=None,
    bias_fn=None,
):
    """Incremental causal attention of ``q [B, S_new, H, D]`` against
    ``layer``'s cache after writing ``k``/``v`` ``[B, S_new, H_kv, D]`` at
    the write index (each row's own, with a ``[B]`` index; a write that
    would run past ``max_len`` starts at ``max_len - S_new``, as
    ``dynamic_update_slice`` clamps it). Query ``i`` attends keys
    ``<= index + i`` (and ``> index + i - W`` with a sliding window).
    Scores and softmax in f32, ``logit_softcap`` (Gemma2) applied to the
    f32 scores before the mask; GQA contracts grouped queries against the
    un-repeated cache. Returns ``[B, S_new, H, D]``.

    ``scale`` multiplies the scores (``1/sqrt(D)`` by default; T5 passes
    1.0). ``bias_fn(q_pos, key_pos) -> [1, H, S_new, max_len]`` adds a
    position bias to the scaled f32 scores: ``q_pos`` is the int64
    ``[S_new]`` of the queries' absolute positions (``index + i``) and
    ``key_pos`` the ``[max_len]`` of the keys' (``arange(max_len)``), both
    on ``q``'s device, so a prefill and its steps see the same bias (T5's
    relative bias); it needs the shared int index (``generate_seq2seq``'s),
    not a ``[B]`` one. The paged cache refuses a softcap and a
    ``bias_fn``, as the JAX package's does: its kernel has neither branch."""
    from .attention import softcap
    from .paged_kv import PagedKVCache, paged_cached_attention

    if isinstance(cache, PagedKVCache):
        if logit_softcap is not None:
            raise NotImplementedError(
                "attention logit softcapping (Gemma2) is not supported by the paged cache kernel; "
                "serve with the dense engine layout (paged_block_size=None)"
            )
        return paged_cached_attention(cache, layer, q, k, v, scale=scale, sliding_window=sliding_window,
                                      bias_fn=bias_fn)
    b, s_new, h_kv, d = k.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    cur = cache.index
    max_len = cache.key.shape[2]
    k_all, v_all = cache.key[layer], cache.value[layer]
    key_pos = torch.arange(max_len, device=q.device)
    steps = torch.arange(s_new, device=q.device)
    if isinstance(cur, torch.Tensor):
        if bias_fn is not None:
            raise ValueError("bias_fn takes the cache's shared int index, not per-row frontiers")
        rows = cur.clamp(0, max_len - s_new)[:, None] + steps  # [B, S_new]
        batch = torch.arange(b, device=q.device)[:, None]
        k_all[batch, rows] = k.to(k_all.dtype)
        v_all[batch, rows] = v.to(v_all.dtype)
        q_pos = (cur[:, None] + steps)[:, :, None]  # [B, S_new, 1]
        live = key_pos <= q_pos  # [B, S_new, max_len]
        if sliding_window is not None:
            live &= key_pos > q_pos - sliding_window
        live = live[:, None, None]  # over [B, H_kv, G, S_new, max_len]
        bias = None
    else:
        k_all[:, cur : cur + s_new] = k
        v_all[:, cur : cur + s_new] = v
        q_pos = cur + steps
        live = key_pos[None, :] <= q_pos[:, None]  # [S_new, max_len]
        if sliding_window is not None:
            live &= key_pos[None, :] > q_pos[:, None] - sliding_window
        bias = None if bias_fn is None else bias_fn(q_pos, key_pos)

    groups = q.shape[2] // h_kv
    qg = q.reshape(b, s_new, h_kv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_all).float() * scale
    if logit_softcap is not None:
        scores = softcap(scores, logit_softcap)
    if bias is not None:
        scores = scores + bias.reshape(1, h_kv, groups, s_new, max_len)
    scores = scores.masked_fill(~live, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_all)
    return out.reshape(b, s_new, h_kv * groups, d)


@dataclasses.dataclass
class Seq2SeqCache:
    """An encoder-decoder model's decode state: the decoder's self-attention
    cache ``self_kv`` (its write index is the decoder position: Whisper's
    ``dec_pos``), the encoder's output ``enc_out`` ``[B, S_enc, width]``
    stored in f32 and its mask ``enc_mask`` ``[B, S_enc]`` (bool), and
    each decoder layer's cross-attention ``cross_key`` / ``cross_value``
    ``[B, S_enc, H, D]`` in f32 (None until the prefill projects them)."""

    self_kv: KVCache
    enc_out: torch.Tensor
    enc_mask: Optional[torch.Tensor] = None
    cross_key: list = dataclasses.field(default_factory=list)
    cross_value: list = dataclasses.field(default_factory=list)

    @classmethod
    def start(cls, config, enc_out: torch.Tensor, enc_mask: Optional[torch.Tensor], max_len: int,
              dtype: torch.dtype) -> "Seq2SeqCache":
        """A fresh cache at the prefill: the encoder output (kept in f32),
        its mask, an empty ``max_len``-row decoder cache in ``dtype`` and no
        cross K/V yet."""
        layers = cache_layers(config)
        self_kv = KVCache.empty(config, enc_out.shape[0], max_len, dtype, enc_out.device)
        return cls(self_kv, enc_out.float(), enc_mask, [None] * layers, [None] * layers)

    def advance(self, n: int) -> None:
        self.self_kv.advance(n)


def cached_cross_kv(cache: Seq2SeqCache, layer: int, make_k, make_v, prime: bool):
    """Cross-attention K/V of ``layer``: at the prefill (``prime``) the
    zero-argument projections ``make_k()`` / ``make_v()`` run once on the
    encoder output and are stored in f32; every step reuses the stored
    pair without projecting. Returns the stored f32 pair; callers cast it
    to their query's dtype at each use, as the JAX package does."""
    if prime:
        cache.cross_key[layer] = make_k().float()
        cache.cross_value[layer] = make_v().float()
    return cache.cross_key[layer], cache.cross_value[layer]


def reset_cache_index(cache: KVCache, new_index) -> KVCache:
    """Set a dense cache's write index: an int, or a ``[B]`` tensor of
    per-row frontiers (rows past it are stale but sit beyond the causal
    mask until overwritten). Returns the cache."""
    cache.index = new_index if isinstance(new_index, torch.Tensor) else int(new_index)
    return cache
