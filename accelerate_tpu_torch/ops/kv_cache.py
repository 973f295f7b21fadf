"""KV-cache incremental attention for the decode path.

Counterpart of :mod:`accelerate_tpu.ops.kv_cache`. A :class:`KVCache`
holds every layer's dense ``[B, max_len, H_kv, D]`` buffers and one
write index; prefill (``S_new`` = prompt or chunk) and single-token
steps share :func:`cached_attention`. Where the JAX package rebuilds its
cache pytree, the port writes into the buffers in place. A
:class:`~.paged_kv.PagedKVCache` routes to the paged decode path, as
``paged_mode`` does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class KVCache:
    """Dense cache: ``key``/``value`` ``[L, B, max_len, H_kv, D]`` and
    the write ``index`` (rows ``< index`` are valid)."""

    key: torch.Tensor
    value: torch.Tensor
    index: int = 0

    @classmethod
    def empty(cls, config, batch: int, max_len: int, dtype: torch.dtype, device) -> "KVCache":
        head_dim = config.head_dim or config.hidden_size // config.num_attention_heads
        shape = (config.num_hidden_layers, batch, max_len, config.num_key_value_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))

    def advance(self, n: int) -> None:
        """Move the write index past the ``n`` rows every layer just wrote."""
        self.index += n


def cached_attention(
    cache, layer: int, q, k, v, scale: Optional[float] = None, sliding_window=None, logit_softcap=None
):
    """Incremental causal attention of ``q [B, S_new, H, D]`` against
    ``layer``'s cache after writing ``k``/``v`` ``[B, S_new, H_kv, D]`` at
    the write index. Query ``i`` attends keys ``<= index + i`` (and
    ``> index + i - W`` with a sliding window). Scores and softmax in f32,
    ``logit_softcap`` (Gemma2) applied to the f32 scores before the mask;
    GQA contracts grouped queries against the un-repeated cache. Returns
    ``[B, S_new, H, D]``. The paged cache refuses a softcap, as the JAX
    package's does: its kernel has no tanh-cap branch."""
    from .attention import softcap
    from .paged_kv import PagedKVCache, paged_cached_attention

    if isinstance(cache, PagedKVCache):
        if logit_softcap is not None:
            raise NotImplementedError(
                "attention logit softcapping (Gemma2) is not supported by the paged cache kernel; "
                "the dense engine layout that serves it is not ported yet (ROADMAP.md Queue 1 item 6)"
            )
        return paged_cached_attention(cache, layer, q, k, v, scale=scale, sliding_window=sliding_window)
    b, s_new, h_kv, d = k.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    cur = cache.index
    max_len = cache.key.shape[2]
    cache.key[layer, :, cur : cur + s_new] = k
    cache.value[layer, :, cur : cur + s_new] = v
    k_all, v_all = cache.key[layer], cache.value[layer]

    key_pos = torch.arange(max_len, device=q.device)
    q_pos = cur + torch.arange(s_new, device=q.device)
    live = key_pos[None, :] <= q_pos[:, None]  # [S_new, max_len]
    if sliding_window is not None:
        live &= key_pos[None, :] > q_pos[:, None] - sliding_window

    groups = q.shape[2] // h_kv
    qg = q.reshape(b, s_new, h_kv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_all).float() * scale
    if logit_softcap is not None:
        scores = softcap(scores, logit_softcap)
    scores = scores.masked_fill(~live, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_all)
    return out.reshape(b, s_new, h_kv * groups, d)


def reset_cache_index(cache: KVCache, new_index: int) -> KVCache:
    """Set a dense cache's write index (rows past it are stale but sit
    beyond the causal mask until overwritten). Returns the cache."""
    cache.index = int(new_index)
    return cache
