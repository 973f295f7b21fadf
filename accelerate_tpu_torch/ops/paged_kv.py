"""Paged KV cache: a shared block pool plus per-row block tables.

Counterpart of :mod:`accelerate_tpu.ops.paged_kv`. The cache allocates
fixed-size *blocks* from one pool shared by every serving slot:

* ``key_pool`` / ``value_pool``: ``[L, NB, bs, H_kv, D]``, one tensor for
  all layers (``pool[l]`` is layer ``l``'s ``[NB, bs, H_kv, D]`` pool);
* ``block_table``: ``[B, MB]`` int32 — position ``p`` of row ``b`` lives
  at ``pool[table[b, p // bs], p % bs]``;
* ``index``: ``[B]`` int32 per-row write positions (ragged frontiers);
* block 0 is the **trash sink**: pad table entries and the overshoot
  writes of a slot that finished mid-tick land there, so a retired slot
  never writes into a block that was freed and handed to another row.

The JAX package rebuilds its pools functionally; the port writes them
in place (``paged_cached_attention``, :func:`paste_row`,
:func:`paste_blocks`, :func:`set_table_row` and :func:`clear_slot` all
mutate the cache).
The decode step calls the paged-attention kernel
(:mod:`.paged_attention`) on CUDA and its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .kv_cache import kv_layout
from .paged_attention import paged_decode_attention


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    block_size: int
    num_blocks: int  # total pool blocks INCLUDING the reserved trash block 0


@dataclasses.dataclass
class PagedKVCache:
    """Pools ``[L, NB, bs, H_kv, D]``, ``block_table [B, MB]`` and
    ``index [B]`` (both int32), all on one device."""

    key_pool: torch.Tensor
    value_pool: torch.Tensor
    block_table: torch.Tensor
    index: torch.Tensor

    @classmethod
    def empty(cls, config, pcfg: PagedConfig, batch: int, dtype: torch.dtype, device) -> "PagedKVCache":
        """An all-zero cache whose table width follows the model's horizon
        (``ceil(max_position_embeddings / block_size)`` entries a row)."""
        kv_heads, head_dim = kv_layout(config)
        shape = (config.num_hidden_layers, pcfg.num_blocks, pcfg.block_size, kv_heads, head_dim)
        mb = -(-config.max_position_embeddings // pcfg.block_size)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros((batch, mb), dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def advance(self, n: int) -> None:
        self.index += n


def paged_cached_attention(cache: PagedKVCache, layer: int, q, k, v, scale=None, sliding_window=None,
                           bias_fn=None):
    """Single-token attention against the paged pool: write the step's
    K/V at ``pool[table[b, min(cur // bs, MB - 1)], cur % bs]`` (past the
    table a row's writes clamp to its last entry: its own block or the
    trash sink, never another row's), then attend to positions
    ``<= cur``. Prefill runs the dense path and is pasted in by
    :func:`paste_row`, so only ``S_new == 1`` reaches here. A position
    bias (``bias_fn``, T5's) is refused, as the JAX package refuses it:
    the kernel has no bias branch."""
    b, s_new, _, d = k.shape
    if s_new != 1:
        raise ValueError(
            f"paged attention is decode-only (S_new == 1, got {s_new}); "
            "prefill runs the dense path and is pasted into the pool"
        )
    if bias_fn is not None:
        raise NotImplementedError("paged attention does not support bias_fn (T5-style relative bias)")
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    bs_, mb = cache.key_pool.shape[2], cache.block_table.shape[1]
    cur = cache.index
    rows = torch.arange(b, device=cur.device)
    dest = cache.block_table[rows, torch.clamp(cur // bs_, max=mb - 1)].long()
    off = (cur % bs_).long()
    kp, vp = cache.key_pool[layer], cache.value_pool[layer]
    kp[dest, off] = k[:, 0]
    vp[dest, off] = v[:, 0]
    out = paged_decode_attention(
        q[:, 0].contiguous(), kp, vp, cache.block_table, cur, sliding_window=sliding_window, scale=scale
    )
    return out[:, None]


def paste_blocks(cache: PagedKVCache, row_cache, write_row) -> None:
    """Write pool content only (no slot's table row or frontier): cut a
    dense row cache (``key``/``value`` ``[L, 1, rows, H_kv, D]``) into
    blocks and write them at the non-trash ids of ``write_row``: entry
    ``i`` of the row goes to pool block ``write_row[i]``, and entries that
    are 0 (the trash sink) are skipped. A row cache shorter than the table
    (the serving engine's holds ``max_len`` rows) fills the entries it
    covers, its last block zero-padded; the entries past it hold positions
    no request reaches, which decode writes before any read. Used alone
    once for each registered prefix, to install its full blocks as the
    shared content every aliasing request reads. In place."""
    n_layers, _, bs_, h_kv, d = cache.key_pool.shape
    n_rows = row_cache.key.shape[2]
    n_blocks = -(-n_rows // bs_)
    write_row = np.asarray(write_row)
    entries = np.flatnonzero(write_row[:n_blocks])
    if not entries.size:
        return
    dev = cache.key_pool.device
    ids = torch.as_tensor(write_row[entries], dtype=torch.long, device=dev)
    sel = torch.as_tensor(entries, dtype=torch.long, device=dev)
    for pool, rows in ((cache.key_pool, row_cache.key), (cache.value_pool, row_cache.value)):
        rows = rows[:, 0]
        pad = n_blocks * bs_ - n_rows
        if pad > 0:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
        blocks = rows.reshape(n_layers, n_blocks, bs_, h_kv, d)
        pool[:, ids] = blocks[:, sel].to(pool.dtype)


def paste_row(cache: PagedKVCache, row_cache, write_row, table_row, slot: int, new_index: int) -> None:
    """Install a dense prefill row cache into the pool for ``slot``: its
    blocks are written at ``write_row``'s non-trash ids
    (:func:`paste_blocks`), and ``slot``'s table row and frontier become
    ``table_row`` and ``new_index``. ``write_row`` and ``table_row`` differ
    exactly on the entries the admission must not write: pad entries and
    shared prefix blocks are 0 in ``write_row`` (a shared block's content
    was written once, at registration), while ``table_row`` keeps the real
    ids for reads. In place."""
    paste_blocks(cache, row_cache, write_row)
    set_table_row(cache, slot, table_row)
    cache.index[slot] = int(new_index)


def set_table_row(cache: PagedKVCache, slot: int, table_row) -> None:
    """Replace ``slot``'s block-table row (pools and frontier untouched). In place."""
    cache.block_table[slot] = torch.as_tensor(np.asarray(table_row), dtype=torch.int32).to(cache.block_table.device)


def clear_slot(cache: PagedKVCache, slot: int) -> None:
    """Re-point ``slot``'s table row at the trash sink and zero its
    frontier. MUST run when a slot retires: the decode tick keeps
    computing (and writing) for every slot, and a stale table would
    corrupt blocks after they are freed and reallocated. In place."""
    cache.block_table[slot] = 0
    cache.index[slot] = 0


class BlockAllocator:
    """Host-side free list over pool blocks ``1..num_blocks-1`` (block 0
    is the trash sink and is never handed out)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (one is the trash sink), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """``n`` block ids, or None if the pool can't satisfy the request
        (callers keep the request queued and retry after a retirement)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, ids) -> None:
        for i in ids:
            if not 0 < i < self.num_blocks:
                raise ValueError(f"bad block id {i}")
            self._free.append(i)
