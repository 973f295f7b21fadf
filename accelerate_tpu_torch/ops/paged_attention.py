"""Paged-attention decode: the CUDA kernel's wrapper and its plain version.

Counterpart of :mod:`accelerate_tpu.ops.pallas_paged_attention`. One
decode step of attention for every row against its own pages of a
shared K/V pool (layout and masking in
``accelerate_tpu_torch/csrc/paged_attention.cu``). On a CUDA tensor
:func:`paged_decode_attention` launches the hand-written kernel or
raises; on a CPU tensor it computes :func:`paged_decode_attention_plain`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..kernels.launch import LaunchSite, record

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# keys one block of the kernel's split pass walks: rows longer than this
# spread over more blocks, and a combine pass joins their partial sums
_SPLIT_KEYS = 128


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, H, D]
    key_pool: torch.Tensor,  # [NB, bs, Hkv, D]
    value_pool: torch.Tensor,  # [NB, bs, Hkv, D]
    block_table: torch.Tensor,  # [B, MB] int32
    cur: torch.Tensor,  # [B] int32: attend to positions <= cur
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """What the kernel computes, in plain torch: gather every row's pages,
    keep positions in ``(cur - W, cur]``, softmax and weighted sum in f32,
    divide by ``max(l, 1)`` so a row with no live key gives 0. Returns
    ``[B, H, D]`` in ``q.dtype``."""
    b, heads, dim = q.shape
    _, bs, kv_heads, _ = key_pool.shape
    mb = block_table.shape[1]
    scale = (1.0 / math.sqrt(dim)) if scale is None else scale
    tbl = block_table.long()
    k = key_pool[tbl].reshape(b, mb * bs, kv_heads, dim).float()
    v = value_pool[tbl].reshape(b, mb * bs, kv_heads, dim).float()
    pos = torch.arange(mb * bs, device=q.device)
    cur = cur.long()[:, None]
    live = pos[None, :] <= cur  # [B, L]
    if sliding_window is not None:
        live &= pos[None, :] > cur - sliding_window
    qg = q.float().reshape(b, kv_heads, heads // kv_heads, dim)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    s = s.masked_fill(~live[:, None, None, :], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # dead row: every score -inf
    p = torch.exp(s - m)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v)
    out = acc / p.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return out.reshape(b, heads, dim).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    key_pool: torch.Tensor,
    value_pool: torch.Tensor,
    block_table: torch.Tensor,
    cur: torch.Tensor,
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of paged attention (see the module docstring).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    built from ``csrc/paged_attention.cu``; ``meta`` tensors under
    ``kernel_check`` record its launch site."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, key_pool, value_pool, block_table, cur, sliding_window=sliding_window, scale=scale
        )
    if q.device.type == "meta":
        record(_site(q, key_pool, value_pool, block_table, cur, sliding_window, scale))
        return torch.empty_like(q)
    _check(q, key_pool, value_pool, block_table, cur, sliding_window)
    from ..kernels.build import load

    lib = load("paged_attention")
    b, heads, dim = q.shape
    nb, bs, kv_heads, _ = key_pool.shape
    mb = block_table.shape[1]
    scale = (1.0 / math.sqrt(dim)) if scale is None else float(scale)
    split_pages = max(1, _SPLIT_KEYS // bs)
    num_splits = -(-mb // split_pages)
    n = b * heads * num_splits
    out = torch.empty_like(q)
    scratch = torch.empty(n * (dim + 2), dtype=torch.float32, device=q.device)  # partial m, l, acc
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_attention(
        q.data_ptr(), key_pool.data_ptr(), value_pool.data_ptr(), block_table.data_ptr(), cur.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), scratch[n:].data_ptr(), scratch[2 * n :].data_ptr(),
        _DTYPE_CODES[q.dtype], b, heads, kv_heads, dim, nb, bs, mb, split_pages, num_splits, scale,
        int(sliding_window or 0), stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def _site(q, key_pool, value_pool, block_table, cur, sliding_window, scale) -> LaunchSite:
    """The split pass's grid, (row x kv head, 128-key split), 128 threads;
    no tiles declared (its pages are gathered through the block table) and
    no contract registered, as the reference's ops kernels carry none."""
    split_pages = max(1, _SPLIT_KEYS // key_pool.shape[1])
    grid = (q.shape[0] * key_pool.shape[2], -(-block_table.shape[1] // split_pages))
    plain = functools.partial(paged_decode_attention_plain, sliding_window=sliding_window, scale=scale)
    return LaunchSite("paged_decode_attention", grid, 128, plain=plain,
                      operands=(q, key_pool, value_pool, block_table, cur))


def head_dim_ok(d: int) -> bool:
    """Whether the kernel takes head dim ``d``: every multiple of 16 from 16
    to 256, read at run time (``csrc/paged_attention.cu``)."""
    return d % 16 == 0 and 16 <= d <= 256


def _check(q, key_pool, value_pool, block_table, cur, sliding_window) -> None:
    """What the kernel refuses, checked before any build or launch; the
    device last, so the shape checks hold on any tensors."""
    tensors = {"q": q, "key_pool": key_pool, "value_pool": value_pool, "block_table": block_table, "cur": cur}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if key_pool.data_ptr() % 16 or value_pool.data_ptr() % 16:
        raise ValueError("key_pool and value_pool must be 16-byte aligned (the kernel reads them 16 bytes at a time)")
    if q.dtype not in _DTYPE_CODES or key_pool.dtype != q.dtype or value_pool.dtype != q.dtype:
        raise TypeError(
            f"q/key_pool/value_pool must share one of {list(_DTYPE_CODES)}; got "
            f"{q.dtype}/{key_pool.dtype}/{value_pool.dtype}"
        )
    if block_table.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError("block_table and cur must be int32")
    if q.dim() != 3 or key_pool.dim() != 4 or key_pool.shape != value_pool.shape:
        raise ValueError(f"want q [B, H, D] and equal pools [NB, bs, Hkv, D]; got {q.shape}, {key_pool.shape}")
    b, heads, dim = q.shape
    kv_heads = key_pool.shape[2]
    if not head_dim_ok(dim) or key_pool.shape[3] != dim:
        raise ValueError(f"head_dim must be a multiple of 16 from 16 to 256 and match the pools; got {dim}")
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not divisible by kv heads {kv_heads}")
    if block_table.dim() != 2 or block_table.shape[0] != b or cur.shape != (b,):
        raise ValueError(f"want block_table [B, MB] and cur [B] for B={b}; got {block_table.shape}, {cur.shape}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu tensors, got {q.device}")
