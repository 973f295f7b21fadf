"""Attention without a cache: the einsum path and the flash dispatch.

Counterpart of :func:`accelerate_tpu.ops.attention.dot_product_attention`
with ``_xla_attention`` folded in: GQA, bottom-right causal alignment
when ``Sq != Sk``, and the sliding-window band (the JAX package fills the
band with the f32 minimum and the causal mask with -inf; both give the
same softmax since every query keeps its own key). Long sequences on the
card go to the flash kernels (:mod:`.flash_attention`) when they take the
head dim; any other head dim stays on the einsum path, as the JAX
package's auto path keeps off its kernel only what the kernel cannot do.
On the CPU an explicit ``use_flash=True`` takes their plain blockwise
version, as the JAX package's off-TPU flash path takes its blockwise
reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.launch import runs_on_card
from .flash_attention import flash_attention, flash_head_dim_ok

# Query length from which the card takes the flash kernels by default. 2048
# is the JAX package's TPU v5e crossover, kept until the H100's own
# (chip_smoke.py's flash_crossover phase, PERF.md) moves it.
FLASH_MIN_SEQ = 2048


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H_kv, D]
    v: torch.Tensor,  # [B, Sk, H_kv, D]
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,  # keys <= q_pos - window are masked
) -> torch.Tensor:
    """Multi-head attention with optional GQA (H_kv divides H). Causal
    masking is bottom-right aligned (query i attends keys
    ``0..Sk-Sq+i``). Returns ``[B, Sq, H, D]``. ``use_flash=None`` sends
    ``Sq >= FLASH_MIN_SEQ`` on the card to the flash kernels if they take
    the head dim; ``use_flash=True`` on the card with a head dim they do not
    take raises."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    seq_len = q.shape[1]
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window is a causal band)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); a 0-width band masks everything")
    on_card, head_dim = runs_on_card(q), q.shape[-1]
    if use_flash and on_card and not flash_head_dim_ok(head_dim):
        raise ValueError(f"use_flash=True: the CUDA flash kernels do not take head_dim {head_dim}")
    auto_flash = use_flash is None and on_card and seq_len >= FLASH_MIN_SEQ and flash_head_dim_ok(head_dim)
    if use_flash or auto_flash:
        if window is not None and not on_card:
            # the JAX package's off-TPU flash path has no band either
            raise ValueError("banded flash (window=) runs on the CUDA kernels only; drop use_flash=True off the GPU")
        return flash_attention(q, k, v, causal=causal, scale=scale, window=window)
    num_heads, num_kv = q.shape[-2], k.shape[-2]
    if num_kv != num_heads:  # GQA: repeat kv groups
        reps = num_heads // num_kv
        k = k.repeat_interleave(reps, dim=-2)
        v = v.repeat_interleave(reps, dim=-2)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()  # f32 softmax
    if causal:
        q_pos = torch.arange(seq_len, device=q.device)[:, None] + (k.shape[1] - seq_len)  # bottom-right
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        live = q_pos >= k_pos
        if window is not None:
            live &= k_pos > q_pos - window  # every row keeps its own key, so -inf is safe
        logits = logits.masked_fill(~live[None, None], -math.inf)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
