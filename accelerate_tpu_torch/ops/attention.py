"""Attention without a cache: the plain einsum path.

Counterpart of :func:`accelerate_tpu.ops.attention.dot_product_attention`
with ``_xla_attention`` folded in: GQA, bottom-right causal alignment
when ``Sq != Sk``, and the sliding-window band (the JAX package fills the
band with the f32 minimum and the causal mask with -inf; both give the
same softmax since every query keeps its own key). Where the JAX package would
run its flash kernel (K1, not ported yet), this raises instead of
quietly taking the plain path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# The JAX package's dispatch point for its flash kernel (its v5e
# crossover). Kept only so that the same calls refuse here until K1 is
# ported and the H100's own crossover is measured.
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
    ``0..Sk-Sq+i``). Returns ``[B, Sq, H, D]``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    seq_len = q.shape[1]
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window is a causal band)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); a 0-width band masks everything")
    auto_flash = use_flash is None and q.device.type == "cuda" and seq_len >= FLASH_MIN_SEQ
    if use_flash or auto_flash:
        raise NotImplementedError("flash kernel K1 not ported yet (see ROADMAP.md)")
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
