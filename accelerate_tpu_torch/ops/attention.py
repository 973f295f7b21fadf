"""Attention without a cache: the einsum path and the flash dispatch.

Counterpart of :func:`accelerate_tpu.ops.attention.dot_product_attention`
with ``_xla_attention`` folded in: GQA, bottom-right causal alignment
when ``Sq != Sk``, the sliding-window band, a boolean ``mask`` and
attention-probability dropout. The softmax runs in the active precision
policy's ``softmax_dtype`` (f32 when it is unset), with the JAX package's
rounding points: the logits are cast to that dtype, the causal mask fills
-inf, ``mask`` fills the dtype's minimum (a fully masked row gets uniform
weights, not NaN), and in a 16-bit dtype max, exp, sum and divide each
round in that dtype (in f32, ``torch.softmax``'s one rounding is the JAX
result to f32 rounding).
The band fills -inf where the JAX package fills the f32 minimum; both give
the same softmax since every query keeps its own key. Long sequences on
the card go to the flash kernels (:mod:`.flash_attention`) when they take
the head dim and there is no mask and no dropout; any other call stays on
the einsum path, as the JAX package's auto path keeps off its kernel only
what the kernel cannot do. On the CPU an explicit ``use_flash=True``
takes their plain blockwise version, as the JAX package's off-TPU flash
path takes its blockwise reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.launch import runs_on_card
from ..utils.dataclasses import MixedPrecisionPolicy
from .flash_attention import flash_attention, flash_head_dim_ok

# Query length from which the card takes the flash kernels by default. 2048
# is the JAX package's TPU v5e crossover, kept until the H100's own
# (chip_smoke.py's flash_crossover phase, PERF.md) moves it.
FLASH_MIN_SEQ = 2048


def _softmax_dtype() -> torch.dtype:
    """The active policy's attention-softmax dtype, f32 when unset or when
    no ``AcceleratorState`` exists."""
    from ..state import AcceleratorState

    state = AcceleratorState._shared_state
    policy = state.get("dtype_policy") if state.get("_initialized") else None
    name = getattr(policy, "softmax_dtype", None)
    return torch.float32 if name is None else MixedPrecisionPolicy.torch_dtype(name)


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H_kv, D]
    v: torch.Tensor,  # [B, Sk, H_kv, D]
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, H, Sq, Sk]
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    window: Optional[int] = None,  # keys <= q_pos - window are masked
) -> torch.Tensor:
    """Multi-head attention with optional GQA (H_kv divides H). Causal
    masking is bottom-right aligned (query i attends keys
    ``0..Sk-Sq+i``). ``mask`` keeps the keys where it is True. With
    ``dropout_rate > 0`` and a ``dropout_rng`` on the tensors' device, each
    weight is kept with probability ``1 - dropout_rate`` and scaled by
    ``1 / (1 - dropout_rate)``. Returns ``[B, Sq, H, D]``.
    ``use_flash=None`` sends ``Sq >= FLASH_MIN_SEQ`` on the card to the
    flash kernels if they take the head dim and the call has no mask and
    no dropout; ``use_flash=True`` with a mask, with dropout, or on the card
    with a head dim the kernels do not take raises."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    seq_len = q.shape[1]
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window is a causal band)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); a 0-width band masks everything")
    on_card, head_dim = runs_on_card(q), q.shape[-1]
    dropout = dropout_rate > 0.0 and dropout_rng is not None
    if use_flash:
        if mask is not None:
            raise ValueError(
                "flash attention supports causal (optionally banded via window=) masking only; "
                "pass mask=None or use_flash=False"
            )
        if dropout:
            raise ValueError("flash attention does not support attention-prob dropout; use_flash=False")
        if on_card and not flash_head_dim_ok(head_dim):
            raise ValueError(f"use_flash=True: the CUDA flash kernels do not take head_dim {head_dim}")
    auto_flash = (
        use_flash is None and on_card and seq_len >= FLASH_MIN_SEQ and flash_head_dim_ok(head_dim)
        and mask is None and dropout_rate == 0.0
    )
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
    sm_dtype = _softmax_dtype()
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).to(sm_dtype)
    if causal:
        q_pos = torch.arange(seq_len, device=q.device)[:, None] + (k.shape[1] - seq_len)  # bottom-right
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        live = q_pos >= k_pos
        if window is not None:
            live &= k_pos > q_pos - window  # every row keeps its own key, so -inf is safe
        logits = logits.masked_fill(~live[None, None], -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(sm_dtype).min)
    if sm_dtype == torch.float32:
        weights = torch.softmax(logits, dim=-1)
    else:
        # torch.softmax rounds once, from f32; jax.nn.softmax rounds each step (max, exp, sum, divide)
        # in sm_dtype, which in 16 bits moves weights by up to an ulp: take its steps
        unnormalized = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        weights = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
    if dropout:
        keep = torch.rand(weights.shape, generator=dropout_rng, device=weights.device) < 1.0 - dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)
