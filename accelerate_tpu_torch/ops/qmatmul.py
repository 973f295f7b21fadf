"""Fused int4 dequantize + matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of :mod:`accelerate_tpu.ops.pallas_qmatmul`. For
``x [M, in]``, codes ``packed [in/g, g/2, out]`` (uint8, byte row ``r`` of
a group holds code ``2r`` in its low nibble and ``2r + 1`` in its high one)
and ``scale [in/g, 1, out]`` (f32) it computes
``x @ ((code - 8) * scale)`` as the Pallas kernel does, group by group::

    out = sum_g scale_g * (x_g @ code_g  -  8 * sum(x_g))

with ``x`` rounded to bf16 whatever its dtype, the raw codes 0-15 as exact
operands, every product and sum in f32 (the zero-point term too), and one
cast to ``x.dtype`` at the end. The Pallas kernel adds its even and odd
halves of ``x`` in bf16 before summing them; that rounding only adds error
(XLA elides it on the CPU under its excess-precision default) and is left
out here. On a CUDA tensor :func:`int4_matmul` launches the hand-written kernel
(``csrc/int4_matmul.cu``) or raises; on a CPU tensor it computes
:func:`int4_matmul_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels.launch import LaunchSite, record, runs_on_card
from ..kernels.tickets import tickets

# Kernel launches since import (or since a caller reset it to 0): one per
# int4_matmul call on a CUDA tensor.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
N_TILE = 128  # output columns a prefill block owns; ``out`` must divide by it
DECODE_ROWS = 16  # M up to this runs the decode kernel
# Prefill (M > 16): blocks a launch aims for (one for each of the card's
# 132 SMs); the contraction splits into at most _MAX_SPLITS slices of whole
# groups until the grid has about this many blocks.
_TARGET_BLOCKS = 132
_MAX_SPLITS = 8
# Decode: one group of the contraction a warp, up to 4 warps (a split of 4
# groups) and 32 columns a block; where that gives fewer than one block for
# each of the card's 132 SMs, fewer groups a split, then 16 columns.
_DECODE_MIN_BLOCKS = 132
_DECODE_COLUMNS = (32, 16)
_DECODE_WARPS = 4


def _check_shapes(x, packed, scale, group_size: int) -> None:
    if x.dim() != 2 or packed.dim() != 3:
        raise ValueError(f"want x [M, in] and packed [in/g, g/2, out]; got {tuple(x.shape)}, {tuple(packed.shape)}")
    in_features = x.shape[1]
    n_groups, half_g, out_features = packed.shape
    g = group_size
    if half_g != g // 2 or n_groups * g != in_features:
        raise ValueError(f"packed shape {tuple(packed.shape)} inconsistent with in={in_features}, group={g}")
    if g % 64 != 0:
        raise ValueError(f"group_size must be a multiple of 64, got {g}")
    if out_features % N_TILE != 0:
        raise ValueError(f"out dim {out_features} must divide by {N_TILE}")
    if tuple(scale.shape) != (n_groups, 1, out_features):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {(n_groups, 1, out_features)}")


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """What the kernel computes, in plain torch, rounding where it rounds
    (see the module docstring). Returns ``[M, out]`` in ``x.dtype``."""
    _check_shapes(x, packed, scale, group_size)
    m = x.shape[0]
    n_groups, half_g, _ = packed.shape
    xb = x.to(torch.bfloat16).reshape(m, n_groups, half_g, 2)
    x_even, x_odd = xb[..., 0].float(), xb[..., 1].float()  # rows matching the lo / hi nibbles
    lo, hi = (packed & 0x0F).float(), (packed >> 4).float()  # [n_groups, g/2, out]
    partial = torch.einsum("mgr,grn->mgn", x_even, lo) + torch.einsum("mgr,grn->mgn", x_odd, hi)
    xsum = (x_even + x_odd).sum(dim=-1)
    out = ((partial - 8.0 * xsum[..., None]) * scale.float()[:, 0, :]).sum(dim=1)
    return out.to(x.dtype)


class Plan(NamedTuple):
    """One launch of the kernel. ``m <= 16``: the decode kernel, a block of
    ``warps`` warps owning ``columns`` (16 or 32) output columns;
    otherwise the prefill kernel, 4 warps owning 128 columns and
    ``m_tiles`` 16-row tiles of x. Either way a block walks one split of
    ``groups_per_split`` whole groups of the contraction."""

    m_tiles: int
    columns: int
    warps: int
    groups_per_split: int
    splits: int

    def grid(self, m: int, out_features: int) -> tuple:
        """(column tiles, splits), and row tiles for prefill."""
        grid = (out_features // self.columns, self.splits)
        return grid if m <= DECODE_ROWS else (*grid, -(-m // (16 * self.m_tiles)))

    @property
    def threads(self) -> int:
        return 32 * self.warps


def _split_plan(m: int, n_groups: int, out_features: int) -> Plan:
    """The launch for these shapes: shapes alone decide, so a shape always
    sums in one order. Decode gives each warp one group of the contraction,
    4 warps and 32 columns a block; where that makes fewer than
    ``_DECODE_MIN_BLOCKS`` blocks, a split takes 2 groups, then 1, then the
    same with 16 columns. A split joins its partial sums to the others' in
    the same launch."""
    if m <= DECODE_ROWS:
        plans = [(c, min(per, n_groups)) for c in _DECODE_COLUMNS for per in (_DECODE_WARPS, 2, 1)]
        columns, per = next(((c, p) for c, p in plans if (out_features // c) * -(-n_groups // p) >= _DECODE_MIN_BLOCKS),
                            plans[-1])
        return Plan(1, columns, per, per, -(-n_groups // per))
    m_tiles = 2 if m <= 32 else 4
    blocks = (out_features // N_TILE) * -(-m // (16 * m_tiles))
    want = max(1, min(n_groups, _MAX_SPLITS, _TARGET_BLOCKS // blocks))
    groups_per_split = -(-n_groups // want)
    return Plan(m_tiles, N_TILE, 4, groups_per_split, -(-n_groups // groups_per_split))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """``x [M, in] @ dequant(packed [in/g, g/2, out], scale [in/g, 1, out])``.

    Returns ``[M, out]`` in ``x.dtype``. ``in`` must divide by
    ``group_size``, ``group_size`` by 64 and ``out`` by 128. CPU tensors
    take the plain version; CUDA tensors launch the kernel built from
    ``csrc/int4_matmul.cu``; ``meta`` tensors under ``kernel_check`` record
    its launch site (its grid and threads; no tiles, no contract)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, group_size=group_size)
    if x.device.type == "meta":
        _check_shapes(x, packed, scale, group_size)
        m, n_groups, out_features = x.shape[0], packed.shape[0], packed.shape[2]
        plan = _split_plan(m, n_groups, out_features)
        plain = functools.partial(int4_matmul_plain, group_size=group_size)
        record(LaunchSite("int4_matmul", plan.grid(m, out_features), plan.threads, plain=plain,
                          operands=(x, packed, scale)))
        return torch.empty((m, out_features), dtype=x.dtype, device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu tensors, got {x.device}")
    _check_shapes(x, packed, scale, group_size)
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads it 16 bytes at a time)")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"packed must be uint8 and scale float32; got {packed.dtype}, {scale.dtype}")
    m, in_features = x.shape
    n_groups, _, out_features = packed.shape
    out = torch.empty((m, out_features), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    from ..kernels.build import load

    lib = load("int4_matmul")
    plan = _split_plan(m, n_groups, out_features)
    grid = plan.grid(m, out_features)
    # the splits' f32 partial sums, joined in split order: at decode by the last block of each
    # column tile (taking tickets), at prefill by a second pass
    scratch = out if plan.splits == 1 else torch.empty((plan.splits, m, out_features), dtype=torch.float32,
                                                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        tickets(x.device, stream, grid[0]).data_ptr() if m <= DECODE_ROWS else None,
        _DTYPE_CODES[x.dtype], m, in_features, out_features, group_size, plan.m_tiles, plan.columns, plan.warps,
        plan.groups_per_split, plan.splits, stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def int4_supported(x: torch.Tensor, method: str, group_size, n_groups: int, features: int) -> bool:
    """Whether ``QuantDense`` sends this product to the kernel: grouped
    int4 with ``group_size % 64 == 0`` and ``features % 128 == 0``, on a
    CUDA tensor, or a ``meta`` one traced for the card (where the
    reference asks for the TPU backend)."""
    if method != "int4" or group_size is None or group_size % 64 != 0:
        return False
    if features % N_TILE != 0:
        return False
    if x.dim() < 1 or not runs_on_card(x):
        return False
    return True
