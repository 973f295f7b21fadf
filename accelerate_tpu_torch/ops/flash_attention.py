"""Flash attention: the CUDA kernels' wrappers, their plain versions and
the autograd function that binds them.

Counterpart of :mod:`accelerate_tpu.ops.pallas_attention`: the forward
kernel K1 and the backward kernels K2 (dq) and K3 (dk, dv), bound as one
:class:`FlashAttention` the way the JAX package binds its three Pallas
kernels with ``_flash``'s custom VJP. In bf16 and fp16 they are
``accelerate_tpu_torch/csrc/flash_fwd_sm90.cu`` (K1) and
``csrc/flash_bwd_sm90.cu`` (K2, K3): TMA, wgmma and a producer warpgroup;
in f32 ``csrc/flash_attention.cu``'s (:func:`fwd_launch`,
:func:`bwd_launch`), which also states their layout and masking. They take
the head dims :func:`flash_head_dim_ok` admits.

On CUDA tensors :func:`flash_attention` launches the kernels or raises;
on ``meta`` tensors under ``kernel_check`` it records their launch sites;
on CPU tensors it computes the plain versions, which repeat the kernels'
arithmetic block by block (K1's online softmax over its own key tile, the
same rounding points) and serve the card as its oracle.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels.launch import LaunchSite, record

# Kernel launches since import (or since a caller reset them to 0).
launches_fwd = 0
launches_dq = 0
launches_dkv = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
# keys a block of the plain backward takes; P comes from lse there, so the
# tile only orders the f32 sums
_BLOCK = 64


def flash_head_dim_ok(d: int) -> bool:
    """Whether the CUDA flash kernels (K1-K3) take head dim ``d``: the one
    test the wrappers and ``dot_product_attention``'s dispatch share."""
    return d in _HEAD_DIMS


def _check_args(causal: bool, window: Optional[int]) -> None:
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window is a causal band)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); a 0-width band masks everything")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _heads_first(x: torch.Tensor, groups: int, dtype=torch.float32) -> torch.Tensor:
    """``[B, S, Hkv, D]`` -> ``[B, Hkv * groups, S, D]`` in ``dtype``, each kv
    head repeated for the query heads of its group."""
    x = x.to(dtype).transpose(1, 2)
    return x.repeat_interleave(groups, dim=1) if groups > 1 else x


def _live(sq: int, sk: int, k0: int, k1: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """``[Sq, k1 - k0]`` mask of the keys ``k0..k1-1``: bottom-right causal and
    the band ``col > row + (Sk - Sq) - window``."""
    row = torch.arange(sq, device=device)[:, None] + (sk - sq)
    col = torch.arange(k0, k1, device=device)[None, :]
    live = torch.ones(sq, k1 - k0, dtype=torch.bool, device=device)
    if causal:
        live &= row >= col
    if window is not None:
        live &= col > row - window
    return live


def flash_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    block_k: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes, in plain torch: ``(out [B, Sq, H, D] in q's dtype,
    lse [B, H, Sq] f32)``. Online softmax over blocks of ``block_k`` keys in
    f32 (None: K1's own key tile for q's dtype and D, ``fwd_launch(...).keys``,
    so P is rounded where the kernel rounds it), P cast to v's dtype before
    P v; a row with no live key gives out 0, lse -inf."""
    _check_args(causal, window)
    b, sq, h, d = q.shape
    sk, groups = k.shape[1], h // k.shape[2]
    scale = _scale(q, scale)
    block_k = block_k or fwd_launch(q.dtype, b, h, sq, d).keys
    qf = q.float().transpose(1, 2)
    kf = _heads_first(k, groups)
    vh = _heads_first(v, groups, v.dtype)
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros(b, h, sq, 1, device=q.device)
    acc = torch.zeros(b, h, sq, d, device=q.device)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        s = s.masked_fill(~_live(sq, sk, k0, k1, causal, window, q.device), -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - safe)  # masked scores: exp(-inf) = 0
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vh[:, :, k0:k1].float()
        m = m_new
    lv = l.clamp_min(1e-37)
    out = (acc / lv).to(q.dtype).transpose(1, 2).contiguous()
    lse = torch.where(torch.isfinite(m), m + torch.log(lv), torch.full_like(m, -math.inf))[..., 0]
    return out, lse


def _plain_blocks(q, k, v, dout, lse, delta, causal, scale, window):
    """Per 64-key block ``(k0, k1, q, k, p, ds)`` of the backward in f32,
    heads first (``[B, H, ...]``): P recomputed from lse (a -inf lse gives
    P = 0) and dS = P (dP - delta) scale."""
    sq, sk, groups = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    qf, kf, vf = q.float().transpose(1, 2), _heads_first(k, groups), _heads_first(v, groups)
    dof = dout.float().transpose(1, 2)
    lse = lse[..., None]
    lse_ok = torch.isfinite(lse)
    lse_safe = torch.where(lse_ok, lse, torch.zeros_like(lse))
    for k0 in range(0, sk, _BLOCK):
        k1 = min(k0 + _BLOCK, sk)
        kb = kf[:, :, k0:k1]
        s = (qf @ kb.transpose(-1, -2)) * scale
        live = _live(sq, sk, k0, k1, causal, window, q.device) & lse_ok
        p = torch.where(live, torch.exp(s - lse_safe), torch.zeros_like(s))
        dp = dof @ vf[:, :, k0:k1].transpose(-1, -2)
        yield k0, k1, qf, kb, dof, p, p * (dp - delta[..., None]) * scale


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * out)`` as ``[B, H, Sq]`` f32, the softmax Jacobian's row
    term (a plain reduction, as the JAX package leaves it to XLA)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_plain_dq(q, k, v, dout, lse, delta, causal=False, scale=None, window=None) -> torch.Tensor:
    """What K2 computes: dq ``[B, Sq, H, D]`` f32, dS cast to k's dtype
    before dS k."""
    scale = _scale(q, scale)
    dq = torch.zeros(q.shape[0], q.shape[2], q.shape[1], q.shape[3], device=q.device)
    for _, _, _, kb, _, _, ds in _plain_blocks(q, k, v, dout, lse, delta, causal, scale, window):
        dq += ds.to(k.dtype).float() @ kb
    return dq.transpose(1, 2).contiguous()


def flash_attention_plain_dkv(q, k, v, dout, lse, delta, causal=False, scale=None, window=None):
    """What K3 computes: ``(dk, dv)`` ``[B, Sk, Hkv, D]`` f32, P cast to dO's
    dtype before P^T dO and dS to q's dtype before dS^T q, the query heads
    of each kv group summed."""
    scale = _scale(q, scale)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk = torch.zeros(b, h, sk, d, device=q.device)
    dv = torch.zeros(b, h, sk, d, device=q.device)
    for k0, k1, qf, _, dof, p, ds in _plain_blocks(q, k, v, dout, lse, delta, causal, scale, window):
        dv[:, :, k0:k1] = p.to(dout.dtype).float().transpose(-1, -2) @ dof
        dk[:, :, k0:k1] = ds.to(q.dtype).float().transpose(-1, -2) @ qf
    dk = dk.view(b, hkv, h // hkv, sk, d).sum(dim=2).transpose(1, 2).contiguous()
    dv = dv.view(b, hkv, h // hkv, sk, d).sum(dim=2).transpose(1, 2).contiguous()
    return dk, dv


def flash_attention_plain_bwd(q, k, v, out, lse, dout, causal=False, scale=None, window=None):
    """What K2 and K3 compute together: ``(dq, dk, dv)`` in f32 from the
    saved ``out`` and ``lse``."""
    delta = _delta(out, dout)
    dq = flash_attention_plain_dq(q, k, v, dout, lse, delta, causal, scale, window)
    return (dq, *flash_attention_plain_dkv(q, k, v, dout, lse, delta, causal, scale, window))


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FwdLaunch:
    """One launch of K1: the library and C entry, the grid ``(B * H, query
    blocks)``, threads a block, dynamic shared memory bytes, and the keys of
    a K tile (where the online softmax rounds P)."""

    library: str
    entry: str
    grid: tuple
    threads: int
    smem_bytes: int
    keys: int


@dataclass(frozen=True)
class BwdLaunch:
    """One launch of K2 (dq) or K3 (dkv): the library and C entry, the grid
    (K2 ``(B * H, query blocks)``, K3 ``(B * Hkv, key blocks)``), threads a
    block and dynamic shared memory bytes."""

    library: str
    entry: str
    grid: tuple
    threads: int
    smem_bytes: int


_F32_TILE = 64  # rows of flash_attention.cu's f32 blocks and of the tiles they walk
_F32_WARP_BUF = 4 * 16 * (_F32_TILE + 8) * 4  # P or dS, 16 rows a warp (pitch 72)


def _f32_tiles(n: int, d: int) -> int:
    """Shared bytes of ``n`` f32 tiles of 64 rows, pitch D + 8."""
    return n * _F32_TILE * (d + 8) * 4


def fwd_launch(dtype: torch.dtype, b: int, h: int, sq: int, d: int) -> FwdLaunch:
    """What K1 launches for q ``[b, sq, h, d]``. In bf16 and fp16 the Hopper
    kernel (``csrc/flash_fwd_sm90.cu``): a producer warpgroup and 64 query
    rows for each consumer warpgroup, three at D 64 (192 rows, 512 threads)
    and two at D 128 (128 rows, 384 threads); Q plus two stages of 128-key
    K and V tiles in shared memory. In f32 ``csrc/flash_attention.cu``'s: 64
    rows and 4 warps, one stage of 64-key tiles. The grid is ``(B * H, query
    blocks)``. Each C launcher reports the same through its
    ``<entry>_config`` entry (``kernels.build.launch_config``). What the
    kernels refuse is :func:`_check_cuda`'s to say."""
    if dtype in (torch.bfloat16, torch.float16):
        consumers, keys, stages = (3 if d == 64 else 2), 128, 2
        rows = 64 * consumers
        smem = 1024 + rows * d * 2 + 2 * stages * keys * d * 2 + (1 + 4 * stages) * 8  # align, Q, K and V, barriers
        return FwdLaunch("flash_fwd_sm90", "flash_fwd_sm90", (b * h, -(-sq // rows)), 128 * (consumers + 1), smem,
                         keys)
    smem = _f32_tiles(3, d) + _F32_WARP_BUF  # q, k, v and P a warp
    return FwdLaunch("flash_attention", "flash_attention_fwd", (b * h, -(-sq // _F32_TILE)), 128, smem, _F32_TILE)


def bwd_launch(kind: str, dtype: torch.dtype, b: int, h: int, hkv: int, sq: int, sk: int, d: int) -> BwdLaunch:
    """What K2 (``kind`` "dq") or K3 ("dkv") launches for q ``[b, sq, h, d]``
    and k ``[b, sk, hkv, d]``: the one source of grid, threads and shared
    memory for the wrappers, for ``kernel_check``'s launch sites and for the
    checks against each C launcher's ``<entry>_config``. In bf16 and fp16
    the Hopper kernels (``csrc/flash_bwd_sm90.cu``), 64 rows for each
    consumer warpgroup beside a producer warpgroup, two stages of 64-row
    tiles: K2 three consumers at D 64 and two at D 128 (Q and dO of the
    block, K and V tiles), K3 two (K and V of the block; Q, dO, lse and
    delta tiles). In f32 ``csrc/flash_attention.cu``'s: 64 rows and 4
    warps, one stage."""
    if kind not in ("dq", "dkv"):
        raise ValueError(f"kind is 'dq' or 'dkv', got {kind!r}")
    if dtype in (torch.bfloat16, torch.float16):
        stages, tile = 2, 64
        consumers = (3 if d == 64 else 2) if kind == "dq" else 2
        rows = 64 * consumers
        # align, the block's two row tiles, two rings of tiles, (K3) lse and delta, barriers
        smem = 1024 + 2 * rows * d * 2 + 2 * stages * tile * d * 2
        smem += (1 + 4 * stages) * 8 if kind == "dq" else stages * 2 * tile * 4 + (1 + 2 * stages) * 8
        grid = (b * h, -(-sq // rows)) if kind == "dq" else (b * hkv, -(-sk // rows))
        return BwdLaunch("flash_bwd_sm90", f"flash_{kind}_sm90", grid, 128 * (consumers + 1), smem)
    if kind == "dq":  # q, dO, k, v and dS a warp
        return BwdLaunch("flash_attention", "flash_attention_dq", (b * h, -(-sq // _F32_TILE)), 128,
                         _f32_tiles(4, d) + _F32_WARP_BUF)
    # k, v, q, dO, the lse and delta rows, and P / dS a warp
    return BwdLaunch("flash_attention", "flash_attention_dkv", (b * hkv, -(-sk // _F32_TILE)), 128,
                     _f32_tiles(4, d) + 2 * _F32_TILE * 4 + _F32_WARP_BUF)


def _check_cuda(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D]; got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one dtype; got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if t.data_ptr() % 16 or any(s % (16 // t.element_size()) for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned in every row (the kernels read 16 bytes at a time)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernels take {list(_DTYPE_CODES)}, got {q.dtype}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"want k, v [B, Sk, Hkv, D] matching q [B, Sq, H, D]; got {q.shape}, {k.shape}, {v.shape}")
    if h % k.shape[2]:
        raise ValueError(f"heads {h} not divisible by kv heads {k.shape[2]}")
    if not flash_head_dim_ok(d):
        raise ValueError(f"the CUDA flash kernels take head_dim in {_HEAD_DIMS}; got head_dim {d}")
    if sq < 1 or k.shape[1] < 1 or b < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype != torch.float32:  # the 16-bit kernels read q, k and v through TMA tensor maps
        for name, t in (("q", q), ("k", k), ("v", v)):
            if any(st == 0 for st in t.stride()[:3]) or max(t.stride()[:3]) * t.element_size() >= 1 << 40:
                raise ValueError(f"{name}: TMA takes batch, seq and head strides of 16 bytes to 2**40 bytes; "
                                 f"got {t.stride()[:3]} elements")


def _shape_args(q, k, v, scale, causal, window):
    b, sq, h, d = q.shape
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    tail = (strides, float(scale), int(causal), int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    return (_DTYPE_CODES[q.dtype], b, h, k.shape[2], sq, k.shape[1], d), tail


def _raise_on(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a tensor map: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def flash_fwd_kernel(q, k, v, causal, scale, window):
    """K1 on the card: ``(out [B, Sq, H, D] q.dtype, lse [B, H, Sq] f32)``;
    bf16 and fp16 through the Hopper kernel, f32 through the 64-row one
    (:func:`fwd_launch`)."""
    _check_cuda(q, k, v)
    from ..kernels.build import load

    b, sq, h, d = q.shape
    launch = fwd_launch(q.dtype, b, h, sq, d)
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    dims, tail = _shape_args(q, k, v, scale, causal, window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    if launch.library == "flash_fwd_sm90":
        lib16 = load("flash_fwd_sm90")
        _raise_on(lib16.flash_fwd_sm90(*ptrs, *dims, *tail), "flash_fwd_sm90")
    else:
        lib = load("flash_attention")
        _raise_on(lib.flash_attention_fwd(*ptrs, *dims, *tail), "flash_attention_fwd")
    global launches_fwd
    launches_fwd += 1
    return out, lse


def _check_bwd(q, dout, lse, delta) -> None:
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError(f"dout must be a contiguous, 16-byte aligned {q.dtype} tensor of q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous f32 [B, H, Sq] tensor on {q.device}")


def flash_dq_kernel(q, k, v, dout, lse, delta, causal, scale, window):
    """K2 on the card: dq ``[B, Sq, H, D]`` f32; bf16 and fp16 through the
    Hopper kernel, f32 through the 64-row one (:func:`bwd_launch`)."""
    _check_cuda(q, k, v)
    _check_bwd(q, dout, lse, delta)
    from ..kernels.build import load

    b, sq, h, d = q.shape
    launch = bwd_launch("dq", q.dtype, b, h, k.shape[2], sq, k.shape[1], d)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dims, tail = _shape_args(q, k, v, scale, causal, window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr())
    if launch.library == "flash_bwd_sm90":
        lib16 = load("flash_bwd_sm90")
        _raise_on(lib16.flash_dq_sm90(*ptrs, *dims, *tail), "flash_dq_sm90")
    else:
        lib = load("flash_attention")
        _raise_on(lib.flash_attention_dq(*ptrs, *dims, *tail), "flash_attention_dq")
    global launches_dq
    launches_dq += 1
    return dq


def flash_dkv_kernel(q, k, v, dout, lse, delta, causal, scale, window):
    """K3 on the card: ``(dk, dv)`` ``[B, Sk, Hkv, D]`` f32, the query heads
    of each kv group summed inside the kernel; bf16 and fp16 through the
    Hopper kernel, f32 through the 64-row one (:func:`bwd_launch`)."""
    _check_cuda(q, k, v)
    _check_bwd(q, dout, lse, delta)
    from ..kernels.build import load

    b, sq, h, d = q.shape
    launch = bwd_launch("dkv", q.dtype, b, h, k.shape[2], sq, k.shape[1], d)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dims, tail = _shape_args(q, k, v, scale, causal, window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    if launch.library == "flash_bwd_sm90":
        lib16 = load("flash_bwd_sm90")
        _raise_on(lib16.flash_dkv_sm90(*ptrs, *dims, *tail), "flash_dkv_sm90")
    else:
        lib = load("flash_attention")
        _raise_on(lib.flash_attention_dkv(*ptrs, *dims, *tail), "flash_attention_dkv")
    global launches_dkv
    launches_dkv += 1
    return dk, dv


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return q.device.type


def _record(name: str, grid: tuple, plain, operands: tuple, threads: int) -> None:
    """The launch site of one flash kernel on ``meta`` tensors: its grid and
    threads (:func:`fwd_launch`, :func:`bwd_launch`); no tiles declared and
    no contract registered, as the reference's ops kernels carry none."""
    record(LaunchSite(name, grid, threads, plain=plain, operands=operands))


def _record_fwd(q, k, v, causal, scale, window):
    b, sq, h, d = q.shape
    plain = functools.partial(flash_attention_plain, causal=causal, scale=scale, window=window)
    launch = fwd_launch(q.dtype, b, h, sq, d)
    _record("flash_attention_fwd", launch.grid, plain, (q, k, v), launch.threads)
    return (torch.empty(b, sq, h, d, dtype=q.dtype, device="meta"),
            torch.empty(b, h, sq, dtype=torch.float32, device="meta"))


def _record_bwd(q, k, v, dout, lse, delta, causal, scale, window):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    operands = (q, k, v, dout, lse, delta)
    for kind, plain in (("dq", flash_attention_plain_dq), ("dkv", flash_attention_plain_dkv)):
        launch = bwd_launch(kind, q.dtype, b, h, hkv, sq, sk, d)
        _record(f"flash_attention_{kind}", launch.grid,
                functools.partial(plain, causal=causal, scale=scale, window=window), operands, launch.threads)
    dk = torch.empty(k.shape, dtype=torch.float32, device="meta")
    return torch.empty(q.shape, dtype=torch.float32, device="meta"), dk, torch.empty_like(dk)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: K1 forward, K2 and K3 backward on
    CUDA tensors, the plain versions on CPU tensors. Saves ``q, k, v, out,
    lse`` and nothing of size S^2."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        device = _device_of(q)
        if device == "cuda":
            out, lse = flash_fwd_kernel(q, k, v, causal, scale, window)
        elif device == "meta":
            out, lse = _record_fwd(q, k, v, causal, scale, window)
        else:
            out, lse = flash_attention_plain(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        device = _device_of(q)
        if device == "cuda":
            delta = _delta(out, dout)
            dq = flash_dq_kernel(q, k, v, dout, lse, delta, *ctx.args)
            dk, dv = flash_dkv_kernel(q, k, v, dout, lse, delta, *ctx.args)
        elif device == "meta":
            dq, dk, dv = _record_bwd(q, k, v, dout, lse, _delta(out, dout), *ctx.args)
        else:
            dq, dk, dv = flash_attention_plain_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention, differentiable: the counterpart of
    :func:`accelerate_tpu.ops.pallas_attention.pallas_flash_attention`. GQA
    when ``Hkv`` divides ``H``, bottom-right causal alignment when ``Sq !=
    Sk``, ``window`` (requires ``causal``) keeps keys ``> row + Sk - Sq -
    window``. Returns ``[B, Sq, H, D]`` in q's dtype."""
    _check_args(causal, window)
    return FlashAttention.apply(q, k, v, causal, _scale(q, scale), window)
