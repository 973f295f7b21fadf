"""fp8 training path: scaled e4m3/e5m2 matmuls behind the precision policy.

Counterpart of :mod:`accelerate_tpu.ops.fp8`. Every block projection of
the model zoo is a :class:`PolicyLinear` (a bare ``nn.Linear`` in every
other respect): under ``mixed_precision="fp8"`` its product is
:func:`fp8_matmul`, otherwise ``F.linear``. The delayed-scaling recipe
swaps in :class:`FP8Dense`, whose amax histories are module buffers, so
they are :attr:`~..modeling.Model.state` and ride through
``build_train_step(has_state=True)``.

The recipe is the JAX package's (TransformerEngine's "hybrid"): forward
operands quantized per tensor to e4m3, gradients to e5m2, f32
accumulation, dynamic (amax) scaling; the scales are constants to autograd.

The products are library GEMMs, as in the JAX package (XLA dots there, no
Pallas kernel): on a CUDA tensor :func:`fp8_mm` calls ``torch._scaled_mm``
(cuBLASLt's fp8 GEMM on Hopper) with per-tensor f32 scales and
``use_fast_accum=False`` -- Hopper's fast accumulation drops accumulator
bits, and the reference accumulates in f32. On a CPU tensor it runs its
plain version, the JAX arithmetic: the codes dequantized to f32, an f32
``matmul``, then the scale. ``launches`` counts the ``_scaled_mm`` calls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..state import AcceleratorState
from ..utils.quantization import FP8_E4M3_MAX as E4M3_MAX
from ..utils.quantization import fp8_quantize

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

#: ``torch._scaled_mm`` calls made by :func:`fp8_mm` (the plain version adds none)
launches = 0

# cuBLASLt's fp8 GEMM takes dims that are multiples of 16
_ALIGN = 16


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t.view(torch.uint8), (0, cols - t.shape[1], 0, rows - t.shape[0])).view(t.dtype)


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def fp8_mm_plain(a8: torch.Tensor, b8: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
                 divide: bool = False) -> torch.Tensor:
    """The plain version of :func:`fp8_mm`: ``a8 [M, K] @ b8 [K, N]`` on the
    codes dequantized to f32, an f32 product, then ``* scale`` (``/ scale``
    with ``divide``) in f32, rounded once to ``out_dtype``."""
    y = a8.float() @ b8.float()
    return (y / scale if divide else y * scale).to(out_dtype)


def fp8_mm(a8: torch.Tensor, b8: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
           divide: bool = False) -> torch.Tensor:
    """``(a8 [M, K] @ b8 [K, N]) * scale`` in f32, rounded once to
    ``out_dtype`` (``divide``: ``/ scale``, the delayed recipe's order).

    On a CUDA tensor this is one ``torch._scaled_mm`` (``use_fast_accum=
    False``): ``a8`` row-major, ``b8`` column-major (a transposed view of
    a row-major ``[N, K]`` tensor is taken as it is), the dequantizing
    scale as ``scale_a`` (``1 / scale`` with ``divide``, one f32 rounding
    away from the reference's division) and 1 as ``scale_b``. cuBLASLt
    takes e4m3 x e4m3, e4m3 x e5m2 and e5m2 x e4m3, not e5m2 x e5m2, which
    no product here needs (forward e4m3 x e4m3, dlhs e5m2 x e4m3, drhs
    e5m2 x e4m3). Dims that are not multiples of 16 are zero-padded (the
    padding adds nothing to the product). On a CPU (or meta) tensor it is
    :func:`fp8_mm_plain`; any other device raises."""
    global launches
    if a8.device.type in ("cpu", "meta"):
        return fp8_mm_plain(a8, b8, scale, out_dtype, divide)
    if a8.device.type != "cuda":
        raise RuntimeError(f"fp8_mm runs on CUDA (torch._scaled_mm) or as its plain version on the CPU, "
                           f"not on {a8.device.type}")
    (m, k), n = a8.shape, b8.shape[1]
    mp, kp, np_ = _up(m), _up(k), _up(n)
    a = _pad_to(a8, mp, kp).contiguous()
    b = b8 if b8.t().is_contiguous() else b8.t().contiguous().t()
    if (kp, np_) != (k, n):
        b = _pad_to(b.t(), np_, kp).contiguous().t()
    scale_a = (1.0 / scale if divide else scale).float().reshape(())
    one = torch.ones((), dtype=torch.float32, device=a8.device)
    out = torch._scaled_mm(a, b, scale_a=scale_a, scale_b=one, out_dtype=out_dtype, use_fast_accum=False)
    launches += 1
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, need_x: bool, need_w: bool):
    """The dynamic backward of both recipes: ``x`` and ``w`` re-quantized to
    e4m3, ``g`` to e5m2. ``dx = g @ w`` comes back in ``x``'s dtype and
    ``dw = g^T @ x`` (the reference's ``drhs`` transposed: it contracts over
    the flattened batch) in ``w``'s."""
    n, k = w.shape
    g8, sg = fp8_quantize(g, E5M2)
    g2 = g8.reshape(-1, n)
    dx = dw = None
    if need_x:
        w8, sw = fp8_quantize(w, E4M3)
        dx = fp8_mm(g2, w8, sg * sw, x.dtype).reshape(x.shape)
    if need_w:
        x8, sx = fp8_quantize(x, E4M3)
        dw = fp8_mm(g2.t(), x8.reshape(-1, k), sx * sg, w.dtype)
    return dx, dw


class _Fp8Matmul(torch.autograd.Function):
    """``x [..., K] @ w[N, K]^T`` with e4m3 operands and f32 accumulation
    (the reference's ``_fp8_matmul`` with ``rhs = w^T``, ``nn.Linear``'s
    layout); the output in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x8, sx = fp8_quantize(x, E4M3)
        w8, sw = fp8_quantize(w, E4M3)
        y = fp8_mm(x8.reshape(-1, x.shape[-1]), w8.t(), sx * sw, x.dtype)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _backward(x, w, g, *ctx.needs_input_grad[:2])


class _Fp8DelayedMatmul(torch.autograd.Function):
    """``x @ w^T`` quantized with scales given in advance (from the amax
    histories): ``clip(x * scale_x, +-448)`` to e4m3, f32 accumulation, the
    product divided by ``scale_x * scale_w``. Values out of range clip. The
    backward is the dynamic e5m2 one: gradient magnitudes move too fast
    for a history."""

    @staticmethod
    def forward(ctx, x, w, scale_x, scale_w):
        ctx.save_for_backward(x, w)
        x8 = torch.clamp(x.float() * scale_x, -E4M3_MAX, E4M3_MAX).to(E4M3)
        w8 = torch.clamp(w.float() * scale_w, -E4M3_MAX, E4M3_MAX).to(E4M3)
        y = fp8_mm(x8.reshape(-1, x.shape[-1]), w8.t(), scale_x * scale_w, x.dtype, divide=True)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _backward(x, w, g, *ctx.needs_input_grad[:2])
        return dx, dw, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w^T`` (``w`` in ``nn.Linear``'s ``[out, in]`` layout) with the
    dynamic recipe, differentiable in both operands."""
    return _Fp8Matmul.apply(x, w)


def _einsum_spec(lhs_ndim: int, rhs_ndim: int, dimension_numbers) -> str:
    """``lax.dot_general``'s ``(((lc), (rc)), ((lb), (rb)))`` as an einsum
    string: batch dims first, then lhs's free dims, then rhs's."""
    (lc, rc), (lb, rb) = dimension_numbers
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    lhs = [next(letters) for _ in range(lhs_ndim)]
    rhs = [None] * rhs_ndim
    for li, ri in zip((*lc, *lb), (*rc, *rb)):
        rhs[ri] = lhs[li]
    rhs = [c if c is not None else next(letters) for c in rhs]
    out = [lhs[i] for i in lb]
    out += [c for i, c in enumerate(lhs) if i not in lc and i not in lb]
    out += [c for i, c in enumerate(rhs) if i not in rc and i not in rb]
    return f"{''.join(lhs)},{''.join(rhs)}->{''.join(out)}"


def dot_general(lhs: torch.Tensor, rhs: torch.Tensor, dimension_numbers) -> torch.Tensor:
    """``lax.dot_general`` in torch (an einsum; same output dim order)."""
    return torch.einsum(_einsum_spec(lhs.ndim, rhs.ndim, dimension_numbers), lhs, rhs)


def fp8_dot_general(lhs: torch.Tensor, rhs: torch.Tensor, dimension_numbers) -> torch.Tensor:
    """:func:`dot_general` with the Dense contraction (last dim of ``lhs``
    with the first of a 2-d ``rhs``, no batch dims) in fp8; every other
    pattern is the exact product, as the reference converts only its dense
    layers."""
    (lc, rc), (lb, rb) = dimension_numbers
    if tuple(lc) == (lhs.ndim - 1,) and tuple(rc) == (0,) and not lb and not rb and rhs.ndim == 2:
        return fp8_matmul(lhs, rhs.t())
    return dot_general(lhs, rhs, dimension_numbers)


def fp8_enabled() -> bool:
    """True when the active Accelerator's precision policy asks for fp8
    (read on every dense layer's call: kept to two dict lookups)."""
    state = AcceleratorState._shared_state
    return state.get("_initialized", False) and getattr(state.get("dtype_policy"), "fp8", False)


def fp8_recipe():
    """The active :class:`~..utils.dataclasses.Fp8RecipeKwargs` (None when
    fp8 is off)."""
    if not fp8_enabled():
        return None
    recipe = getattr(AcceleratorState._shared_state.get("dtype_policy"), "fp8_recipe", None)
    if recipe is None:
        from ..utils.dataclasses import Fp8RecipeKwargs

        recipe = Fp8RecipeKwargs()
    return recipe


class PolicyLinear(nn.Linear):
    """The model zoo's dense layer, the counterpart of the reference's
    ``nn.Dense(..., dot_general=policy_dot_general())``: an ``nn.Linear``
    whose product follows the precision policy when it runs. Under fp8:
    :func:`fp8_matmul` (the Dense pattern of :func:`fp8_dot_general`), then
    the bias in the output's dtype; otherwise ``F.linear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not fp8_enabled():
            return F.linear(x, self.weight, self.bias)
        y = fp8_matmul(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)


# --------------------------------------------------------------------------- #
# delayed (amax-history) scaling: TransformerEngine's DelayedScaling recipe
# --------------------------------------------------------------------------- #


def scale_from_history(history: torch.Tensor, margin: int = 0, algo: str = "max") -> torch.Tensor:
    """``fmax / (amax * 2**margin)`` in f32, with amax the history's max
    (``algo="max"``) or its newest entry (``"most_recent"``). A zero amax
    (an unwarmed history, an all-zero tensor) gives the neutral scale 1."""
    amax = history.max() if algo == "max" else history[0]
    # the f32 quotient, correctly rounded through f64 (see fp8_quantize)
    scale = (E4M3_MAX / (torch.clamp_min(amax, 1e-30) * (2.0**margin)).double()).float()
    return torch.where(amax > 0, scale, 1.0)


class FP8Dense(nn.Module):
    """A dense layer with the delayed-scaling fp8 product.

    ``weight`` is ``[out, in]`` (``nn.Linear``'s layout; the reference's
    kernel transposed). The two amax histories, ``amax_history_x`` (the
    input's) and ``amax_history_k`` (the weight's), are ``[H]`` f32
    buffers, zero at the start: an unwarmed slot is neutral under both
    algorithms. Step k quantizes with scales from steps before k.

    ``forward(x, history=None)`` returns ``(y, new_history)``:
    ``history`` is ``{"amax_history_x": ..., "amax_history_k": ...}``
    (None: the buffers), and the new one has this call's amaxes rolled in
    front. Nothing is written here: the train step writes the new
    histories into the buffers once its backward is done, so a layer
    recomputed under remat rolls them once, and its recompute quantizes
    with the scales its forward used."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False, amax_history_len: int = 16,
                 amax_compute_algo: str = "max", margin: int = 0):
        super().__init__()
        self.in_features, self.out_features = in_features, features
        self.amax_compute_algo, self.margin = amax_compute_algo, margin
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("amax_history_x", torch.zeros(amax_history_len))
        self.register_buffer("amax_history_k", torch.zeros(amax_history_len))

    def forward(self, x: torch.Tensor, history: Optional[dict] = None):
        if history is None:
            history = {"amax_history_x": self.amax_history_x, "amax_history_k": self.amax_history_k}
        hist_x, hist_k = history["amax_history_x"], history["amax_history_k"]
        w = self.weight.to(x.dtype)
        scale_x = scale_from_history(hist_x, self.margin, self.amax_compute_algo)
        scale_k = scale_from_history(hist_k, self.margin, self.amax_compute_algo)
        y = _Fp8DelayedMatmul.apply(x, w, scale_x, scale_k)
        with torch.no_grad():
            amax_x = x.detach().abs().amax().float()
            amax_k = w.detach().abs().amax().float()
            new = {"amax_history_x": torch.cat([amax_x[None], hist_x[:-1]]),
                   "amax_history_k": torch.cat([amax_k[None], hist_k[:-1]])}
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y, new
