"""The nominal FLOP model, counted over PyTorch's dispatched operations.

Counterpart of :func:`accelerate_tpu.analysis.perfmodel.op_flops` (only
the FLOP model; the roofline walk is not ported). The reference prices
each jaxpr equation; the port prices each ``aten`` operation a function
dispatches, seen by a :class:`FlopCounter` (a ``TorchDispatchMode``), on
``meta`` tensors as readily as on real ones. The weights are the
reference's:

* products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``,
  ``convolution``): ``2 m n k`` (batch included);
* transcendentals (``exp``, ``log``, ``tanh``, ``sigmoid``, ``sqrt``, ...):
  10 an output element;
* reductions (``sum``, ``amax``, ``mean``, ``cumsum``, ...): 1 an input
  element;
* views, copies, casts, gathers, selects and fills: 0;
* everything else: 1 an output element.

``_softmax`` and ``_log_softmax``, single operations in PyTorch and a
chain of primitives in JAX, count as that chain: 14 an element (a maximum,
a subtraction, an exponential, a sum and a division). Operations are
matched by their packet name (``aten.sum.dim_IntList`` is ``sum``), which
is stable across PyTorch versions where overload names are not; in-place
variants count as their out-of-place form.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv", "convolution"})
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "log", "log2", "log10", "log1p", "expm1", "tanh", "sigmoid", "erf", "erfc", "erfinv", "sin",
    "cos", "tan", "pow", "rsqrt", "sqrt", "digamma", "lgamma", "silu", "gelu",
})
_REDUCE = frozenset({
    "sum", "amax", "amin", "max", "min", "prod", "mean", "argmax", "argmin", "cumsum", "cumprod", "cummax",
    "cummin", "logcumsumexp", "any", "all", "logsumexp", "linalg_vector_norm", "norm", "var", "std",
})
_FREE = frozenset({
    # views and shape
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute", "transpose", "t", "squeeze",
    "unsqueeze", "slice", "select", "as_strided", "alias", "detach", "unfold", "narrow", "split", "split_with_sizes",
    "unbind", "chunk", "flatten", "unflatten", "view_as_real", "view_as_complex", "lift_fresh",
    # copies and casts
    "clone", "copy", "_to_copy", "to", "contiguous", "_copy_from", "_copy_from_and_resize", "repeat",
    "repeat_interleave", "cat", "stack", "constant_pad_nd", "flip", "roll",
    # gathers, scatters and selects
    "index", "index_select", "gather", "index_put", "_index_put_impl", "scatter", "embedding", "where",
    "masked_fill", "masked_select", "nonzero",
    # fills and factories
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like", "new_zeros",
    "ones", "ones_like", "new_ones", "full", "full_like", "new_full", "fill", "zero", "arange", "scalar_tensor",
    "_local_scalar_dense", "lift_fresh_copy", "resize",
})
_COMPOSITE = {"_softmax": 14, "_log_softmax": 14}


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    leaves = tree if isinstance(tree, (list, tuple)) else [tree]
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _product_flops(name: str, args: tuple, out) -> int:
    if name == "convolution":
        weight = args[1]  # [out, in / groups, *kernel]
        return 2 * _numel(out) * weight.shape[1] * math.prod(weight.shape[2:])
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        args = args[1:]  # the added operand first
    a = args[0]
    k = a.shape[-1]
    return 2 * _numel(out) * k if name != "addbmm" else 2 * a.shape[0] * _numel(out) * k


def op_flops(func, args: tuple, out) -> int:
    """Nominal FLOPs of one dispatched operation ``func(*args) -> out``."""
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") else name  # in place: as out of place
    if base in _PRODUCTS:
        return _product_flops(base, args, out)
    if base in _FREE:
        return 0
    if base in _COMPOSITE:
        return _COMPOSITE[base] * sum(_numel(t) for t in _tensors(out))
    elementwise_pair = base in ("max", "min") and len(args) > 1 and isinstance(args[1], torch.Tensor)
    if base in _REDUCE and not elementwise_pair:
        return _numel(args[0]) if args else 0
    weight = 10 if base in _TRANSCENDENTAL else 1
    return weight * sum(_numel(t) for t in _tensors(out))


class FlopCounter(TorchDispatchMode):
    """Sums :func:`op_flops` over every operation dispatched while entered."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += op_flops(func, args, out)
        return out


def count_flops(fn, *args) -> int:
    """Nominal FLOPs of ``fn(*args)`` (``meta`` operands count without
    computing anything)."""
    with FlopCounter() as counter:
        fn(*args)
    return counter.total
