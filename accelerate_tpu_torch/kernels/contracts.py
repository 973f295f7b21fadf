"""Registered kernel cost contracts: the declared FLOPs, HBM bytes and
shared memory of the port's hand-written kernels.

The port's own copy of ``accelerate_tpu.kernels.contracts`` (stdlib only,
as there). A :class:`KernelCostSpec` is the hand-declared cost of one
kernel as functions of its operands (anything with ``.shape`` and
``.dtype``), so one registration covers every shape, plus an optional
interval transfer so a numerics analysis can keep proving bounds through
the call. Registration is keyed by the kernel's name.

One field differs from the reference. Its ``vmem_peak_bytes`` is a TPU
quantity (the VMEM a grid step holds); a CUDA block has shared memory
instead, so the port's specs declare ``smem_bytes``: the shared memory one
block of the kernel asks for. ``kernel-check``
(:mod:`accelerate_tpu_torch.analysis`) holds a declaration to a recount:
the FLOPs of the kernel's plain version and the bytes of its declared
tiles (TPU1006), and flags a launch with no contract (TPU1005);
``chip_smoke.py`` holds each kernel's time against the bound its spec
gives.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


class UnknownOpWarning(UserWarning):
    """An analysis walk met an opaque operation it cannot price."""


@dataclass(frozen=True)
class KernelCostSpec:
    """The declared cost contract of one kernel.

    ``flops``/``hbm_bytes``/``smem_bytes`` are called with the kernel's
    operands in argument order. ``flops`` and ``hbm_bytes`` return the
    totals of one call over the whole grid; ``smem_bytes`` the shared
    memory of one block (where the reference declares ``vmem_peak_bytes``).
    ``interval`` (optional) maps the operand value intervals, a list of
    ``(lo, hi)`` tuples, to the output's ``(lo, hi)``. ``tolerance`` is the
    relative disagreement with a recount that a checker permits.
    """

    name: str
    flops: Callable[..., float]
    hbm_bytes: Callable[..., float]
    smem_bytes: Callable[..., float]
    interval: Optional[Callable[[Sequence[tuple]], tuple]] = None
    tolerance: float = 0.25
    notes: str = ""


#: kernel name -> its registered contract
KERNEL_REGISTRY: dict[str, KernelCostSpec] = {}


def register_kernel_cost(spec: KernelCostSpec) -> KernelCostSpec:
    """Register ``spec`` (latest registration wins; returns the spec)."""
    KERNEL_REGISTRY[spec.name] = spec
    return spec


def kernel_cost(
    *,
    flops: Callable[..., float],
    hbm_bytes: Callable[..., float],
    smem_bytes: Callable[..., float],
    interval: Optional[Callable[[Sequence[tuple]], tuple]] = None,
    tolerance: float = 0.25,
    notes: str = "",
    name: Optional[str] = None,
) -> Callable:
    """Decorator form of :func:`register_kernel_cost` for the kernel's
    wrapper; the contract is registered under ``name`` (default: the
    function's ``__name__``)::

        @kernel_cost(flops=lambda x, w: ..., hbm_bytes=..., smem_bytes=...)
        def my_kernel(x, w): ...
    """

    def wrap(fn):
        register_kernel_cost(
            KernelCostSpec(
                name=name or fn.__name__,
                flops=flops,
                hbm_bytes=hbm_bytes,
                smem_bytes=smem_bytes,
                interval=interval,
                tolerance=tolerance,
                notes=notes,
            )
        )
        return fn

    return wrap


def registered_spec(name: Optional[str]) -> Optional[KernelCostSpec]:
    """The contract registered for kernel ``name``, or None."""
    if not name:
        return None
    return KERNEL_REGISTRY.get(name)


def unregister_kernel_cost(name: str) -> None:
    """Drop a registration (test hygiene for deliberately broken specs)."""
    KERNEL_REGISTRY.pop(name, None)


_WARNED_UNKNOWN: set = set()


def warn_unknown_op(analysis: str, primitive: str, blind: str) -> None:
    """One-time :class:`UnknownOpWarning` (per analysis x operation) when a
    walk meets an opaque operation it cannot price: names the operation
    and the quantity the analysis is now blind to."""
    key = (analysis, primitive)
    if key in _WARNED_UNKNOWN:
        return
    _WARNED_UNKNOWN.add(key)
    warnings.warn(
        f"{analysis}: opaque operation '{primitive}' has no registered "
        f"KernelCostSpec, so its {blind} is counted as ZERO. Register a "
        "contract (accelerate_tpu_torch.kernels.contracts.kernel_cost).",
        UnknownOpWarning,
        stacklevel=3,
    )


def reset_unknown_op_warnings() -> None:
    """Clear the warn-once memory (tests pin warn-once)."""
    _WARNED_UNKNOWN.clear()
