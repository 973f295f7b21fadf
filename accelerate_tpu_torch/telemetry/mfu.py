"""MFU / goodput accounting and live device-memory sampling.

Counterpart of :mod:`accelerate_tpu.telemetry.mfu`. MFU is achieved model
FLOP/s over the card's peak (:data:`..analysis.costmodel.PEAK_FLOPS_TABLE`,
the H100's dense datasheet figures), with the JAX package's default
compute type, bf16. The model FLOPs of a step come from the caller: an
analytic count (``6 x params x tokens`` plus attention), or
:func:`flops_from_compiled`, which counts one call with
``torch.utils.flop_counter.FlopCounterMode`` (eager PyTorch has no XLA
cost analysis; the counter sees ATen operators, so the FLOPs of a
hand-written kernel launched through ``ctypes`` are not in it).

The memory sampler reads ``torch.cuda.memory_stats()`` and cross-checks
the observed peak against a static estimate, when one is attached, with
one ``hbm_drift`` warning past ``drift_threshold`` (default 20%).
"""

from __future__ import annotations

from typing import Optional

from ..analysis.costmodel import DEFAULT_GENERATION, HBM_GB_TABLE, PEAK_FLOPS_TABLE, device_generation, peak_flops
from .eventlog import EventLog

__all__ = [
    "PEAK_FLOPS_TABLE",
    "HBM_GB_TABLE",
    "device_generation",
    "peak_flops",
    "mfu",
    "goodput",
    "flops_from_compiled",
    "HBMSampler",
]


def mfu(
    flops_per_step: float,
    step_time_s: float,
    n_devices: int = 1,
    *,
    generation: Optional[str] = None,
    dtype: str = "bf16",
    peak: Optional[float] = None,
) -> float:
    """Model FLOPs utilisation in [0, ~1]. ``peak`` (FLOP/s per device)
    overrides the table; otherwise ``generation`` (or the attached card's,
    or the H100 row without a card) picks the row."""
    if step_time_s <= 0:
        raise ValueError(f"step_time_s must be > 0, got {step_time_s}")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if peak is None:
        peak = peak_flops(generation or device_generation() or DEFAULT_GENERATION, dtype)
    return flops_per_step / step_time_s / (peak * n_devices)


def goodput(records: list[dict]) -> Optional[float]:
    """Fraction of wall time spent dispatching+executing (vs waiting for
    data) over a list of :class:`StepTelemetry` records."""
    total = sum(r.get("dur_ms", 0.0) for r in records)
    if total <= 0:
        return None
    busy = sum(r.get("dispatch_ms", 0.0) + r.get("execute_ms", 0.0) for r in records)
    return min(1.0, busy / total)


def flops_from_compiled(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (the call runs: a train
    step trains a step), or None when ``fn`` is not callable or nothing
    was counted. The counter sees ATen operators only: a kernel launched
    through ``ctypes`` (the port's flash attention) adds nothing."""
    if not callable(fn):
        return None
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def _default_stats():
    """The card's current and peak allocated bytes and its total memory
    (``torch.cuda.memory_stats()``); None without a card."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    s = torch.cuda.memory_stats()
    return {
        "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory),
    }


class HBMSampler:
    """Periodic device-memory sampler + static-vs-observed drift check.

    The samples come from ``torch.cuda.memory_stats()`` (the caching
    allocator's current and peak allocated bytes; the limit is the card's
    total memory); without a card nothing is sampled. ``static_peak_bytes``
    is a static per-device estimate (the JAX package's flight check gives
    one; the port's is ROADMAP.md Queue 1 item 11); when given, it is
    logged once as an ``hbm_static_estimate`` event and every
    :meth:`sample` cross-checks the observed peak against it, emitting ONE
    ``hbm_drift`` warning the first time they disagree by more than
    ``drift_threshold``. ``stats_fn`` is injectable for tests.
    """

    def __init__(
        self,
        log: Optional[EventLog] = None,
        *,
        static_peak_bytes: Optional[int] = None,
        drift_threshold: float = 0.2,
        stats_fn=None,
    ):
        self.log = log if log is not None else EventLog(None)
        self.static_peak_bytes = static_peak_bytes
        self.drift_threshold = drift_threshold
        self._stats_fn = stats_fn or _default_stats
        self.observed_peak_bytes = 0
        self.samples = 0
        self.drift_event: Optional[dict] = None
        if static_peak_bytes is not None:
            self.log.event("hbm_static_estimate", bytes=int(static_peak_bytes))

    def sample(self) -> Optional[dict]:
        """Read live memory; returns the stats dict (or None without a
        card)."""
        stats = self._stats_fn()
        if stats is None:
            return None
        self.samples += 1
        self.observed_peak_bytes = max(self.observed_peak_bytes, stats["peak_bytes_in_use"])
        self.log.counter("hbm_bytes_in_use", stats["bytes_in_use"])
        self.log.counter(
            "hbm_peak_bytes",
            self.observed_peak_bytes,
            bytes_limit=stats.get("bytes_limit"),
        )
        self._check_drift()
        return stats

    def _check_drift(self):
        if (
            self.drift_event is not None
            or not self.static_peak_bytes
            or not self.observed_peak_bytes
        ):
            return
        rel = abs(self.observed_peak_bytes - self.static_peak_bytes) / self.static_peak_bytes
        if rel > self.drift_threshold:
            self.drift_event = self.log.event(
                "hbm_drift",
                severity="warning",
                observed_peak_bytes=self.observed_peak_bytes,
                static_peak_bytes=int(self.static_peak_bytes),
                rel_error=round(rel, 4),
                threshold=self.drift_threshold,
            )

    def headroom_bytes(self, hbm_gb: Optional[float] = None) -> Optional[int]:
        """Bytes between the observed peak and the card's memory (the
        attached card's row of ``HBM_GB_TABLE`` when ``hbm_gb`` is
        omitted)."""
        if hbm_gb is None:
            gen = device_generation()
            if gen is None:
                return None
            hbm_gb = HBM_GB_TABLE.get(gen, HBM_GB_TABLE[DEFAULT_GENERATION])
        if not self.observed_peak_bytes:
            return None
        return int(hbm_gb * 1024**3) - self.observed_peak_bytes
