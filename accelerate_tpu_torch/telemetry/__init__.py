"""Runtime observability: the step timeline, the recompile watchdog,
MFU and goodput, device-memory sampling, the non-finite watchdog, the
serving metrics, request tracing, the flight recorder and the
critical-path monitor, on one JSONL event stream, and the offline
``summarize`` over it.

Counterpart of :mod:`accelerate_tpu.telemetry`, with the same schema and
line format. Quick start::

    from accelerate_tpu_torch.telemetry import Telemetry

    tel = Telemetry("run.jsonl")
    step = tel.wrap(step)             # instruments every call
    for batch in loader:
        loss = step(batch)
    tel.close()

or, through the Accelerator (the usual path)::

    accelerator = Accelerator(kwargs_handlers=[TelemetryKwargs(...)])
    step = accelerator.telemetry.wrap(accelerator.build_train_step(loss_fn))

:class:`TelemetryHTTPD` serves ``/metrics``, ``/healthz`` and ``/traces``
over HTTP, and the multi-process fleet's ``/v1/generate`` front door.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP.md
Queue 1 item: the wire-byte counters (``hlo_wire_bytes``,
``Telemetry.record_wire_bytes``: item 8, with the collectives whose bytes
they count; the JAX package reads them from compiled HLO, which the port
never produces).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from .eventlog import SCHEMA_VERSION, EventLog, merge_events, read_events
from .mfu import (
    HBM_GB_TABLE,
    PEAK_FLOPS_TABLE,
    HBMSampler,
    device_generation,
    flops_from_compiled,
    goodput,
    mfu,
    peak_flops,
)
from .critpath import CritPathMonitor, decompose, render_critpath
from .flightrec import FlightRecorder, read_dump, render_dump
from .httpd import SLO_CLASSES, TelemetryHTTPD
from .nonfinite import NonFiniteWatchdog
from .serving_metrics import ServingMetrics, fleet_prometheus_text
from .step import StepTelemetry, diff_signatures, signature_of, suggest_buckets
from .summarize import render_text, summarize, summarize_file
from .trace import Span, Trace, TraceConfig, Tracer, chrome_trace, traces_from_events

__all__ = [
    "SCHEMA_VERSION",
    "EventLog",
    "read_events",
    "merge_events",
    "StepTelemetry",
    "signature_of",
    "diff_signatures",
    "suggest_buckets",
    "HBMSampler",
    "NonFiniteWatchdog",
    "ServingMetrics",
    "fleet_prometheus_text",
    "summarize",
    "summarize_file",
    "render_text",
    "Span",
    "Trace",
    "Tracer",
    "TraceConfig",
    "traces_from_events",
    "chrome_trace",
    "FlightRecorder",
    "read_dump",
    "render_dump",
    "TelemetryHTTPD",
    "SLO_CLASSES",
    "CritPathMonitor",
    "decompose",
    "render_critpath",
    "Telemetry",
    "default_path",
    "PEAK_FLOPS_TABLE",
    "HBM_GB_TABLE",
    "device_generation",
    "peak_flops",
    "mfu",
    "goodput",
    "flops_from_compiled",
]


def _not_ported(name: str, module: str, item: int):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: telemetry/{module}.py is not ported to accelerate_tpu_torch yet (ROADMAP.md Queue 1 item {item})"
        )

    refuse.__name__ = name
    return refuse


hlo_wire_bytes = _not_ported("hlo_wire_bytes", "wire", 8)


class Telemetry:
    """Facade bundling one :class:`EventLog`, one :class:`StepTelemetry`,
    one :class:`HBMSampler` and one :class:`NonFiniteWatchdog` for a run:
    what ``Accelerator.telemetry`` hands out.

    ``hbm_sample_every=N`` samples device memory every N wrapped steps;
    ``forward_fn`` + ``forward_every=N`` push a rolling summary dict to a
    callback every N steps (the Accelerator wires ``Accelerator.log`` in
    here, so step time, MFU and recompile counts land in the active
    trackers). ``static_hbm_bytes`` seeds the drift check with a static
    estimate. ``nonfinite_every=N`` turns the finiteness probe on (0 =
    off: each probe is a host sync).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        rank: Optional[int] = None,
        main_process_only: bool = True,
        warmup_steps: int = 2,
        fence: bool = True,
        watchdog: bool = True,
        flops_per_step: Optional[float] = None,
        peak_flops_per_device: Optional[float] = None,
        n_devices: int = 1,
        hbm_sample_every: int = 10,
        static_hbm_bytes: Optional[int] = None,
        hbm_drift_threshold: float = 0.2,
        forward_fn: Optional[Callable[[dict, Optional[int]], None]] = None,
        forward_every: int = 0,
        nonfinite_every: int = 0,
    ):
        self.log = EventLog(path, rank=rank, main_process_only=main_process_only)
        self.steps = StepTelemetry(
            self.log,
            warmup_steps=warmup_steps,
            fence=fence,
            watchdog=watchdog,
            flops_per_step=flops_per_step,
            peak_flops_per_device=peak_flops_per_device,
            n_devices=n_devices,
        )
        self.hbm = HBMSampler(
            self.log, static_peak_bytes=static_hbm_bytes, drift_threshold=hbm_drift_threshold
        )
        self.nonfinite = NonFiniteWatchdog(self.log, every=nonfinite_every)
        self._hbm_sample_every = max(0, int(hbm_sample_every))
        self._forward_fn = forward_fn
        self._forward_every = max(0, int(forward_every))
        self.steps.on_step = self._on_step

    # -- delegation ----------------------------------------------------- #

    @property
    def path(self) -> Optional[str]:
        return self.log.path

    @property
    def recompiles(self) -> int:
        return self.steps.recompiles

    def wrap(self, step_fn: Callable, **kwargs) -> Callable:
        return self.steps.wrap(step_fn, **kwargs)

    def step(self, batch=None, **kwargs):
        return self.steps.step(batch, **kwargs)

    def event(self, name: str, **fields) -> dict:
        return self.log.event(name, **fields)

    def record_wire_bytes(self, *args, **kwargs) -> dict:
        """The wire-byte counters: the bytes of the collectives a
        multi-process step runs (``telemetry/wire.py``), ROADMAP.md Queue 1
        item 8; at one process on one card there are none."""
        raise NotImplementedError(
            "Telemetry.record_wire_bytes: telemetry/wire.py is not ported to accelerate_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 8)"
        )

    def set_static_hbm_estimate(self, peak_bytes: int):
        """Attach a static peak-memory estimate after construction."""
        self.hbm.static_peak_bytes = int(peak_bytes)
        self.log.event("hbm_static_estimate", bytes=int(peak_bytes))

    def set_static_step_estimate(self, predicted_ms: float, *, threshold=None):
        """Attach a static step-time prediction after construction; arms
        the one-shot ``perf_model_drift`` cross-check in
        :class:`StepTelemetry`."""
        self.steps.set_static_step_estimate(predicted_ms, threshold=threshold)

    def summary(self) -> dict:
        out = self.steps.summary()
        if self.hbm.observed_peak_bytes:
            out["observed_peak_hbm_bytes"] = self.hbm.observed_peak_bytes
        if self.hbm.static_peak_bytes:
            out["static_peak_hbm_bytes"] = int(self.hbm.static_peak_bytes)
        if self.nonfinite.enabled or self.nonfinite.probes:
            out["nonfinite"] = self.nonfinite.summary()
        return out

    def flush(self):
        self.log.flush()

    def close(self):
        self.log.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- per-step plumbing ---------------------------------------------- #

    def _on_step(self, rec: dict):
        i = rec["step"]
        if self._hbm_sample_every and i % self._hbm_sample_every == 0:
            self.hbm.sample()
        if self._forward_fn is not None and self._forward_every and i > 0 and i % self._forward_every == 0:
            recent = [r for r in list(self.steps.records)[-self._forward_every:] if not r["compile"]]
            values = {
                "telemetry/step_ms": round(
                    sum(r["dur_ms"] for r in recent) / len(recent), 3
                ) if recent else None,
                "telemetry/data_wait_ms": round(
                    sum(r["data_wait_ms"] for r in recent) / len(recent), 3
                ) if recent else None,
                "telemetry/recompiles": self.steps.recompiles,
            }
            mfus = [r["mfu"] for r in recent if "mfu" in r]
            if mfus:
                values["telemetry/mfu"] = round(sum(mfus) / len(mfus), 5)
            if self.hbm.observed_peak_bytes:
                values["telemetry/peak_hbm_bytes"] = self.hbm.observed_peak_bytes
            self._forward_fn({k: v for k, v in values.items() if v is not None}, i)


def default_path(logging_dir: Optional[str] = None) -> str:
    """Default event-log location: ``{logging_dir}/telemetry.jsonl``, or
    ``runs/telemetry.jsonl`` without a logging or project dir (a bare
    ``Accelerator`` must not litter the working directory)."""
    return os.path.join(logging_dir or "runs", "telemetry.jsonl")
