"""Fleet-wide request tracing: one trace per ``submit()``, spans per
serving phase, exports an operator can load.

A copy of :mod:`accelerate_tpu.telemetry.trace` (stdlib only), kept
here so the port imports nothing of the JAX package.

The serving stack already *aggregates* well (``ServingMetrics`` windows,
``telemetry summarize``), but aggregates cannot answer the first
production question: *where did this request's p95 TTFT go* once it
crossed router -> prefill replica -> KV handoff -> decode replica ->
(maybe) failover. This module holds the per-request answer:

* a :class:`Tracer` mints one trace id per ``FleetRouter.submit()`` /
  ``ServingEngine.submit()`` and collects :class:`Span` segments —
  ``queue_wait``, ``admit``, each prefill chunk window, ``kv_handoff``,
  ``decode`` (per-tick, aggregated into windows), ``preempt`` /
  ``resume``, ``failover``, and ``drain`` migration;
* segments are **frontier-contiguous**: each new segment covers the gap
  since the trace's last covered timestamp, so the segment sum
  reconciles with the request's end-to-end latency by construction (the
  property ``chip_smoke.py``'s ``fleet_telemetry`` phase gates on).
  Compute-only timings
  ride in span meta (``compute_ms``) where a predictor cross-check needs
  them (:mod:`~accelerate_tpu_torch.telemetry.critpath`);
* the trace id rides the request record through
  ``FleetRouter``/``ServingEngine``/``scheduling.py``, is serialized
  inside the ``HandoffCodec`` blob (schema v2; v1 blobs still decode),
  and rides ``export_inflight`` snapshots — traces survive disaggregated
  dispatch and failover, and a socket transport between replica
  processes inherits a context field instead of retrofitting one;
* exports: JSONL (eventlog-compatible ``trace.*`` span records + one
  ``trace_complete`` event, merged by ``telemetry summarize``) and
  Chrome trace-event JSON loadable in Perfetto (one ``tid`` per
  request).

Nothing but the stdlib is imported here.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

#: segment classes a trace may carry, in rough request-lifecycle order.
SEGMENTS = (
    "queue_wait",
    "admit",
    "prefill",
    "kv_handoff",
    "decode",
    "preempt",
    "resume",
    "failover",
    "drain",
)

#: eventlog record-name prefix for exported span segments.
TRACE_EVENT_PREFIX = "trace."

#: terminal trace statuses (``open`` is the only non-terminal one).
STATUSES = ("open", "ok", "shed", "cancelled", "lost", "failed")


@dataclass
class Span:
    """One contiguous segment of a request's wall-clock timeline."""

    name: str
    t0: float
    t1: float
    meta: dict = field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return max(0.0, (self.t1 - self.t0) * 1000.0)


@dataclass
class Trace:
    """One request's timeline: id, status, and its segment spans."""

    id: int
    t0: float
    meta: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    t1: Optional[float] = None
    status: str = "open"
    #: end of the last covered segment — the next span starts here.
    frontier: float = 0.0
    #: name of the mergeable open window (decode tick aggregation).
    window: Optional[str] = None

    def to_dict(self) -> dict:
        dur = ((self.t1 if self.t1 is not None else self.frontier) - self.t0) * 1000.0
        return {
            "id": self.id,
            "t0": self.t0,
            "status": self.status,
            "dur_ms": round(max(0.0, dur), 3),
            "meta": dict(self.meta),
            "spans": [
                {
                    "name": s.name,
                    "t0_ms": round((s.t0 - self.t0) * 1000.0, 3),
                    "dur_ms": round(s.dur_ms, 3),
                    **s.meta,
                }
                for s in self.spans
            ],
        }


@dataclass
class TraceConfig:
    """Knobs for ``FleetRouter(trace=...)`` / ``TelemetryKwargs``."""

    enabled: bool = True
    #: completed traces retained in memory (served by ``/traces``).
    max_traces: int = 4096
    #: per-replica flight recorder (see :mod:`~.flightrec`).
    flight_recorder: bool = True
    flight_capacity: int = 256
    #: directory for crash dumps; ``None`` keeps dumps in memory only.
    flight_dump_dir: Optional[str] = None
    #: cross-check each segment against its predictor (see :mod:`~.critpath`).
    drift_check: bool = True
    drift_thresholds: Optional[dict] = None

    def __post_init__(self):
        if self.max_traces < 1:
            raise ValueError(f"max_traces must be >= 1, got {self.max_traces}")
        if self.flight_capacity < 8:
            raise ValueError(f"flight_capacity must be >= 8, got {self.flight_capacity}")


class Tracer:
    """Thread-safe collector for request traces.

    Instrumentation sites call :meth:`seg` (one distinct span per call —
    prefill chunk windows, handoff, failover) or :meth:`window`
    (consecutive same-name calls merge — per-tick decode aggregation).
    Both are frontier-contiguous; mutation is O(1) under one ``RLock``
    and nothing blocking ever runs under it (export/formatting snapshot
    first, format outside).
    """

    def __init__(
        self,
        *,
        max_traces: int = 4096,
        clock: Callable[[], float] = time.monotonic,
        log=None,
        on_finish: Optional[Callable[[dict], None]] = None,
    ):
        self._lock = threading.RLock()
        self._clock = clock
        self._ids = itertools.count(1)
        self._open: dict[int, Trace] = {}
        self._done: list[dict] = []
        self._max_traces = max(1, int(max_traces))
        self.log = log
        self.on_finish = on_finish
        self.started = 0
        self.finished = 0

    # ------------------------------------------------------------------ #
    # recording surface (called from serving hot paths; cheap, guarded)
    # ------------------------------------------------------------------ #

    def start(self, **meta) -> int:
        """Mint a trace; the returned id is the context that rides the
        request record (and the handoff blob / failover snapshot)."""
        now = self._clock()
        with self._lock:
            tid = next(self._ids)
            self._open[tid] = Trace(id=tid, t0=now, meta=dict(meta), frontier=now)
            self.started += 1
        return tid

    def attach(self, trace_id: Optional[int], **meta) -> None:
        """Merge ``meta`` into an open trace (fuid, uid, ttft...)."""
        if trace_id is None:
            return
        with self._lock:
            tr = self._open.get(trace_id)
            if tr is not None:
                tr.meta.update(meta)

    def seg(self, trace_id: Optional[int], name: str, *, end: Optional[float] = None, **meta) -> None:
        """Close the segment ``[frontier, end]`` as one distinct span."""
        if trace_id is None:
            return
        end = self._clock() if end is None else end
        with self._lock:
            tr = self._open.get(trace_id)
            if tr is None:
                return
            tr.spans.append(Span(name, tr.frontier, max(tr.frontier, end), meta))
            tr.frontier = max(tr.frontier, end)
            tr.window = None

    def window(
        self, trace_id: Optional[int], name: str, *, end: Optional[float] = None, tokens: int = 0, **meta
    ) -> None:
        """Like :meth:`seg`, but consecutive same-name windows merge into
        one span (``tokens`` accumulates) — per-tick decode aggregation."""
        if trace_id is None:
            return
        end = self._clock() if end is None else end
        with self._lock:
            tr = self._open.get(trace_id)
            if tr is None:
                return
            end = max(tr.frontier, end)
            if tr.window == name and tr.spans and tr.spans[-1].name == name:
                span = tr.spans[-1]
                span.t1 = end
                span.meta["tokens"] = span.meta.get("tokens", 0) + int(tokens)
                span.meta.update(meta)
            else:
                m = dict(meta)
                m["tokens"] = int(tokens)
                tr.spans.append(Span(name, tr.frontier, end, m))
                tr.window = name
            tr.frontier = end

    def finish(self, trace_id: Optional[int], status: str = "ok", **meta) -> Optional[dict]:
        """Seal the trace, move it to the completed ring, export its span
        records to the attached eventlog, and run the ``on_finish`` hook
        (the critical-path drift monitor). Returns the trace dict."""
        if trace_id is None:
            return None
        now = self._clock()
        with self._lock:
            tr = self._open.pop(trace_id, None)
            if tr is None:
                return None
            tr.t1 = max(tr.frontier, now)
            tr.status = status
            tr.meta.update(meta)
            self.finished += 1
            out = tr.to_dict()
            self._done.append(out)
            if len(self._done) > self._max_traces:
                del self._done[: len(self._done) - self._max_traces]
        # formatting + hooks OUTSIDE the lock (log may flush to disk)
        log = self.log
        if log is not None:
            _emit_trace(log, out)
        hook = self.on_finish
        if hook is not None:
            hook(out)
        return out

    def discard(self, trace_id: Optional[int]) -> None:
        """Drop an open trace without exporting (duplicate-submit paths)."""
        if trace_id is None:
            return
        with self._lock:
            self._open.pop(trace_id, None)

    # ------------------------------------------------------------------ #
    # read surface
    # ------------------------------------------------------------------ #

    def completed(self, n: Optional[int] = None) -> list[dict]:
        """Most recent ``n`` completed traces (all when ``n`` is None)."""
        with self._lock:
            out = list(self._done)
        return out if n is None else out[-int(n):]

    def open_spans(self) -> list[dict]:
        """Snapshot of in-flight traces — the flight recorder dumps this
        next to the last-N event tail on a crash."""
        now = self._clock()
        with self._lock:
            snap = [
                {
                    "trace": tr.id,
                    "age_ms": round((now - tr.t0) * 1000.0, 3),
                    "segment": tr.spans[-1].name if tr.spans else None,
                    "spans": len(tr.spans),
                    "meta": dict(tr.meta),
                }
                for tr in self._open.values()
            ]
        return snap

    # ------------------------------------------------------------------ #
    # exports
    # ------------------------------------------------------------------ #

    def export_jsonl(self, path: str) -> int:
        """Write completed traces as eventlog-compatible JSONL (the same
        records the live log receives); returns the trace count."""
        from .eventlog import EventLog

        traces = self.completed()
        log = EventLog(path, rank=0, main_process_only=False, buffer_lines=1024)
        try:
            for tr in traces:
                _emit_trace(log, tr)
        finally:
            log.close()
        return len(traces)

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable); writes ``path``
        when given and returns the document."""
        doc = chrome_trace(self.completed())
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _emit_trace(log, trace: dict) -> None:
    """Emit one completed trace into an :class:`EventLog`: a ``trace.*``
    span record per segment, then one ``trace_complete`` event carrying
    the per-class totals."""
    totals: dict[str, float] = {}
    for sp in trace["spans"]:
        fields = {k: v for k, v in sp.items() if k != "name"}
        log.emit("span", TRACE_EVENT_PREFIX + sp["name"], trace=trace["id"], **fields)
        totals[sp["name"]] = round(totals.get(sp["name"], 0.0) + sp["dur_ms"], 3)
    log.event(
        "trace_complete",
        trace=trace["id"],
        status=trace["status"],
        dur_ms=trace["dur_ms"],
        segments=totals,
        **{k: v for k, v in trace["meta"].items() if isinstance(v, (int, float, str, bool))},
    )


def traces_from_events(events: list[dict]) -> list[dict]:
    """Reconstruct trace dicts from eventlog records (the inverse of
    :func:`_emit_trace`) — how the ``summarize`` traces section reads a
    JSONL."""
    by_id: dict[int, dict] = {}
    for rec in events:
        name = rec.get("name", "")
        tid = rec.get("trace")
        if tid is None:
            continue
        if rec.get("kind") == "span" and name.startswith(TRACE_EVENT_PREFIX):
            tr = by_id.setdefault(tid, {"id": tid, "status": "open", "dur_ms": 0.0, "meta": {}, "spans": []})
            span = {k: v for k, v in rec.items() if k not in ("v", "seq", "ts", "rank", "kind", "name", "trace")}
            span["name"] = name[len(TRACE_EVENT_PREFIX):]
            tr["spans"].append(span)
        elif rec.get("kind") == "event" and name == "trace_complete":
            tr = by_id.setdefault(tid, {"id": tid, "status": "open", "dur_ms": 0.0, "meta": {}, "spans": []})
            tr["status"] = rec.get("status", "ok")
            tr["dur_ms"] = rec.get("dur_ms", tr["dur_ms"])
            # anchor an absolute start so chrome export can place the trace
            tr["t0"] = rec.get("ts", 0.0) - tr["dur_ms"] / 1000.0
            tr["meta"] = {
                k: v
                for k, v in rec.items()
                if k not in ("v", "seq", "ts", "rank", "kind", "name", "trace", "status", "dur_ms", "segments", "severity")
            }
    return list(by_id.values())


def chrome_trace(traces: list[dict]) -> dict:
    """Chrome trace-event document: ``ph:"X"`` complete events, one
    ``tid`` per request, span meta in ``args`` — drop the file on
    https://ui.perfetto.dev and read the decomposition off the timeline."""
    base = min((tr.get("t0", 0.0) for tr in traces), default=0.0)
    out: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "accelerate_tpu_torch serving"}}
    ]
    for tr in traces:
        label = tr.get("meta", {}).get("fuid", tr.get("meta", {}).get("uid", tr["id"]))
        out.append(
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": tr["id"], "args": {"name": f"request {label}"}}
        )
        t0 = tr.get("t0", 0.0)
        for sp in tr["spans"]:
            args = {k: v for k, v in sp.items() if k not in ("name", "t0_ms", "dur_ms")}
            args["status"] = tr.get("status", "open")
            out.append(
                {
                    "name": sp["name"],
                    "cat": "request",
                    "ph": "X",
                    "ts": round((t0 - base) * 1e6 + sp.get("t0_ms", 0.0) * 1e3, 3),
                    "dur": round(sp.get("dur_ms", 0.0) * 1e3, 3),
                    "pid": 0,
                    "tid": tr["id"],
                    "args": args,
                }
            )
    return {"displayTimeUnit": "ms", "traceEvents": out}
