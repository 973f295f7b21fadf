"""Per-request critical-path decomposition, cross-checked against the
analyzers that predicted each segment.

A copy of :mod:`accelerate_tpu.telemetry.critpath` (stdlib only), kept
here so the port imports nothing of the JAX package.

:func:`decompose` turns completed traces
(:mod:`~accelerate_tpu_torch.telemetry.trace`) into the operator table:
segment p50/p95 per class, per-request segment sums, and the share of
end-to-end latency each class claims. :class:`CritPathMonitor` is the
live half — the house predicted-vs-measured discipline applied per
request:

* ``queue_wait``  vs the scheduler's own accounting (``on_admit``'s
  ``queue_wait_ms``, carried in span meta as ``accounted_ms``);
* ``prefill``     vs ``perfmodel``/``costmodel.prefill_compute_us``
  (span meta ``compute_ms`` — the compute-only timing, not the
  frontier span which absorbs queueing);
* ``kv_handoff``  vs ``costmodel.price_kv_handoff`` (``moved_bytes``
  must equal ``predicted_bytes`` byte-for-byte);
* ``failover``    vs ``costmodel.price_failover`` (same byte equality
  on the KV path).

Each segment class gets ONE latched ``trace_drift`` warning — the
``hbm_drift`` / ``perf_model_drift`` discipline: the first excursion is
signal, the next thousand are noise. ``reset()`` re-arms (e.g. after a
fleet reconfiguration). Stdlib-only; predictors arrive as injected
callables.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

#: segment classes with a live predictor cross-check.
CHECKED_SEGMENTS = ("queue_wait", "prefill", "kv_handoff", "failover")

#: default relative-error latch thresholds per checked class. Byte
#: checks (handoff/failover) are exact — any mismatch latches; time
#: checks latch past the threshold AND an absolute floor (tiny segments
#: under coarse clocks are noise, the hbm_sampler lesson).
DEFAULT_THRESHOLDS = {
    "queue_wait": 0.5,
    "prefill": 2.0,
    "kv_handoff": 0.0,
    "failover": 0.0,
}

#: absolute floor (ms) below which a time-segment excursion never latches.
DEFAULT_MIN_MS = 2.0


def _percentile(values: list, q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
    return xs[idx]


def decompose(traces: list[dict]) -> dict:
    """Aggregate completed traces into the critical-path report.

    Returns ``{"count", "completed", "by_class": {seg: {count, total_ms,
    p50_ms, p95_ms, share}}, "requests": [...]}`` where ``share`` is the
    class's fraction of summed end-to-end latency across completed
    requests."""
    by_class: dict[str, list] = {}
    requests = []
    total_e2e = 0.0
    completed = 0
    for tr in traces:
        segs: dict[str, float] = {}
        for sp in tr.get("spans", []):
            segs[sp["name"]] = round(segs.get(sp["name"], 0.0) + sp.get("dur_ms", 0.0), 3)
            by_class.setdefault(sp["name"], []).append(sp.get("dur_ms", 0.0))
        seg_sum = round(sum(segs.values()), 3)
        row = {
            "id": tr.get("id"),
            "status": tr.get("status", "open"),
            "dur_ms": tr.get("dur_ms", 0.0),
            "segment_sum_ms": seg_sum,
            "segments": segs,
        }
        for key in ("fuid", "uid"):
            if key in tr.get("meta", {}):
                row[key] = tr["meta"][key]
        requests.append(row)
        if tr.get("status") == "ok":
            completed += 1
            total_e2e += tr.get("dur_ms", 0.0)
    table = {}
    for name, durs in sorted(by_class.items()):
        total = sum(durs)
        table[name] = {
            "count": len(durs),
            "total_ms": round(total, 3),
            "p50_ms": round(_percentile(durs, 0.50), 3),
            "p95_ms": round(_percentile(durs, 0.95), 3),
            "share": round(total / total_e2e, 4) if total_e2e > 0 else 0.0,
        }
    return {"count": len(traces), "completed": completed, "by_class": table, "requests": requests}


def render_critpath(report: dict, *, drift: Optional[list] = None) -> str:
    """Text table for the CLI / summarize ``traces:`` section body."""
    lines = [f"traces: {report['count']} recorded, {report['completed']} completed ok"]
    if report["by_class"]:
        lines.append("    segment         count   p50_ms    p95_ms    total_ms  share")
        for name, row in report["by_class"].items():
            lines.append(
                f"    {name:<15} {row['count']:>5} {row['p50_ms']:>9.3f} {row['p95_ms']:>9.3f}"
                f" {row['total_ms']:>11.3f}  {row['share']:.1%}"
            )
    for d in drift or []:
        lines.append(
            f"    DRIFT: {d['segment']} {d['check']}: observed {d['observed']} vs predicted "
            f"{d['predicted']} (rel {d['rel_error']:.2f}, trace {d['trace']})"
        )
    return "\n".join(lines)


class CritPathMonitor:
    """Live per-request drift checks with one latched warning per
    segment class, wired as ``Tracer(on_finish=monitor.observe)``."""

    def __init__(
        self,
        log=None,
        *,
        price_prefill_us: Optional[Callable[[int], float]] = None,
        thresholds: Optional[dict] = None,
        min_ms: float = DEFAULT_MIN_MS,
    ):
        self.log = log
        self.price_prefill_us = price_prefill_us
        self.thresholds = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            self.thresholds.update(thresholds)
        self.min_ms = float(min_ms)
        #: segment class -> the latched trace_drift record (the latch).
        self.drift_events: dict[str, dict] = {}
        self.observed = 0

    def reset(self) -> None:
        """Re-arm every latch (the ``set_static_step_estimate`` move)."""
        self.drift_events = {}

    # ------------------------------------------------------------------ #

    def observe(self, trace: dict) -> None:
        """Cross-check one completed trace; latch at most one
        ``trace_drift`` per segment class, ever."""
        self.observed += 1
        if trace.get("status") not in ("ok", "lost"):
            return
        for check in self._checks(trace):
            seg = check["segment"]
            if seg in self.drift_events:
                continue
            rec = dict(check)
            rec["trace"] = trace.get("id")
            if self.log is not None:
                rec = self.log.event("trace_drift", severity="warning", **rec)
            self.drift_events[seg] = rec

    def _checks(self, trace: dict):
        """Yield drift dicts for every segment whose observation left its
        predictor's tolerance."""
        for sp in trace.get("spans", []):
            name = sp["name"]
            if name == "queue_wait" and sp.get("accounted_ms") is not None:
                yield from self._time_check(name, "scheduler_accounting", sp["dur_ms"], sp["accounted_ms"])
            elif name == "prefill" and self.price_prefill_us is not None and sp.get("compute_ms") is not None:
                tokens = int(sp.get("tokens", 0))
                if tokens > 0:
                    predicted_ms = float(self.price_prefill_us(tokens)) / 1000.0
                    yield from self._time_check(name, "prefill_compute_us", sp["compute_ms"], predicted_ms)
            elif name in ("kv_handoff", "failover", "drain"):
                moved = sp.get("moved_bytes")
                predicted = sp.get("predicted_bytes")
                if moved is None or predicted is None:
                    continue
                if sp.get("path", "handoff") != "handoff":
                    continue  # recompute failovers move no KV by design
                if int(moved) != int(predicted):
                    seg = "failover" if name == "drain" else name
                    rel = abs(moved - predicted) / max(1, predicted)
                    yield {
                        "segment": seg,
                        "check": "price_kv_handoff" if seg == "kv_handoff" else "price_failover",
                        "observed": int(moved),
                        "predicted": int(predicted),
                        "rel_error": round(rel, 4),
                        "threshold": self.thresholds.get(seg, 0.0),
                    }

    def _time_check(self, segment: str, check: str, observed_ms: float, predicted_ms: float):
        threshold = self.thresholds.get(segment, 1.0)
        rel = abs(observed_ms - predicted_ms) / max(predicted_ms, 1e-9)
        if rel > threshold and abs(observed_ms - predicted_ms) > self.min_ms:
            yield {
                "segment": segment,
                "check": check,
                "observed": round(observed_ms, 3),
                "predicted": round(predicted_ms, 3),
                "rel_error": round(rel, 4),
                "threshold": threshold,
            }
