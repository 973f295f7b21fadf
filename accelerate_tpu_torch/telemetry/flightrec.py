"""Per-replica crash flight recorder: a bounded, preallocated ring of
the last N telemetry records, dumped whole when the replica dies.

A copy of :mod:`accelerate_tpu.telemetry.flightrec` (stdlib only),
kept here so the port imports nothing of the JAX package.

Aggregate telemetry answers "how is the fleet doing"; the flight
recorder answers "what were the last 256 things *this* replica did
before it crashed". It taps the replica engine's
:class:`~accelerate_tpu_torch.telemetry.eventlog.EventLog` (``add_tap``), so
every record the engine would log — admits, sheds, handoffs, replica
state flips, the poison/crash event itself — lands in the ring whether
or not a JSONL file is attached. On crash / quarantine / poison /
capacity-breaker trip the router calls :meth:`dump`, which snapshots:

* the event tail (ring order, oldest first — the injected fault's event
  is the last thing in it, which the ``ReplicaChaos`` tests assert);
* the in-flight request table the caller passes in;
* the tracer's open spans (requests caught mid-segment).

Host-concurrency discipline (replicas tick on threads of their own
under ``FleetRouter.drain_threaded``): the ring is preallocated, the lock
is an ``RLock`` held only for O(1) slot assignment or a list copy, and
all formatting/JSON/file IO happens outside it. Recording never raises
— a flight recorder that can take down the engine it observes is worse
than none.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class FlightRecorder:
    """Bounded ring buffer of telemetry records + crash-dump writer."""

    def __init__(self, capacity: int = 256, *, name: str = "", clock=time.time):
        if capacity < 8:
            raise ValueError(f"capacity must be >= 8, got {capacity}")
        self.capacity = int(capacity)
        self.name = name
        self._clock = clock
        # preallocated: recording is slot assignment, never an append
        self._ring: list = [None] * self.capacity
        self._idx = 0
        self._total = 0
        self._lock = threading.RLock()
        self.dump_count = 0
        self.last_dump: Optional[dict] = None

    # ------------------------------------------------------------------ #
    # record path (EventLog tap; hot, must never raise or block)
    # ------------------------------------------------------------------ #

    def record(self, rec: dict) -> None:
        """Store one record dict in the ring. Tap target for
        ``EventLog.add_tap`` — called inline on the emitting thread."""
        with self._lock:
            self._ring[self._idx] = rec
            self._idx = (self._idx + 1) % self.capacity
            self._total += 1

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #

    def tail(self, n: Optional[int] = None) -> list:
        """The last ``n`` records, oldest first (all retained when None).
        Snapshot under the lock; no formatting happens in here."""
        with self._lock:
            if self._total < self.capacity:
                out = [r for r in self._ring[: self._idx]]
            else:
                out = self._ring[self._idx:] + self._ring[: self._idx]
        out = [r for r in out if r is not None]
        return out if n is None else out[-int(n):]

    def __len__(self) -> int:
        with self._lock:
            return min(self._total, self.capacity)

    # ------------------------------------------------------------------ #
    # dump path (cold; called when a replica leaves the fleet)
    # ------------------------------------------------------------------ #

    def dump(
        self,
        *,
        reason: str = "",
        inflight: Optional[list] = None,
        open_spans: Optional[list] = None,
        path: Optional[str] = None,
    ) -> dict:
        """Assemble a dump document and (optionally) write it to ``path``.

        The event tail is snapshotted under the lock; serialization and
        the file write happen outside it. Never raises — a failed write
        records itself in the returned document instead."""
        events = self.tail()
        doc = {
            "flight_recorder": self.name,
            "reason": reason,
            "ts": self._clock(),
            "capacity": self.capacity,
            "recorded_total": self._total,
            "events": events,
            "inflight": list(inflight) if inflight else [],
            "open_spans": list(open_spans) if open_spans else [],
        }
        if path is not None:
            try:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(doc, f, default=_coerce)
                doc["path"] = path
            except OSError as e:
                doc["write_error"] = f"{type(e).__name__}: {e}"
        with self._lock:
            self.dump_count += 1
            self.last_dump = doc
        return doc


def _coerce(obj):
    """json fallback for numpy scalars and other strays in event fields."""
    fn = getattr(obj, "item", None)
    if callable(fn):
        try:
            return fn()
        except Exception:
            pass
    return repr(obj)


def read_dump(path: str) -> dict:
    """Load a dump file (the ``accelerate-tpu trace flight-dump`` input)."""
    with open(path) as f:
        return json.load(f)


def render_dump(doc: dict, *, tail: int = 16) -> str:
    """Human-readable dump transcript: header, in-flight table, open
    spans, then the last ``tail`` events oldest-first."""
    lines = [
        f"flight recorder {doc.get('flight_recorder') or '<unnamed>'}: "
        f"reason={doc.get('reason') or '<none>'} "
        f"recorded={doc.get('recorded_total', 0)} (ring {doc.get('capacity', '?')})",
    ]
    inflight = doc.get("inflight") or []
    lines.append(f"  in-flight requests: {len(inflight)}")
    for row in inflight:
        frag = " ".join(f"{k}={row[k]}" for k in sorted(row) if row[k] is not None)
        lines.append(f"    {frag}")
    spans = doc.get("open_spans") or []
    lines.append(f"  open spans: {len(spans)}")
    for row in spans:
        lines.append(
            f"    trace {row.get('trace')}: in {row.get('segment') or '<no segment>'} "
            f"for {row.get('age_ms', 0.0):.1f} ms ({row.get('spans', 0)} spans)"
        )
    events = (doc.get("events") or [])[-tail:]
    lines.append(f"  event tail (last {len(events)}):")
    for rec in events:
        extra = {
            k: v for k, v in rec.items() if k not in ("v", "seq", "ts", "rank", "kind", "name", "severity")
        }
        frag = " ".join(f"{k}={v}" for k, v in extra.items())
        sev = rec.get("severity")
        sev_frag = f" [{sev}]" if sev and sev != "info" else ""
        lines.append(f"    seq={rec.get('seq', '?')} {rec.get('kind')}:{rec.get('name')}{sev_frag} {frag}".rstrip())
    return "\n".join(lines)
