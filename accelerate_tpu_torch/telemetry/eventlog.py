"""Structured, rank-tagged JSONL event log: the one sink every runtime
telemetry signal writes to.

Counterpart of :mod:`accelerate_tpu.telemetry.eventlog`, with the same
schema (``SCHEMA_VERSION``) and line format, so each package's
``read_events`` reads the other's logs. Three record kinds:

* ``span``    -- a timed region: ``{"kind": "span", "name": ..., "dur_ms": ...}``
  plus whatever fields the emitter attaches (a train step attaches its
  data-wait / dispatch / execute split);
* ``counter`` -- a sampled value: ``{"kind": "counter", "name": ..., "value": ...}``;
* ``event``   -- a point occurrence with a severity (``info`` / ``warning`` /
  ``error``): recompile detections, memory-drift findings, prepare()
  markers, checkpoint commits.

Every record carries ``ts`` (unix seconds), ``seq`` (a per-process
counter), ``rank`` (the process index) and ``v`` (the schema version).
Writes are buffered in memory and flushed every ``buffer_lines`` records
(and at close / exit). By default only the main process writes
(``main_process_only``); elsewhere every emit is a no-op.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import time
from typing import Optional

SCHEMA_VERSION = 1

#: record kinds a well-formed telemetry line may carry
KINDS = ("span", "counter", "event")

#: per-process monotonic sequence counter, shared by every EventLog
#: instance: logs merge into one deterministic order by sorting on ``seq``
#: (wall-clock ``ts`` ties under coarse clocks; readers stay tolerant of
#: logs without the field).
_SEQ = itertools.count()


def _resolve_rank() -> int:
    """The process index of an existing ``PartialState`` singleton, else 0
    (the event log never creates the state)."""
    from ..state import PartialState

    shared = PartialState._shared_state
    return int(shared.get("process_index", 0)) if shared.get("_initialized") else 0


class EventLog:
    """Buffered JSONL writer for telemetry records.

    ``path=None`` (or a non-main rank under ``main_process_only``)
    disables writing entirely — emits become no-ops — so instrumented
    code never needs an ``if telemetry:`` guard. ``clock`` is injectable
    for deterministic tests.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        rank: Optional[int] = None,
        main_process_only: bool = True,
        buffer_lines: int = 64,
        clock=time.time,
    ):
        self.path = path
        self.rank = _resolve_rank() if rank is None else int(rank)
        self._clock = clock
        self._buffer_lines = max(1, int(buffer_lines))
        self.enabled = path is not None and not (main_process_only and self.rank != 0)
        self._buf: list[str] = []
        self._taps: list = []
        self._closed = False
        self._atexit_registered = False
        if self.enabled:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            # truncate: one file == one run (summarize assumes it)
            with open(path, "w"):
                pass
            atexit.register(self.close)
            self._atexit_registered = True

    # ------------------------------------------------------------------ #
    # emit surface
    # ------------------------------------------------------------------ #

    def emit(self, kind: str, name: str, **fields) -> dict:
        """Append one record; returns the dict (written or not) so callers
        can reuse it for in-memory summaries."""
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        rec = {
            "v": SCHEMA_VERSION,
            "seq": next(_SEQ),
            "ts": self._clock(),
            "rank": self.rank,
            "kind": kind,
            "name": name,
        }
        rec.update(fields)
        if self.enabled and not self._closed:
            self._buf.append(json.dumps(rec, default=_json_default))
            if len(self._buf) >= self._buffer_lines:
                self.flush()
        # taps see every record, even on a disabled (path=None) log
        for tap in self._taps:
            tap(rec)
        return rec

    def add_tap(self, fn) -> None:
        """Register ``fn(record_dict)`` to observe every emitted record.
        Taps run inline on the emitting thread and must never raise or
        block."""
        if fn not in self._taps:
            self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        if fn in self._taps:
            self._taps.remove(fn)

    def counter(self, name: str, value, **fields) -> dict:
        return self.emit("counter", name, value=value, **fields)

    def event(self, name: str, severity: str = "info", **fields) -> dict:
        return self.emit("event", name, severity=severity, **fields)

    def span(self, name: str, **fields) -> "_Span":
        """``with log.span("prefill"):`` — emits the span with ``dur_ms``
        on exit. Extra ``fields`` ride along on the record."""
        return _Span(self, name, fields)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def flush(self):
        if not self._buf:
            return
        lines, self._buf = self._buf, []
        with open(self.path, "a") as f:
            f.write("\n".join(lines) + "\n")

    def close(self):
        if self._closed:
            return
        if self.enabled:
            self.flush()
        self._closed = True
        if self._atexit_registered:
            try:
                atexit.unregister(self.close)
            except Exception:
                pass
            self._atexit_registered = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Span:
    def __init__(self, log: EventLog, name: str, fields: dict):
        self._log = log
        self._name = name
        self._fields = fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        self._log.emit("span", self._name, dur_ms=round(dur_ms, 3), **self._fields)


def _json_default(obj):
    """Last-resort coercion: numpy and torch scalars (one-element tensors)
    -> python numbers, arrays and tensors -> their ``dtype[shape]`` string
    in the JAX package's spelling (``float32[2,3]``): a telemetry line
    never holds a tensor."""
    for attr in ("item",):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                break
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{str(dtype).removeprefix('torch.')}[{','.join(str(d) for d in shape)}]"
    return repr(obj)


def merge_events(*event_lists: list[dict], source_ids=None) -> list[dict]:
    """Merge several record streams (one event log per worker process, or
    the logs of several runs) into one deterministic order.

    ``seq`` is a per-process counter: two workers' records can carry the
    same ``(ts, seq)`` with coarse clocks, so ties break by worker id
    first — the per-list ``source_ids`` entry when given (e.g. the
    worker name the filename carries), else the record's own ``rank``
    (workers log with ``rank=<slot>``), else the list position. Within
    one source, ``seq`` is total and authoritative. Stable, so true ties
    keep input order."""
    tagged = []
    for li, lst in enumerate(event_lists):
        sid = str(source_ids[li]) if source_ids is not None else None
        for rec in lst:
            src = sid if sid is not None else str(rec.get("rank", li))
            tagged.append(((rec.get("ts", 0.0), src, rec.get("seq", -1)), rec))
    tagged.sort(key=lambda kr: kr[0])
    return [rec for _, rec in tagged]


def read_events(path: str) -> list[dict]:
    """Parse a telemetry JSONL file, skipping blank/corrupt lines (a run
    killed mid-write must still summarize)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events
