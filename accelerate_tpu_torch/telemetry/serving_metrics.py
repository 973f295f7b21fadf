"""Serving-side counters: TTFT, tokens/sec, queue wait, KV utilisation,
preemptions, prefix reuse, failovers and replica health, with a
Prometheus text-exposition dump.

Counterpart of :class:`accelerate_tpu.telemetry.serving_metrics.ServingMetrics`,
with the same hook names, counters, snapshot keys and Prometheus metric
names. :class:`~accelerate_tpu_torch.serving.ServingEngine` calls the
hooks where the events happen (submit, admit, first token, decode walk,
retire, cancel, pool-blocked admission, SLO shedding and demotion, decode
preemption and resume, failover import), the fleet router
(:mod:`accelerate_tpu_torch.serving_fleet`) the replica and failover
ones, so the numbers are exact counts. The port's engine counts its own
prefix registrations, evictions and hits (the JAX package's fleet radix
cache counts them for its engines; the port's radix cache counts only
misses, so a fleet counts each event once). Latency windows are bounded
deques. The snapshot adds ``ttft_ms_mean`` and two high-water marks to
the JAX package's keys; Prometheus exposes the same metrics as the JAX
package's.

``prometheus_text()`` renders the standard text exposition format
(``# HELP`` / ``# TYPE`` + samples); quantiles are ``summary`` quantile
samples over the retained window. :func:`fleet_prometheus_text` renders
N replicas as one scrape with a ``replica`` label a sample, and
:meth:`ServingMetrics.merge` pools them into one fleet view. The
multi-process fleet's process-level counters are its supervisor's
``proc_*`` lines (:meth:`~accelerate_tpu_torch.serving_proc.ProcessSupervisor.prometheus_text`),
as in the JAX package.
"""

from __future__ import annotations

import collections
import copy
import time
from typing import Optional

from .eventlog import EventLog

_PREFIX = "accelerate_tpu_serving"


def _pct(values, q: float) -> Optional[float]:
    vals = sorted(values)
    if not vals:
        return None
    k = max(0, min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1)))))
    return vals[k]


def _render_prom(rows) -> str:
    """Render ``(name, mtype, help, suffix, label_str, value)`` rows as
    text exposition: one HELP/TYPE block per metric (first-seen order),
    then every sample of that metric — the grouping a multi-replica
    scrape needs."""
    by_name: dict = {}
    order = []
    for name, mtype, help_text, suffix, labels, value in rows:
        if name not in by_name:
            by_name[name] = (mtype, help_text, [])
            order.append(name)
        by_name[name][2].append((suffix, labels, value))
    lines = []
    for name in order:
        mtype, help_text, samples = by_name[name]
        lines.append(f"# HELP {_PREFIX}_{name} {help_text}")
        lines.append(f"# TYPE {_PREFIX}_{name} {mtype}")
        for suffix, labels, value in samples:
            if value is None:
                continue
            lines.append(f"{_PREFIX}_{name}{suffix}{labels} {value:g}")
    return "\n".join(lines) + "\n"


def fleet_prometheus_text(metrics) -> str:
    """One scrape body for N replicas' :class:`ServingMetrics`: a single
    HELP/TYPE block per metric with one ``replica``-labeled sample per
    replica — what a fleet exposes on its shared ``/metrics`` endpoint
    (aggregate with ``sum by`` in the scraper, or serve
    ``ServingMetrics.merge(...).prometheus_text()`` for a pre-merged
    view)."""
    rows = []
    for i, m in enumerate(metrics):
        if m.replica is None:
            m = _with_replica(m, f"r{i}")
        rows.extend(m._prom_samples())
    return _render_prom(rows)


def _with_replica(metrics: "ServingMetrics", name: str) -> "ServingMetrics":
    """Label an unlabeled instance for one render without mutating it."""
    clone = copy.copy(metrics)
    clone.replica = name
    return clone


class ServingMetrics:
    """Counter/latency surface for one serving engine.

    ``log`` (optional): an :class:`EventLog` that :meth:`emit` writes the
    snapshot to as ``serving.*`` counters. ``replica`` (optional): a fleet
    replica name; when set, every Prometheus sample carries a
    ``replica="..."`` label and :meth:`emit` tags its counters with it.
    """

    def __init__(
        self,
        engine=None,
        *,
        log: Optional[EventLog] = None,
        window: int = 1024,
        clock=time.monotonic,
        replica: Optional[str] = None,
    ):
        self._engine = engine
        self.log = log if log is not None else EventLog(None)
        self._clock = clock
        self.replica = replica
        # set by merge(): the sources a fleet view reads its live gauges from
        self._sources: Optional[list] = None
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_cancelled = 0
        self.tokens_generated = 0
        self.prefills = 0
        self.preemptions = 0  # admission passes blocked on pool exhaustion
        # scheduler decisions (scheduling.py)
        self.requests_shed = 0  # SLO load shedding (submit reject + queue-wait shed)
        self.requests_deprioritized = 0
        self.decode_preemptions = 0  # decoding slots evicted + requeued
        self.resumes = 0  # preempted requests resumed by recompute
        # shared-prefix reuse: counted by the engine's register_prefix,
        # unregister_prefix and prefix admissions (the JAX package's fleet
        # counts them for its engines; a miss is its routing term, and the
        # port's engine never counts one)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.prefix_registrations = 0
        self.prefix_tokens_reused = 0
        # fleet fault tolerance (serving_fleet): failover flow counters and
        # this replica's health level (0 healthy, 1 degraded, 2 quarantined,
        # 3 dead; a fleet view exposes its worst source)
        self.failovers_in = 0  # migrated requests imported by this engine
        self.failovers_out = 0  # in-flight requests migrated off this engine
        self.failovers_lost = 0  # in-flight requests unrecoverable at failover
        self.replica_errors = 0  # engine exceptions classified by the router
        self.replica_timeouts = 0  # tick wall-time SLO violations
        self._replica_state = 0
        # the paged pool's most blocks in use at once (trash sink excluded)
        # and the most slots one decode tick advanced
        self.pool_high_water_blocks = 0
        self.decode_slots_high_water = 0
        self.ttft_ms: collections.deque = collections.deque(maxlen=window)
        self.e2e_ms: collections.deque = collections.deque(maxlen=window)
        # inter-token latency: one sample per (request, tick)
        self.itl_ms: collections.deque = collections.deque(maxlen=window)
        self.queue_wait_ms: collections.deque = collections.deque(maxlen=window)
        self._submit_ts: dict[int, float] = {}
        self._last_tok_ts: dict[int, float] = {}
        # tokens/sec over a sliding window of (ts, cumulative tokens)
        self._token_marks: collections.deque = collections.deque(maxlen=window)

    # ---- engine hooks ----------------------------------------------------

    def on_submit(self, uid: int):
        self.requests_submitted += 1
        self._submit_ts[uid] = self._clock()

    def on_first_token(self, uid: int):
        """A request's first generated token landed (the tail of its
        prefill): the TTFT sample."""
        self.prefills += 1
        now = self._clock()
        self._last_tok_ts[uid] = now
        t0 = self._submit_ts.get(uid)
        if t0 is not None:
            self.ttft_ms.append((now - t0) * 1000.0)

    def on_admit(self, uid: int, priority: int = 0, queue_wait_ms: Optional[float] = None):
        if queue_wait_ms is not None:
            self.queue_wait_ms.append(queue_wait_ms)

    def on_tokens(self, n: int = 1):
        self.tokens_generated += n
        self._token_marks.append((self._clock(), self.tokens_generated))

    def on_tick_tokens(self, uid: int, n: int):
        """ITL sample: ``n`` tokens delivered to ``uid`` this tick."""
        now = self._clock()
        t0 = self._last_tok_ts.get(uid)
        if t0 is not None and n > 0:
            self.itl_ms.append((now - t0) * 1000.0 / n)
        self._last_tok_ts[uid] = now

    def on_complete(self, uid: int):
        self.requests_completed += 1
        self._last_tok_ts.pop(uid, None)
        t0 = self._submit_ts.pop(uid, None)
        if t0 is not None:
            self.e2e_ms.append((self._clock() - t0) * 1000.0)

    def on_cancel(self, uid: int):
        self.requests_cancelled += 1
        self._submit_ts.pop(uid, None)
        self._last_tok_ts.pop(uid, None)

    def on_pool_blocked(self):
        self.preemptions += 1

    def on_shed(self, uid: Optional[int]):
        """SLO load shed: a submit-time reject (``uid`` None) or a queued
        request dropped after blowing the wait threshold."""
        self.requests_shed += 1
        if uid is not None:
            self._submit_ts.pop(uid, None)

    def on_deprioritize(self, uid: Optional[int]):
        self.requests_deprioritized += 1

    def on_preempt_decode(self, uid: int):
        """A decoding slot was evicted and requeued; the ITL chain restarts
        at the first delivery after the resume, so the gap is no sample."""
        self.decode_preemptions += 1
        self._last_tok_ts.pop(uid, None)

    def on_resume(self, uid: int):
        self.resumes += 1
        self._last_tok_ts[uid] = self._clock()

    def on_prefix_hit(self, tokens_reused: int = 0):
        """A request matched a registered shared preamble and skipped
        prefilling ``tokens_reused`` tokens."""
        self.prefix_hits += 1
        self.prefix_tokens_reused += int(tokens_reused)

    def on_prefix_miss(self):
        self.prefix_misses += 1

    def on_prefix_evict(self):
        self.prefix_evictions += 1

    def on_prefix_register(self):
        self.prefix_registrations += 1

    def on_failover_in(self):
        """A migrated in-flight request was imported by this engine."""
        self.failovers_in += 1

    def on_failover_out(self):
        """An in-flight request was exported off this engine's replica."""
        self.failovers_out += 1

    def on_failover_lost(self):
        """An in-flight request could not be recovered at failover."""
        self.failovers_lost += 1

    def on_replica_error(self):
        self.replica_errors += 1

    def on_replica_timeout(self):
        self.replica_timeouts += 1

    def on_replica_state(self, level: int):
        """Router health transition: 0 healthy, 1 degraded, 2 quarantined,
        3 dead."""
        self._replica_state = int(level)

    def on_blocks_allocated(self):
        """The engine took pool blocks: raise the high-water mark."""
        in_use = self._engine._pcfg.num_blocks - 1 - self._engine._alloc.free_count
        self.pool_high_water_blocks = max(self.pool_high_water_blocks, in_use)

    def on_decode_tick(self, n_decoding: int):
        self.decode_slots_high_water = max(self.decode_slots_high_water, n_decoding)

    # ---- read surface ----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        if self._sources:
            return sum(m.queue_depth for m in self._sources)
        return len(self._engine.queue) if self._engine is not None else 0

    @property
    def active_slots(self) -> int:
        if self._sources:
            return sum(m.active_slots for m in self._sources)
        return self._engine.active_count if self._engine is not None else 0

    @property
    def replica_state(self) -> int:
        """Health level of this replica (0 healthy, 1 degraded,
        2 quarantined, 3 dead); a fleet view reports its worst source."""
        if self._sources:
            return max(m.replica_state for m in self._sources)
        return self._replica_state

    @property
    def kv_block_utilization(self) -> Optional[float]:
        """Fraction of the paged pool in use (trash sink excluded; None on
        the dense layout; a fleet view averages its paged replicas)."""
        if self._sources:
            utils = [m.kv_block_utilization for m in self._sources]
            utils = [u for u in utils if u is not None]
            return sum(utils) / len(utils) if utils else None
        if self._engine is None or not self._engine.paged:
            return None
        total = self._engine._pcfg.num_blocks - 1
        return 1.0 - self._engine._alloc.free_count / total

    def tokens_per_sec(self, window_s: float = 10.0) -> Optional[float]:
        """Throughput over the trailing ``window_s`` seconds of token
        marks (None until two marks exist; a fleet view sums its
        replicas' rates)."""
        if self._sources:
            rates = [m.tokens_per_sec(window_s) for m in self._sources]
            rates = [r for r in rates if r is not None]
            return sum(rates) if rates else None
        if len(self._token_marks) < 2:
            return None
        now = self._clock()
        marks = [(ts, tot) for ts, tot in self._token_marks if now - ts <= window_s]
        if len(marks) < 2:
            marks = list(self._token_marks)[-2:]
        (t0, c0), (t1, c1) = marks[0], marks[-1]
        if t1 <= t0:
            return None
        return (c1 - c0) / (t1 - t0)

    def snapshot(self) -> dict:
        """One flat dict of every metric: the JAX package's snapshot keys,
        and ``ttft_ms_mean`` and the two high-water marks besides."""
        snap = {
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "requests_cancelled": self.requests_cancelled,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "preemptions": self.preemptions,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "kv_block_utilization": self.kv_block_utilization,
            "tokens_per_sec": self.tokens_per_sec(),
            "ttft_ms_mean": sum(self.ttft_ms) / len(self.ttft_ms) if self.ttft_ms else None,
            "ttft_ms_p50": _pct(self.ttft_ms, 50),
            "ttft_ms_p95": _pct(self.ttft_ms, 95),
            "e2e_ms_p50": _pct(self.e2e_ms, 50),
            "e2e_ms_p95": _pct(self.e2e_ms, 95),
            "itl_ms_p50": _pct(self.itl_ms, 50),
            "itl_ms_p95": _pct(self.itl_ms, 95),
            "queue_wait_ms_p50": _pct(self.queue_wait_ms, 50),
            "queue_wait_ms_p95": _pct(self.queue_wait_ms, 95),
            "requests_shed": self.requests_shed,
            "requests_deprioritized": self.requests_deprioritized,
            "decode_preemptions": self.decode_preemptions,
            "resumes": self.resumes,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_evictions": self.prefix_evictions,
            "prefix_registrations": self.prefix_registrations,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "failovers_in": self.failovers_in,
            "failovers_out": self.failovers_out,
            "failovers_lost": self.failovers_lost,
            "replica_errors": self.replica_errors,
            "replica_timeouts": self.replica_timeouts,
            "replica_state": self.replica_state,
            "pool_high_water_blocks": self.pool_high_water_blocks,
            "decode_slots_high_water": self.decode_slots_high_water,
        }
        if self.replica is not None:
            snap["replica"] = self.replica
        return snap

    #: counters merge() sums and prometheus exposes as *_total samples
    _COUNTERS = (
        "requests_submitted", "requests_completed", "requests_cancelled",
        "tokens_generated", "prefills", "preemptions", "requests_shed",
        "requests_deprioritized", "decode_preemptions", "resumes",
        "prefix_hits", "prefix_misses", "prefix_evictions",
        "prefix_registrations", "prefix_tokens_reused",
        "failovers_in", "failovers_out", "failovers_lost",
        "replica_errors", "replica_timeouts",
    )
    _WINDOWS = ("ttft_ms", "e2e_ms", "itl_ms", "queue_wait_ms")
    #: the port's high-water marks: a fleet view keeps the highest replica's
    _HIGH_WATER = ("pool_high_water_blocks", "decode_slots_high_water")

    @classmethod
    def merge(cls, metrics, replica: str = "fleet") -> "ServingMetrics":
        """One fleet-level view over N replicas' metrics: counters sum,
        latency windows pool (so fleet p50/p95 are quantiles over EVERY
        replica's samples, not an average of averages), and the live
        gauges (queue depth, active slots, tokens/sec) read through to
        the sources at scrape time. The result renders/scrapes exactly
        like a single engine's metrics."""
        metrics = list(metrics)
        out = cls(None, replica=replica)
        out._sources = metrics
        for name in cls._COUNTERS:
            setattr(out, name, sum(getattr(m, name) for m in metrics))
        for name in cls._WINDOWS:
            pooled = collections.deque(
                (v for m in metrics for v in getattr(m, name)),
                maxlen=sum(getattr(m, name).maxlen for m in metrics) or 1,
            )
            setattr(out, name, pooled)
        for name in cls._HIGH_WATER:
            setattr(out, name, max((getattr(m, name) for m in metrics), default=0))
        return out

    def emit(self):
        """Write the snapshot to the attached event log as ``serving.*``
        counters (no-op when the log is disabled). The ``replica`` name
        is attached as a tag on each counter, not emitted as a value."""
        tags = {"replica": self.replica} if self.replica is not None else {}
        for name, value in self.snapshot().items():
            if name != "replica" and value is not None:
                self.log.counter(f"serving.{name}", value, **tags)

    #: (metric name, type, help, attribute/window) rows the exposition
    #: renders — shared by the single-engine and fleet renderers so a
    #: fleet scrape emits ONE ``# HELP``/``# TYPE`` block per metric with
    #: a sample per replica (the Prometheus contract for labeled series).
    _PROM_COUNTERS = (
        ("requests_submitted_total", "Requests accepted by submit()", "requests_submitted"),
        ("requests_completed_total", "Requests retired with a result", "requests_completed"),
        ("requests_cancelled_total", "Requests cancelled mid-flight or queued", "requests_cancelled"),
        ("tokens_generated_total", "Generated tokens across all requests", "tokens_generated"),
        ("prefills_total", "Prompt prefills executed", "prefills"),
        ("preemptions_total", "Admission passes blocked on KV pool exhaustion", "preemptions"),
        ("requests_shed_total", "Requests rejected by SLO load shedding", "requests_shed"),
        ("requests_deprioritized_total", "Requests demoted by SLO load shedding", "requests_deprioritized"),
        ("decode_preemptions_total", "Decoding slots evicted and requeued", "decode_preemptions"),
        ("resumes_total", "Preempted requests resumed by recompute", "resumes"),
        ("prefix_hits_total", "Requests that reused a registered shared preamble", "prefix_hits"),
        ("prefix_misses_total", "Requests with no registered preamble match", "prefix_misses"),
        ("prefix_evictions_total", "Radix-cache prefix entries evicted (LRU)", "prefix_evictions"),
        ("prefix_registrations_total", "Shared preambles promoted into the radix cache", "prefix_registrations"),
        ("prefix_tokens_reused_total", "Prompt tokens served from cached prefixes (no re-prefill)", "prefix_tokens_reused"),
        ("failovers_in_total", "Migrated in-flight requests imported from a failed replica", "failovers_in"),
        ("failovers_out_total", "In-flight requests migrated off this replica at failure/drain", "failovers_out"),
        ("failovers_lost_total", "In-flight requests unrecoverable at failover", "failovers_lost"),
        ("replica_errors_total", "Engine exceptions classified by the fleet router", "replica_errors"),
        ("replica_timeouts_total", "Tick wall-time SLO violations", "replica_timeouts"),
    )
    _PROM_SUMMARIES = (
        ("ttft_ms", "Time to first token (ms)", "ttft_ms"),
        ("e2e_ms", "Request end-to-end latency (ms)", "e2e_ms"),
        ("itl_ms", "Inter-token latency (ms) per delivered token", "itl_ms"),
        ("queue_wait_ms", "Submit-to-admission queue wait (ms)", "queue_wait_ms"),
    )
    _PROM_GAUGES = (
        ("queue_depth", "Requests waiting for a slot", "queue_depth"),
        ("active_slots", "Slots currently decoding", "active_slots"),
        ("kv_block_utilization", "Fraction of the paged KV pool in use", "kv_block_utilization"),
        ("tokens_per_sec", "Decode throughput over the trailing window", "tokens_per_sec"),
        ("replica_state", "Replica health (0 healthy, 1 degraded, 2 quarantined, 3 dead)", "replica_state"),
    )

    def _label_str(self, extra: Optional[dict] = None) -> str:
        labels = {}
        if self.replica is not None:
            labels["replica"] = self.replica
        labels.update(extra or {})
        if not labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
        return "{" + inner + "}"

    def _prom_samples(self):
        """``(name, mtype, help, suffix, label_str, value)`` rows for this
        instance (None values are dropped at render time)."""
        rows = []
        for name, help_text, attr in self._PROM_COUNTERS:
            rows.append((name, "counter", help_text, "", self._label_str(), getattr(self, attr)))
        for name, help_text, attr in self._PROM_GAUGES:
            val = getattr(self, attr)
            if callable(val):
                val = val()
            rows.append((name, "gauge", help_text, "", self._label_str(), val))
        for name, help_text, attr in self._PROM_SUMMARIES:
            window = getattr(self, attr)
            rows.append((name, "summary", help_text, "",
                         self._label_str({"quantile": "0.5"}), _pct(window, 50)))
            rows.append((name, "summary", help_text, "",
                         self._label_str({"quantile": "0.95"}), _pct(window, 95)))
            rows.append((name, "summary", help_text, "_count", self._label_str(), len(window)))
        return rows

    def prometheus_text(self) -> str:
        """Prometheus text exposition (v0.0.4) of the snapshot. With
        :attr:`replica` set, every sample carries the ``replica`` label."""
        return _render_prom(self._prom_samples())
