"""Serving-side counters: TTFT, tokens/sec, queue wait, KV utilisation.

The subset of :class:`accelerate_tpu.telemetry.serving_metrics.ServingMetrics`
that the port's :class:`~accelerate_tpu_torch.serving.ServingEngine`
drives, with the same hook names, counters and snapshot keys. The engine
calls the hooks where the events happen (submit, admit, first token,
decode walk, retire, cancel, pool-blocked admission, SLO shedding and
demotion, decode preemption and resume), so the numbers are exact counts.
The prefix hooks are the fleet's radix cache's in the JAX package, and
the engine calls none of them there either. Latency windows are bounded
deques. Prometheus output, the event log and the fleet merge are not
ported yet (ROADMAP.md Queue 1 item 6), nor the fleet's counters and
keys (failovers, replica errors and health: item 10).
"""

from __future__ import annotations

import collections
import time
from typing import Optional


def _pct(values, q: float) -> Optional[float]:
    vals = sorted(values)
    if not vals:
        return None
    k = max(0, min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1)))))
    return vals[k]


class ServingMetrics:
    """Counter/latency surface for one serving engine."""

    def __init__(self, engine, *, window: int = 1024, clock=time.monotonic):
        self._engine = engine
        self._clock = clock
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

    def on_blocks_allocated(self):
        """The engine took pool blocks: raise the high-water mark."""
        in_use = self._engine._pcfg.num_blocks - 1 - self._engine._alloc.free_count
        self.pool_high_water_blocks = max(self.pool_high_water_blocks, in_use)

    def on_decode_tick(self, n_decoding: int):
        self.decode_slots_high_water = max(self.decode_slots_high_water, n_decoding)

    # ---- read surface ----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._engine.queue)

    @property
    def active_slots(self) -> int:
        return self._engine.active_count

    @property
    def kv_block_utilization(self) -> Optional[float]:
        """Fraction of the paged pool in use (trash sink excluded; None on
        the dense layout)."""
        if not self._engine.paged:
            return None
        total = self._engine._pcfg.num_blocks - 1
        return 1.0 - self._engine._alloc.free_count / total

    def tokens_per_sec(self, window_s: float = 10.0) -> Optional[float]:
        """Throughput over the trailing ``window_s`` seconds of token
        marks (None until two marks exist)."""
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
        """One flat dict of every metric: the JAX package's snapshot keys but
        the fleet's, and ``ttft_ms_mean`` and the two high-water marks
        besides."""
        return {
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
            "pool_high_water_blocks": self.pool_high_water_blocks,
            "decode_slots_high_water": self.decode_slots_high_water,
        }
