"""Scheduling policy for the continuous-batching serving engine.

A copy of :mod:`accelerate_tpu.scheduling` (host-only policy, no jax),
kept here so the port imports nothing of the JAX package.
:mod:`accelerate_tpu_torch.serving` consults the engine's decisions below,
and :mod:`accelerate_tpu_torch.serving_fleet` the fleet's routing ones
(:class:`RoutingConfig`, :class:`FleetRoutingPolicy`).

The serving engine owns the *mechanism* (slots, caches, the prefill
and decode programs); this module owns the *policy* — the
decisions a production scheduler makes every tick:

* **token budget**: each engine tick may spend at most ``token_budget``
  tokens of model compute. Active decodes claim theirs first
  (``n_decoding x tick_block``); the remainder is filled with *chunks*
  of pending prefills, so a long prompt streams into its cache across
  ticks instead of stalling every running decode for its whole prefill
  (the vLLM/Sarathi "chunked prefill" discipline). ``token_budget=None``
  disables interleaving — every admitted prefill runs to completion in
  its admission tick (the pre-scheduler behavior, and what
  ``mode="fifo"`` pins for A/B benchmarking);
* **priority-class admission**: ``submit(..., priority=...)`` — lower
  value admits sooner; ties admit FIFO by submission order. Preempted
  requests requeue with their original order key, so a resumed request
  never loses its place to later arrivals of the same class;
* **SLO-aware load shedding**: when queue depth (at submit) or queue
  wait (at admission) crosses the configured threshold, sheddable
  requests (``priority >= shed_priority_floor``) are rejected with a
  structured :class:`ShedError` and a ``shed`` telemetry event instead
  of silently queueing into a blown SLO. ``shed_action="deprioritize"``
  demotes instead of rejecting;
* **decode preemption**: under pool-block pressure (paged) or a
  priority inversion (dense, all slots busy and a strictly more
  important request waiting), the youngest lowest-priority decode
  releases its slot and KV blocks and requeues with its
  generated-so-far tokens; it resumes by prefix-style recomputation —
  token- and logprob-exact, because the recomputed K/V equals what the
  evicted cache held and the sampling key chain is carried across the
  preemption;
* **speculative gating**: with a draft model attached,
  ``speculative_priorities`` restricts the speculative tick to ticks
  where every decoding slot's priority opted in (greedy speculative
  decoding is target-exact regardless of draft-cache staleness, so
  mixing plain and speculative ticks costs only acceptance rate, never
  tokens).

Everything here is host-side policy over plain Python state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


class ShedError(RuntimeError):
    """Structured admission rejection (SLO load shedding).

    Raised by ``submit()`` when the queue-depth SLO is already blown, and
    by ``poll()``/``partial()``/``logprobs()`` for a request that was shed
    from the queue after exceeding the queue-wait SLO. Carries the
    decision context so a gateway can return a well-formed 429/503
    instead of parsing a message string.
    """

    def __init__(self, reason: str, uid: Optional[int] = None, priority: int = 0,
                 queue_depth: int = 0, queue_wait_ms: Optional[float] = None,
                 trace_id: Optional[int] = None):
        self.reason = reason
        self.uid = uid
        self.priority = priority
        self.queue_depth = queue_depth
        self.queue_wait_ms = queue_wait_ms
        # the request's distributed-tracing id (telemetry.trace), when the
        # engine/router was tracing — lets a gateway log a correlatable id
        self.trace_id = trace_id
        detail = f"request shed ({reason}): priority={priority} queue_depth={queue_depth}"
        if queue_wait_ms is not None:
            detail += f" queue_wait_ms={queue_wait_ms:.1f}"
        if uid is not None:
            detail = f"request {uid} shed ({reason}): priority={priority} queue_depth={queue_depth}"
        if trace_id is not None:
            detail += f" trace={trace_id}"
        super().__init__(detail)


@dataclasses.dataclass
class SchedulerConfig:
    """Knobs for the :class:`Scheduler`. The default configuration is
    behavior-preserving: unlimited budget, single priority class, no
    shedding, no preemption — ``ServingEngine`` without a config decodes
    exactly as before.

    ``mode``: ``"continuous"`` (token-budget interleaving, priorities,
    SLOs) or ``"fifo"`` (strict submission order, full prefill at
    admission, every other knob ignored — the A/B baseline the serving
    benchmark measures against).

    ``token_budget``: model-compute tokens one tick may spend; decodes
    claim ``n_decoding x tick_block`` first, prefill chunks fill the
    remainder. Size it above ``num_slots x tick_block`` plus at least
    one prefill chunk or prefill only progresses on underfull ticks
    (the engine always forces one unit of progress per tick, so no
    configuration can livelock). ``None`` = unlimited.

    ``max_queue_depth`` / ``max_queue_wait_s``: SLO thresholds —
    depth is checked at submit, wait at every admission pass. Only
    requests with ``priority >= shed_priority_floor`` are ever shed, so
    the default floor of 1 makes priority-0 traffic unsheddable.
    ``shed_action="deprioritize"`` demotes an over-SLO request to
    ``deprioritize_to`` (once) instead of rejecting it.

    ``enable_preemption``: allow a decoding slot with
    ``priority >= preempt_priority_floor`` to be evicted (requeued,
    resumed later by recompute) when a strictly more important request
    cannot be admitted — pool exhaustion in paged mode, no free slot in
    dense mode.

    ``speculative_priorities``: with a draft model, run the speculative
    tick only when every decoding slot's priority is in this set
    (``None`` = all priorities speculate — the engine's historical
    behavior).
    """

    mode: str = "continuous"
    token_budget: Optional[int] = None
    max_queue_depth: Optional[int] = None
    max_queue_wait_s: Optional[float] = None
    shed_priority_floor: int = 1
    shed_action: str = "reject"
    deprioritize_to: int = 99
    enable_preemption: bool = False
    preempt_priority_floor: int = 1
    speculative_priorities: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in ("continuous", "fifo"):
            raise ValueError(f"mode must be continuous|fifo, got {self.mode!r}")
        if self.token_budget is not None and self.token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {self.token_budget}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.max_queue_wait_s is not None and self.max_queue_wait_s < 0:
            raise ValueError(f"max_queue_wait_s must be >= 0, got {self.max_queue_wait_s}")
        if self.shed_action not in ("reject", "deprioritize"):
            raise ValueError(f"shed_action must be reject|deprioritize, got {self.shed_action!r}")
        if self.speculative_priorities is not None:
            self.speculative_priorities = tuple(int(p) for p in self.speculative_priorities)


@dataclasses.dataclass
class RoutingConfig:
    """Fleet-level routing policy knobs
    (:class:`~accelerate_tpu_torch.serving_fleet.FleetRouter`).

    ``policy``: how a request without prefix affinity picks a replica —
    ``"least_loaded"`` (min queued + active, ties to the lowest index)
    or ``"round_robin"``. Prefix affinity (a replica already holds the
    request's shared preamble in its radix cache) always wins over the
    policy: re-prefilling a cached preamble on a colder replica costs
    more than any load imbalance the policy could fix.

    ``max_fleet_queue_depth``: fleet-wide SLO admission gate — the sum
    of every replica's queue depth, checked at ``FleetRouter.submit``
    with the SAME priority-class semantics as the per-engine scheduler
    (only ``priority >= shed_priority_floor`` is sheddable, rejection is
    a structured :class:`ShedError`). Per-replica depth/wait SLOs keep
    riding each engine's own :class:`SchedulerConfig` unchanged.
    """

    policy: str = "least_loaded"
    max_fleet_queue_depth: Optional[int] = None
    shed_priority_floor: int = 1

    def __post_init__(self):
        if self.policy not in ("least_loaded", "round_robin"):
            raise ValueError(f"policy must be least_loaded|round_robin, got {self.policy!r}")
        if self.max_fleet_queue_depth is not None and self.max_fleet_queue_depth < 1:
            raise ValueError(
                f"max_fleet_queue_depth must be >= 1, got {self.max_fleet_queue_depth}"
            )


class FleetRoutingPolicy:
    """Replica-selection + fleet-admission decisions for a
    :class:`~accelerate_tpu_torch.serving_fleet.FleetRouter` — the same
    policy/mechanism split as :class:`Scheduler`: all replica state stays
    in the router, this object only decides."""

    def __init__(self, config: Optional[RoutingConfig] = None):
        self.config = config or RoutingConfig()
        self._rr = 0

    def shed_on_submit(self, priority: int, fleet_queue_depth: int) -> Optional[str]:
        """Reason string if a new request must be rejected at the fleet
        edge (aggregate queue-depth SLO; priority classes below the shed
        floor are never rejected)."""
        cfg = self.config
        if cfg.max_fleet_queue_depth is None or priority < cfg.shed_priority_floor:
            return None
        if fleet_queue_depth >= cfg.max_fleet_queue_depth:
            return (
                f"fleet queue depth {fleet_queue_depth} >= "
                f"max_fleet_queue_depth {cfg.max_fleet_queue_depth}"
            )
        return None

    def shed_on_capacity(self, n_routable: int) -> Optional[str]:
        """Reason string if the fleet has NO routable capacity left (every
        replica quarantined/dead/draining) — the circuit-breaker edge: a
        submission that cannot be served anywhere is rejected with a
        structured :class:`ShedError` instead of queueing into a black
        hole. Unlike depth shedding this ignores the priority floor: no
        class is servable when nothing is serving."""
        if n_routable <= 0:
            return "no serving replicas (fleet capacity lost)"
        return None

    def pick_replica(self, loads: Sequence[float], eligible: Sequence[int]) -> int:
        """Index (into ``loads``) of the replica a request should route
        to, among ``eligible`` indices. ``loads`` is queued + active per
        replica."""
        if not eligible:
            raise ValueError("no eligible replicas")
        if self.config.policy == "round_robin":
            pick = sorted(eligible)[self._rr % len(eligible)]
            self._rr += 1
            return pick
        return min(eligible, key=lambda i: (loads[i], i))


class Scheduler:
    """Decision surface the engine consults every tick. Stateless beyond
    its config — all request/slot state stays in the engine, so the
    policy is trivially swappable (subclass and override a method)."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()

    # ---- ordering -----------------------------------------------------

    def order_key(self, priority: int, uid: int) -> tuple:
        """Queue position: priority class first (lower admits sooner),
        submission order within a class. FIFO mode ignores priority."""
        if self.config.mode == "fifo":
            return (0, uid)
        return (int(priority), uid)

    # ---- token budget -------------------------------------------------

    def tick_budget(self, n_decoding: int, tick_block: int) -> float:
        """Prefill-token budget for this tick after active decodes claim
        theirs. ``inf`` when budgeting is off (fifo / no budget)."""
        if self.config.mode == "fifo" or self.config.token_budget is None:
            return math.inf
        return max(0, self.config.token_budget - n_decoding * tick_block)

    # ---- SLO shedding -------------------------------------------------

    def sheddable(self, priority: int) -> bool:
        return self.config.mode != "fifo" and priority >= self.config.shed_priority_floor

    def shed_on_submit(self, priority: int, queue_depth: int) -> Optional[str]:
        """Reason string if a new request must be rejected at submit."""
        cfg = self.config
        if cfg.max_queue_depth is None or not self.sheddable(priority):
            return None
        if queue_depth >= cfg.max_queue_depth:
            return f"queue depth {queue_depth} >= max_queue_depth {cfg.max_queue_depth}"
        return None

    def shed_on_wait(self, priority: int, wait_s: float) -> Optional[str]:
        """Reason string if a queued request has blown the wait SLO."""
        cfg = self.config
        if cfg.max_queue_wait_s is None or not self.sheddable(priority):
            return None
        if wait_s > cfg.max_queue_wait_s:
            return f"queue wait {wait_s:.3f}s > max_queue_wait_s {cfg.max_queue_wait_s}"
        return None

    # ---- preemption ---------------------------------------------------

    def pick_victim(self, incoming_priority: int, decoding: list) -> Optional[int]:
        """Slot to evict so a more important request can admit, or None.

        ``decoding``: ``[(slot, priority, uid), ...]`` for slots
        currently in the decode phase. The victim is the *least
        important, youngest* decode (max ``(priority, uid)``) — and only
        if it is both sheddable by the preemption floor and strictly
        less important than the incoming request, so equal-priority
        traffic never churns itself.
        """
        if self.config.mode == "fifo" or not self.config.enable_preemption:
            return None
        candidates = [
            (prio, uid, slot)
            for slot, prio, uid in decoding
            if prio >= self.config.preempt_priority_floor and prio > incoming_priority
        ]
        if not candidates:
            return None
        return max(candidates)[2]

    # ---- speculative gating -------------------------------------------

    def use_speculative(self, decoding_priorities) -> bool:
        """Whether this tick's decode pass may run the speculative tick
        (only consulted when the engine has a draft model)."""
        allowed = self.config.speculative_priorities
        if allowed is None:
            return True
        return all(p in allowed for p in decoding_priorities)
