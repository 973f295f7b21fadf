"""Fleet-scale serving: a router over N in-process ``ServingEngine``
replicas, with disaggregated prefill/decode roles, priced KV handoff,
cross-request radix prefix reuse, failover and request tracing.

Counterpart of :mod:`accelerate_tpu.serving_fleet` (its in-process
fleet). One :class:`~accelerate_tpu_torch.serving.ServingEngine` is one
replica; this module owns the layer above the engines:

* **routing** -- :class:`FleetRouter` spreads an open-loop request stream
  over replicas. The policy (least-loaded / round-robin, fleet-level SLO
  shedding) is :class:`~accelerate_tpu_torch.scheduling.RoutingConfig` /
  :class:`~accelerate_tpu_torch.scheduling.FleetRoutingPolicy`, with the
  per-engine scheduler's priority classes and structured
  :class:`~accelerate_tpu_torch.scheduling.ShedError`. Prefix affinity
  beats the load policy: a replica whose radix cache holds a request's
  shared preamble serves it without prefilling the preamble again;
* **disaggregated prefill/decode** -- with ``roles=("prefill", ...,
  "decode", ...)`` prefill replicas run prompt prefills and hand the rows
  to decode replicas (``ServingEngine.prefill_detached`` ->
  ``submit_prefilled``; token- and logprob-exact by construction). Every
  handoff is priced BEFORE it happens by
  :func:`~accelerate_tpu_torch.analysis.costmodel.price_kv_handoff` (rows
  x bytes a row over the card's host round trip: replicas share one card,
  and the payload leaves the device as host tensors and comes back), and
  under ``handoff="auto"`` the router compares that with
  :func:`~accelerate_tpu_torch.analysis.costmodel.prefill_compute_us`.
  The router's accounting of the bytes it moved equals the prediction
  byte for byte;
* **radix prefix cache** -- :class:`RadixPrefixCache` is a compressed
  token trie over observed prompts. When ``promote_after`` prompts share
  a preamble of at least ``min_prefix_tokens`` tokens, the shared part is
  registered with the engine ONCE (``register_prefix``) and every later
  prompt starting with it prefills only its suffix. Entries evict LRU
  (``max_entries``), never while an active or queued request holds them;
* **spin-up** -- :meth:`FleetRouter.spin_up` adds and warms a replica
  over the same model object and reports its program ``compiles`` and
  ``deserialized`` (0 compiles over a shared executable store,
  ``from_model(store_dir=...)``, as in the JAX package) and the ``nvcc``
  builds its warm-up ran (``kernels/build.py``: 0 once the build
  directory holds the kernel libraries);
* **fault tolerance** -- every :class:`Replica` runs a ``healthy ->
  degraded -> quarantined -> dead`` health machine driven by error
  classification (engine exceptions, tick wall-time SLO violations,
  :class:`NonFinitePoison`) with a circuit breaker: the routing policy
  never sees quarantined or dead replicas, and when no serving capacity
  is left submissions shed at the fleet edge. On a failure (or
  :meth:`FleetRouter.drain`) every in-flight request moves to a survivor,
  by prefix recompute (the preemption/resume machinery: the carried
  generator state and the last token fed again) or, when the failing
  replica can export its dense rows, by the handoff path
  (``export_inflight`` -> ``import_inflight``), the choice priced BEFORE
  the move by :func:`~accelerate_tpu_torch.analysis.costmodel.price_failover`
  and the handoff leg retried with jittered backoff. Capacity recovers by
  :meth:`FleetRouter.add_replica`. :class:`HandoffCodec` turns a handoff
  payload into bytes and back;
* **tracing** -- ``trace=True`` (or a
  :class:`~accelerate_tpu_torch.telemetry.trace.TraceConfig`) gives the
  fleet one :class:`~accelerate_tpu_torch.telemetry.trace.Tracer`, a
  crash flight recorder a replica and the critical-path drift monitor.

Replicas are in-process engines over one model object on one device,
driven either deterministically (:meth:`FleetRouter.step`) or by one
thread a replica (:meth:`FleetRouter.drain_threaded`: each replica's lock
serializes its host bookkeeping; the kernels' ``ctypes`` calls and
PyTorch's operators release the GIL, so replicas overlap on the host).
The process-level fleet (a process a replica, the transport between
them) is :class:`~accelerate_tpu_torch.serving_proc.ProcessSupervisor`.
"""

from __future__ import annotations

import dataclasses
import io
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .ft.crashpoints import crash_point
from .scheduling import FleetRoutingPolicy, RoutingConfig, ShedError
from .utils.retry import retry_call


#: replica health levels, in degradation order; the index is the
#: ``replica_state`` gauge value Prometheus exposes
HEALTH_STATES = ("healthy", "degraded", "quarantined", "dead")


class NonFinitePoison(RuntimeError):
    """A replica's numerics are poisoned (the non-finite watchdog
    latched, or a tick surfaced NaN/Inf). Unlike a plain crash the
    replica's KV caches are SUSPECT: the router quarantines it and fails
    its in-flight work over by recompute only — shipped KV rows from a
    poisoned engine would carry the corruption to the survivor."""


class FleetRequestError(KeyError):
    """Structured lookup failure for a fleet request id, naming the
    request's last known state (``unknown`` / ``lost`` / a failed
    replica) — a client can distinguish "you never submitted this" from
    "the fleet lost it at a failover" and react accordingly. Subclasses
    ``KeyError`` so existing bare-lookup handling keeps working."""

    def __init__(self, fuid: int, state: str, detail: Optional[str] = None,
                 trace_id: Optional[int] = None):
        self.fuid = int(fuid)
        self.state = state
        self.detail = detail
        # the request's distributed-tracing id (telemetry.trace), when
        # the router was tracing — grep the eventlog/flight dumps for it
        self.trace_id = trace_id
        if state == "unknown":
            msg = f"unknown request id {fuid} (never submitted, already cancelled, or shed)"
        else:
            msg = f"request id {fuid} last known state: {state}"
        if detail:
            msg += f" — {detail}"
        if trace_id is not None:
            msg += f" (trace {trace_id})"
        super().__init__(msg)


class HandoffCodec:
    """Serialize a ``prefill_detached`` / ``export_inflight`` handoff
    payload to bytes and back: what a process-per-replica fleet sends over
    its transport in place of the in-process handoff's host tensors. The
    decode side stays token- and logprob-exact by the same round trip.

    The wire format is one ``.npz`` blob: the prompt, the generator state
    (``gen_state``), scalar metadata, and each row leaf (``key``,
    ``value``, ``index``) as raw bytes with its shape and dtype name
    (numpy has no bfloat16, so leaves never pass through numpy dtypes). A
    traced request's id rides the blob (schema v2); a blob without one
    decodes with ``trace`` None."""

    LEAVES = ("key", "value", "index")

    @staticmethod
    def encode(handoff: dict) -> bytes:
        rows = handoff["cache"]
        arrays = {
            "prompt": np.asarray(handoff["prompt"], np.int32),
            "gen_state": np.asarray(handoff.get("gen_state", np.zeros((0,), np.uint8)), np.uint8),
            "imeta": np.asarray(
                [
                    int(handoff["total"]),
                    int(handoff["max_new_tokens"]),
                    int(handoff["next_tok"]),
                    int(handoff["wire_bytes"]),
                    int(handoff.get("reused_prefix_tokens", 0)),
                    len(HandoffCodec.LEAVES),
                ],
                np.int64,
            ),
            "fmeta": np.asarray([float(handoff["lp"])], np.float64),
        }
        if handoff.get("trace") is not None:
            arrays["tmeta"] = np.asarray([int(handoff["trace"])], np.int64)
        for i, name in enumerate(HandoffCodec.LEAVES):
            leaf = rows[name].detach().cpu().contiguous()
            arrays[f"leaf_{i}"] = leaf.reshape(-1).view(torch.uint8).numpy()
            arrays[f"shape_{i}"] = np.asarray(leaf.shape, np.int64)
            arrays[f"dtype_{i}"] = np.asarray(str(leaf.dtype).removeprefix("torch."))
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @staticmethod
    def decode(data: bytes, engine=None) -> dict:
        """Rebuild the handoff dict (its rows as host tensors); the result
        feeds ``engine.submit_prefilled`` unchanged. With ``engine`` the
        rows' dtype is checked against the one it serves."""
        with np.load(io.BytesIO(data)) as z:
            imeta = z["imeta"]
            if int(imeta[5]) != len(HandoffCodec.LEAVES):
                raise ValueError(f"payload has {int(imeta[5])} row leaves; expected {len(HandoffCodec.LEAVES)}")
            rows = {}
            for i, name in enumerate(HandoffCodec.LEAVES):
                dtype = getattr(torch, str(z[f"dtype_{i}"]))
                shape = tuple(int(d) for d in z[f"shape_{i}"])
                raw = bytearray(z[f"leaf_{i}"].tobytes())
                rows[name] = torch.frombuffer(raw, dtype=dtype).reshape(shape) if raw else torch.zeros(shape, dtype=dtype)
            if engine is not None and rows["key"].dtype != engine.model.dtype:
                raise ValueError(f"payload rows are {rows['key'].dtype}; the engine serves {engine.model.dtype}")
            return {
                "prompt": np.asarray(z["prompt"], np.int32),
                "total": int(imeta[0]),
                "max_new_tokens": int(imeta[1]),
                "next_tok": int(imeta[2]),
                "lp": float(z["fmeta"][0]),
                "gen_state": np.asarray(z["gen_state"], np.uint8),
                "cache": rows,
                "wire_bytes": int(imeta[3]),
                "reused_prefix_tokens": int(imeta[4]),
                "trace": int(z["tmeta"][0]) if "tmeta" in z.files else None,
            }


# --------------------------------------------------------------------- #
# radix prefix cache
# --------------------------------------------------------------------- #


class _RadixNode:
    """One node of the compressed token trie. ``edge`` is the token label
    on the edge INTO this node; children key on their edge's first
    token. ``count`` = observed prompts whose path passes through;
    ``prefix_id`` = the engine prefix registered at this depth (None =
    structural node only)."""

    __slots__ = ("edge", "children", "count", "prefix_id", "depth", "last_used")

    def __init__(self, edge=(), depth: int = 0):
        self.edge = tuple(edge)
        self.children: dict = {}
        self.count = 0
        self.prefix_id: Optional[int] = None
        self.depth = depth
        self.last_used = 0.0


class RadixPrefixCache:
    """Cross-request prefix reuse over one engine's prefix store.

    The engine mechanism (``register_prefix`` / ``submit(prefix_id=)``)
    is token-exact but manual; this cache decides WHICH preambles are
    worth a registration and matches every prompt against them:

    * :meth:`lookup` — longest registered preamble that is a proper
      prefix of the prompt (at least one suffix token must remain —
      its logits seed the first sample). Counts a hit (+ reused tokens)
      or a miss; a miss lands in the engine's :class:`ServingMetrics`
      too (the port's engine counts the hit itself when the request is
      admitted, and its registrations and evictions, so a fleet counts
      each once);
    * :meth:`observe` — inserts the prompt's path into the trie. A trie
      node exists exactly where observed prompts diverge, so the deepest
      node with ``count >= promote_after`` and ``depth >=
      min_prefix_tokens`` IS the longest preamble shared often enough to
      pay for a registration — it gets registered (one engine prefill +
      one pinned KV row cache);
    * **eviction** — past ``max_entries`` registrations, the
      least-recently-used entry is unregistered (its rows and pool blocks freed).
      An entry still referenced by an active/queued request is skipped
      this round (the engine refuses to drop it) and retried on the
      next eviction pass. :meth:`invalidate` drops one/all entries
      explicitly — required after anything that changes what the
      registered tokens would prefill to (new model weights, changed
      tokenizer); the cache itself never goes stale within a process
      because every request builds on its own copy of the rows.

    The trie observes at most ``max_observe_tokens`` leading tokens per
    prompt (promotion candidates never exceed it), so trie memory is
    O(distinct preambles), not O(total traffic).
    """

    def __init__(
        self,
        engine,
        *,
        min_prefix_tokens: int = 8,
        promote_after: int = 2,
        max_entries: int = 8,
        max_observe_tokens: int = 4096,
        clock=time.monotonic,
    ):
        if min_prefix_tokens < 1:
            raise ValueError(f"min_prefix_tokens must be >= 1, got {min_prefix_tokens}")
        if promote_after < 2:
            raise ValueError(f"promote_after must be >= 2, got {promote_after}")
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.engine = engine
        self.min_prefix_tokens = int(min_prefix_tokens)
        self.promote_after = int(promote_after)
        self.max_entries = int(max_entries)
        self.max_observe_tokens = int(max_observe_tokens)
        self._clock = clock
        self.root = _RadixNode()
        self.entries: dict[int, _RadixNode] = {}  # prefix_id -> owning node
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.registrations = 0
        self.tokens_reused = 0

    # -- matching -------------------------------------------------------- #

    def _walk(self, toks: tuple):
        """Yield trie nodes along ``toks``' path (root excluded), stopping
        at the first divergence."""
        node, i = self.root, 0
        while i < len(toks):
            nxt = node.children.get(toks[i])
            if nxt is None:
                return
            e = nxt.edge
            if len(toks) - i < len(e) or toks[i : i + len(e)] != e:
                return
            i += len(e)
            node = nxt
            yield node

    def lookup(self, prompt_ids) -> Optional[tuple]:
        """``(prefix_id, length)`` of the longest registered preamble
        that properly prefixes ``prompt_ids`` (>= 1 suffix token left),
        or None. Counts the hit/miss and refreshes the entry's LRU
        stamp."""
        toks = tuple(int(t) for t in np.asarray(prompt_ids).ravel())
        best = None
        for node in self._walk(toks):
            if node.prefix_id is not None and node.depth < len(toks):
                best = node
        if best is None:
            self.misses += 1
            self.engine.metrics.on_prefix_miss()
            return None
        best.last_used = self._clock()
        self.hits += 1
        self.tokens_reused += best.depth
        return best.prefix_id, best.depth

    # -- observation + promotion ----------------------------------------- #

    def observe(self, prompt_ids) -> Optional[int]:
        """Insert the prompt's (capped) path into the trie; register the
        deepest preamble that just crossed the promotion threshold.
        Returns the newly registered ``prefix_id`` or None."""
        toks = tuple(int(t) for t in np.asarray(prompt_ids).ravel())
        # a registered preamble must leave >= 1 suffix token AND fit the
        # slot cache with one generated token of headroom
        cap = min(len(toks) - 1, self.max_observe_tokens, self.engine.max_len - 2)
        if cap < self.min_prefix_tokens:
            return None
        toks = toks[:cap]
        node, i = self.root, 0
        promoted: Optional[_RadixNode] = None
        while i < len(toks):
            nxt = node.children.get(toks[i])
            if nxt is None:
                child = _RadixNode(toks[i:], depth=len(toks))
                child.count = 1
                node.children[toks[i]] = child
                break
            e = nxt.edge
            common = 0
            limit = min(len(e), len(toks) - i)
            while common < limit and e[common] == toks[i + common]:
                common += 1
            if common < len(e):
                # split the edge at the divergence point: the new middle
                # node's depth IS the shared-preamble length
                mid = _RadixNode(e[:common], depth=nxt.depth - (len(e) - common))
                mid.count = nxt.count
                nxt.edge = e[common:]
                mid.children[nxt.edge[0]] = nxt
                node.children[toks[i]] = mid
                nxt = mid
            i += common if common < len(e) else len(e)
            nxt.count += 1
            node = nxt
            if (
                nxt.count >= self.promote_after
                and nxt.depth >= self.min_prefix_tokens
                and nxt.prefix_id is None
                and i == nxt.depth  # full edge consumed: toks[:i] ends here
            ):
                promoted = nxt  # keep the deepest qualifying node
            if common < len(e):
                # remainder of the prompt diverges below the split
                if i < len(toks):
                    child = _RadixNode(toks[i:], depth=len(toks))
                    child.count = 1
                    nxt.children[toks[i]] = child
                break
        if promoted is None:
            return None
        return self._register(promoted, toks[: promoted.depth])

    def _register(self, node: _RadixNode, tokens: tuple) -> Optional[int]:
        try:
            pid = self.engine.register_prefix(np.asarray(tokens, np.int32))
        except ValueError:
            # pool exhaustion (paged) or headroom: skip this round — the
            # node keeps its count and a later observe retries
            return None
        node.prefix_id = pid
        node.last_used = self._clock()
        self.entries[pid] = node
        self.registrations += 1
        self._evict_over_budget()
        return pid

    def _evict_over_budget(self) -> None:
        while len(self.entries) > self.max_entries:
            ordered = sorted(self.entries.items(), key=lambda kv: kv[1].last_used)
            evicted = False
            # never the hottest entry: when an older entry is pinned by
            # in-flight requests, churning the just-registered one would
            # throw away exactly the cache the next request hits
            for pid, node in ordered[:-1]:
                try:
                    self.engine.unregister_prefix(pid)
                except ValueError:
                    continue  # still referenced; try the next-oldest
                node.prefix_id = None
                del self.entries[pid]
                self.evictions += 1
                evicted = True
                break
            if not evicted:
                return  # everything evictable is pinned: over budget until drains

    def invalidate(self, prefix_id: Optional[int] = None) -> int:
        """Unregister one entry (or all, ``prefix_id=None``) — the
        explicit invalidation hook for weight swaps / tokenizer changes.
        Raises ValueError if a targeted entry is still referenced by an
        active or queued request. Returns the number of entries
        dropped."""
        pids = [prefix_id] if prefix_id is not None else list(self.entries)
        dropped = 0
        for pid in pids:
            node = self.entries.get(pid)
            if node is None:
                raise ValueError(f"unknown prefix_id {pid}")
            self.engine.unregister_prefix(pid)
            node.prefix_id = None
            del self.entries[pid]
            dropped += 1
        return dropped

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "registrations": self.registrations,
            "entries": len(self.entries),
            "tokens_reused": self.tokens_reused,
        }


# --------------------------------------------------------------------- #
# fleet configuration + replicas
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class FleetConfig:
    """Knobs for :class:`FleetRouter`.

    ``roles``: per-replica role tuple (``"mixed"`` | ``"prefill"`` |
    ``"decode"``). None = every replica mixed (no disaggregation).
    Disaggregation needs at least one prefill and one decode replica;
    mixed replicas count as both.

    ``handoff``: ``"auto"`` ships KV blocks only when the priced
    transfer beats the priced local re-prefill, ``"always"`` /
    ``"never"`` pin the decision (the A/B arms).

    ``prefix_reuse`` + radix knobs: see :class:`RadixPrefixCache`.

    Fault tolerance: ``tick_timeout_s`` (None = no tick wall-time SLO)
    degrades a replica on one slow tick and quarantines it after
    ``quarantine_after_timeouts`` consecutive ones (its in-flight work
    migrates); ``heal_after_ticks`` clean ticks promote a degraded
    replica back to healthy. ``failover`` picks the migration path —
    ``"auto"`` prices KV handoff vs recompute per request
    (:func:`~accelerate_tpu_torch.analysis.costmodel.price_failover`),
    ``"handoff"`` / ``"recompute"`` pin it (the chaos matrix's A/B
    arms; handoff silently falls back to recompute when the dying
    replica cannot export). The handoff leg retries with jittered
    backoff (``failover_retry_attempts`` ×
    ``failover_retry_base_delay_s``) before falling back.
    """

    routing: RoutingConfig = dataclasses.field(default_factory=RoutingConfig)
    roles: Optional[tuple] = None
    handoff: str = "auto"
    prefix_reuse: bool = True
    min_prefix_tokens: int = 8
    promote_after: int = 2
    max_prefix_entries: int = 8
    tick_timeout_s: Optional[float] = None
    quarantine_after_timeouts: int = 2
    heal_after_ticks: int = 16
    failover: str = "auto"
    failover_retry_attempts: int = 3
    failover_retry_base_delay_s: float = 0.02

    def __post_init__(self):
        if self.handoff not in ("auto", "always", "never"):
            raise ValueError(f"handoff must be auto|always|never, got {self.handoff!r}")
        if self.roles is not None:
            bad = [r for r in self.roles if r not in ("mixed", "prefill", "decode")]
            if bad:
                raise ValueError(f"roles must be mixed|prefill|decode, got {bad}")
        if self.failover not in ("auto", "handoff", "recompute"):
            raise ValueError(f"failover must be auto|handoff|recompute, got {self.failover!r}")
        if self.tick_timeout_s is not None and self.tick_timeout_s <= 0:
            raise ValueError(f"tick_timeout_s must be > 0, got {self.tick_timeout_s}")
        if self.quarantine_after_timeouts < 1:
            raise ValueError(
                f"quarantine_after_timeouts must be >= 1, got {self.quarantine_after_timeouts}"
            )
        if self.heal_after_ticks < 1:
            raise ValueError(f"heal_after_ticks must be >= 1, got {self.heal_after_ticks}")
        if self.failover_retry_attempts < 1:
            raise ValueError(
                f"failover_retry_attempts must be >= 1, got {self.failover_retry_attempts}"
            )


class Replica:
    """One engine + its fleet-side state. ``lock`` serializes host
    bookkeeping between the router and a per-replica drain thread; the
    engine itself is single-threaded by contract.

    Health (router-driven, see :meth:`FleetRouter._tick_replica`):
    ``healthy`` serves normally; ``degraded`` (a tick blew the wall-time
    SLO) still serves but is one strike from quarantine and heals after
    ``heal_after_ticks`` clean ticks; ``quarantined`` (circuit broken:
    repeated timeouts or poisoned numerics) and ``dead`` (the engine
    raised) never tick or receive routes again — their in-flight work
    has already migrated. ``draining`` additionally blocks NEW routes
    while :meth:`FleetRouter.drain` moves the existing work off."""

    def __init__(self, engine, name: str, role: str = "mixed"):
        self.engine = engine
        self.name = name
        self.role = role
        self.radix: Optional[RadixPrefixCache] = None
        # per-replica crash flight recorder (telemetry.flightrec), wired
        # by a tracing router as a tap on the engine's eventlog
        self.flightrec = None
        self.lock = threading.RLock()
        self.health = "healthy"
        self.draining = False
        self.consecutive_timeouts = 0
        self.clean_ticks = 0
        self.last_error: Optional[str] = None
        engine.metrics.replica = name

    @property
    def load(self) -> int:
        return len(self.engine.queue) + self.engine.active_count

    @property
    def busy(self) -> bool:
        return bool(self.engine.queue or self.engine.active_count)

    @property
    def is_serving(self) -> bool:
        """Still ticking: healthy or degraded (a dead/quarantined
        engine's host state is a read-only husk for failover export)."""
        return self.health in ("healthy", "degraded")

    @property
    def routable(self) -> bool:
        """Eligible for NEW work: serving and not draining."""
        return self.is_serving and not self.draining

    def can_prefill(self) -> bool:
        return self.role in ("mixed", "prefill")

    def can_decode(self) -> bool:
        return self.role in ("mixed", "decode")


# --------------------------------------------------------------------- #
# the router
# --------------------------------------------------------------------- #


class FleetRouter:
    """Route an open-loop request stream over N engine replicas.

    Build it from pre-constructed engines (tests, heterogeneous
    replicas) or :meth:`from_model` (N uniform replicas over one model
    object). The public
    surface mirrors the engine: :meth:`submit` → fleet uid,
    :meth:`step` / :meth:`run` / :meth:`drain_threaded` drive,
    :meth:`poll` / :meth:`partial` / :meth:`logprobs` / :meth:`cancel`
    resolve, :meth:`metrics_merged` / :meth:`prometheus_text` observe.
    """

    def __init__(
        self,
        engines: Sequence,
        config: Optional[FleetConfig] = None,
        names=None,
        trace=None,
    ):
        if not engines:
            raise ValueError("need at least one engine")
        self.config = config or FleetConfig()
        roles = self.config.roles or ("mixed",) * len(engines)
        if len(roles) != len(engines):
            raise ValueError(f"{len(roles)} roles for {len(engines)} engines")
        names = names or [f"r{i}" for i in range(len(engines))]
        self.replicas = [Replica(e, n, r) for e, n, r in zip(engines, names, roles)]
        self.disaggregated = any(r.role == "prefill" for r in self.replicas)
        if self.disaggregated and not any(r.can_decode() for r in self.replicas):
            raise ValueError("disaggregated fleet needs at least one decode-capable replica")
        if self.config.prefix_reuse:
            for rep in self.replicas:
                if rep.can_prefill() and rep.engine.draft_model is None:
                    rep.radix = RadixPrefixCache(
                        rep.engine,
                        min_prefix_tokens=self.config.min_prefix_tokens,
                        promote_after=self.config.promote_after,
                        max_entries=self.config.max_prefix_entries,
                    )
        self._policy = FleetRoutingPolicy(self.config.routing)
        self._uid = 0
        # fleet uid -> ("replica", idx, local_uid) | ("pending", None)
        #            | ("done", full, new, lps)  — results salvaged off a
        #              failed/drained replica before it left the fleet
        self._map: dict[int, tuple] = {}
        self._shed: dict[int, ShedError] = {}
        self._lost: dict[int, str] = {}  # fuid -> why failover could not save it
        self._pending: list[dict] = []  # disaggregated requests awaiting prefill+handoff
        self._lock = threading.RLock()
        self._mk_engine = None  # set by from_model: spin_up's factory
        self._replica_seq = len(self.replicas)  # monotonic spin_up naming
        # KV-handoff accounting: predictions are priced BEFORE each
        # transfer; moved bytes are what actually shipped — the two must
        # agree exactly (the tests and chip_smoke.py assert it)
        self.handoffs = 0
        self.handoffs_local = 0  # auto-decision chose local re-prefill
        self.handoff_bytes_predicted = 0
        self.handoff_bytes_moved = 0
        self.handoff_time_us_predicted = 0.0
        self.fleet_shed = 0  # fleet-level SLO rejections (router edge)
        # failover accounting — same predicted-vs-moved discipline as the
        # KV handoffs (the pin the chaos tests assert)
        self.failovers = 0
        self.failovers_kv = 0
        self.failovers_recompute = 0
        self.failovers_lost = 0
        self.failover_bytes_predicted = 0
        self.failover_bytes_moved = 0
        self.failover_time_us_predicted = 0.0
        self.failover_recompute_us_predicted = 0.0
        # ---- request tracing + flight recorder (telemetry.trace) ----
        # `trace` is None (off), True (defaults), or a TraceConfig. One
        # Tracer spans the whole fleet (trace ids are fleet-global); each
        # replica gets a bounded flight recorder tapping its eventlog.
        self.tracer = None
        self.critpath = None
        self.trace_config = None
        self._trace_ids: dict[int, int] = {}  # fuid -> trace id
        if trace is not None and trace is not False:
            from .telemetry.critpath import CritPathMonitor
            from .telemetry.trace import TraceConfig, Tracer

            tcfg = TraceConfig() if trace is True else trace
            if tcfg.enabled:
                self.trace_config = tcfg
                tlog = self.replicas[0].engine._log
                if tcfg.drift_check:
                    self.critpath = CritPathMonitor(tlog, thresholds=tcfg.drift_thresholds)
                self.tracer = Tracer(
                    max_traces=tcfg.max_traces,
                    log=tlog,
                    on_finish=None if self.critpath is None else self.critpath.observe,
                )
                for rep in self.replicas:
                    self._wire_replica_tracing(rep)

    def _wire_replica_tracing(self, rep: Replica) -> None:
        """Hand the fleet tracer to one replica's engine and tap its
        eventlog into a per-replica crash flight recorder."""
        if self.tracer is None:
            return
        rep.engine.tracer = self.tracer
        tcfg = self.trace_config
        if tcfg.flight_recorder and rep.flightrec is None:
            from .telemetry.flightrec import FlightRecorder

            rep.flightrec = FlightRecorder(tcfg.flight_capacity, name=rep.name)
            rep.engine._log.add_tap(rep.flightrec.record)

    # -- construction ---------------------------------------------------- #

    @classmethod
    def from_model(
        cls,
        model,
        num_replicas: int = 2,
        config: Optional[FleetConfig] = None,
        store_dir: Optional[str] = None,
        trace=None,
        **engine_kwargs,
    ) -> "FleetRouter":
        """N uniform replicas over one model object (its weights held once
        on the device; each replica has its own slot caches). With
        ``store_dir``, every replica's :class:`~.aot.ProgramCache` shares
        one :class:`~.aot.ExecutableStore`: the first replica to run a
        program stores it (its kernel libraries included), every later
        replica, :meth:`spin_up`'s included, installs it from there."""
        from .serving import ServingEngine

        def mk(name: str) -> "ServingEngine":
            pc = None
            if store_dir is not None:
                from .aot import ExecutableStore, ProgramCache

                pc = ProgramCache(store=ExecutableStore(store_dir), name=name)
            return ServingEngine(model, program_cache=pc, **engine_kwargs)

        router = cls([mk(f"r{i}") for i in range(num_replicas)], config=config, trace=trace)
        router._mk_engine = mk
        return router

    def spin_up(self, warm_prompt_lens=(4,), max_new_tokens: int = 2, role: str = "mixed") -> dict:
        """Add one replica at runtime and warm its serving programs (one
        request a length in ``warm_prompt_lens``). Returns ``{"replica",
        "spinup_ms", "compiles", "deserialized", "nvcc_builds"}``:
        ``compiles`` and ``deserialized`` are the new replica's program
        cache misses and store installs (over a shared store the compile
        count is 0, as in the JAX package), ``nvcc_builds`` the kernel
        libraries ``nvcc`` built during the warm-up (``kernels/build.py``),
        0 once the build directory holds them. Only available on a
        :meth:`from_model` router."""
        from .kernels import build

        if self._mk_engine is None:
            raise ValueError("spin_up needs a from_model router (an engine factory)")
        with self._lock:
            # monotonic sequence, skipping anything still (or ever) taken:
            # after a drain removed "r1", the next spin-up must NOT mint a
            # second "r1" and alias its metrics/events
            taken = {r.name for r in self.replicas}
            while f"r{self._replica_seq}" in taken:
                self._replica_seq += 1
            name = f"r{self._replica_seq}"
            self._replica_seq += 1
        builds = build.nvcc_builds
        t0 = time.perf_counter()
        engine = self._mk_engine(name)
        rep = Replica(engine, name, role)
        if self.config.prefix_reuse and rep.can_prefill():
            rep.radix = RadixPrefixCache(
                engine,
                min_prefix_tokens=self.config.min_prefix_tokens,
                promote_after=self.config.promote_after,
                max_entries=self.config.max_prefix_entries,
            )
        rng = np.random.default_rng(0)
        for n in warm_prompt_lens:
            engine.submit(rng.integers(1, 100, size=int(n)).astype(np.int32), max_new_tokens)
        engine.run()
        # wire tracing only AFTER the warm-up requests drained, so the
        # synthetic warm prompts never show up as traced fleet requests
        self._wire_replica_tracing(rep)
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self.replicas.append(rep)
        pc = engine.program_cache
        return {"replica": name, "spinup_ms": round(ms, 3), "compiles": pc.misses, "deserialized": pc.deserialized,
                "nvcc_builds": build.nvcc_builds - builds}

    def add_replica(
        self, role: str = "mixed", warm_prompt_lens=(4,), max_new_tokens: int = 2
    ) -> dict:
        """Hot re-add: recover capacity lost to a quarantine/death/drain
        by spinning up a fresh replica (:meth:`spin_up` reports its
        program compiles, 0 over a shared store, and its ``nvcc`` builds,
        0 with the kernels built). The recovery half of the
        fault-tolerance story; returns the spin-up report."""
        return self.spin_up(
            warm_prompt_lens=warm_prompt_lens, max_new_tokens=max_new_tokens, role=role
        )

    # -- submission ------------------------------------------------------ #

    def submit(
        self,
        prompt_ids,
        max_new_tokens: int = 32,
        priority: int = 0,
        stop_sequences=None,
    ) -> int:
        """Route one request; returns a FLEET uid (resolve via
        :meth:`poll`). Fleet-level SLO shedding raises the structured
        :class:`ShedError` before any replica is touched; per-replica
        scheduler SLOs still apply after routing."""
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        with self._lock:
            routable = self._routable_indices()
            # circuit breaker: with zero serving capacity, reject at the
            # edge instead of queueing into replicas that will never tick
            reason = self._policy.shed_on_capacity(len(routable))
            if reason is None:
                depth = sum(
                    len(self.replicas[i].engine.queue) for i in routable
                ) + len(self._pending)
                reason = self._policy.shed_on_submit(int(priority), depth)
            else:
                depth = len(self._pending)
            if reason is not None:
                self.fleet_shed += 1
                raise ShedError(reason, priority=int(priority), queue_depth=depth)
            if self.disaggregated:
                # validate BEFORE queueing a pending entry: a bad request
                # must fail the caller here, not blow up a prefill replica
                # at dispatch (where an engine error means replica death)
                if len(prompt) == 0:
                    raise ValueError("empty prompt")
                if int(max_new_tokens) < 1:
                    raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
                cap = min(self.replicas[i].engine.max_len for i in routable)
                if len(prompt) + int(max_new_tokens) > cap:
                    raise ValueError(
                        f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                        f"exceeds the slot cache ({cap})"
                    )
            fuid = self._uid
            self._uid += 1
            # trace minted AFTER the fleet-edge shed gates: an edge
            # rejection never touched a replica, so it carries no trace
            tid = None
            if self.tracer is not None:
                tid = self.tracer.start(fuid=fuid, prompt_tokens=int(len(prompt)))
                self._trace_ids[fuid] = tid
            if self.disaggregated and not self._handoff_decision(len(prompt)):
                self.handoffs_local += 1
            elif self.disaggregated:
                self._pending.append(
                    {
                        "fuid": fuid,
                        "prompt": prompt,
                        "max_new_tokens": int(max_new_tokens),
                        "priority": int(priority),
                        "stop_sequences": stop_sequences,
                        "trace": tid,
                    }
                )
                self._map[fuid] = ("pending", None)
                return fuid
            idx = self._route_local(prompt)
        rep = self.replicas[idx]
        with rep.lock:
            prefix = rep.radix.lookup(prompt) if rep.radix is not None else None
            if prefix is not None:
                pid, plen = prefix
                local = rep.engine.submit(
                    prompt[plen:], max_new_tokens, prefix_id=pid,
                    stop_sequences=stop_sequences, priority=priority, trace=tid,
                )
            else:
                local = rep.engine.submit(
                    prompt, max_new_tokens, stop_sequences=stop_sequences,
                    priority=priority, trace=tid,
                )
                if rep.radix is not None:
                    rep.radix.observe(prompt)
        with self._lock:
            self._map[fuid] = ("replica", idx, local)
        return fuid

    def _routable_indices(self, *, prefill: bool = False, decode: bool = False, exclude=None):
        """Replica indices the circuit breaker allows NEW work onto
        (serving, not draining), optionally role-filtered and excluding
        one replica (a failover's source)."""
        out = []
        for i, r in enumerate(self.replicas):
            if not r.routable or r is exclude:
                continue
            if prefill and not r.can_prefill():
                continue
            if decode and not r.can_decode():
                continue
            out.append(i)
        return out

    def _route_local(self, prompt: np.ndarray) -> int:
        """Replica index for a locally-prefilled request: prefix affinity
        first (the replica already holding the longest registered
        preamble), else the routing policy over decode-capable load.
        Quarantined/dead/draining replicas are never candidates."""
        eligible = [
            i for i in self._routable_indices(decode=True)
            if self.replicas[i].can_prefill()
        ]
        if not eligible:  # disaggregated fleet deciding "local": decode side prefills
            eligible = self._routable_indices(decode=True)
        if not eligible:
            self.fleet_shed += 1
            raise ShedError("no decode-capable serving replicas (fleet capacity lost)")
        best_i, best_len = None, 0
        toks = tuple(int(t) for t in prompt)
        for i in eligible:
            radix = self.replicas[i].radix
            if radix is None:
                continue
            # peek without counting a hit/miss: only the routed replica's
            # lookup() is the real match
            depth = 0
            for node in radix._walk(toks):
                if node.prefix_id is not None and node.depth < len(toks):
                    depth = node.depth
            if depth > best_len:
                best_i, best_len = i, depth
        if best_i is not None:
            return best_i
        loads = [r.load for r in self.replicas]
        return self._policy.pick_replica(loads, eligible)

    def _handoff_decision(self, prompt_len: int) -> bool:
        """Ship the KV blocks (True) or let the decode replica re-prefill
        locally (False) — priced before anything runs."""
        mode = self.config.handoff
        if mode == "always":
            return True
        if mode == "never":
            return False
        pred, alt_us = self._price_handoff(prompt_len)
        return pred["time_us"] <= alt_us

    def _price_handoff(self, tokens: int):
        """(price_kv_handoff dict, local re-prefill us) for one prompt."""
        from .analysis.costmodel import DEFAULT_GENERATION, device_generation, prefill_compute_us, price_kv_handoff

        src = next(
            (r for r in self.replicas if r.routable and r.can_prefill()),
            next((r for r in self.replicas if r.can_prefill()), self.replicas[0]),
        )
        per_tok, fixed = src.engine.kv_handoff_dims()
        if not hasattr(self, "_param_count"):
            self._param_count = int(src.engine.model.num_parameters())
            # the attached card's row (the H100's without a card)
            self._generation = device_generation() or DEFAULT_GENERATION
        pred = price_kv_handoff(per_tok, tokens, fixed_bytes=fixed, generation=self._generation)
        return pred, prefill_compute_us(self._param_count, tokens, generation=self._generation)

    # -- replica health + failover ---------------------------------------- #

    def _replica_by_name(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise ValueError(f"unknown replica {name!r} (have {[r.name for r in self.replicas]})")

    def _set_health(self, rep: Replica, state: str, reason: str = "") -> None:
        # rep.lock (an RLock, and always ordered BEFORE self._lock) so the
        # drain_threaded workers' is_serving checks can't read a torn
        # transition
        with rep.lock:
            if rep.health == state:
                return
            prev, rep.health = rep.health, state
        rep.engine.metrics.on_replica_state(HEALTH_STATES.index(state))
        rep.engine._log.event(
            "replica_state", replica=rep.name, prev=prev, state=state, reason=reason
        )
        # fatal transitions auto-dump the replica's flight recorder: the
        # ring already holds the fault's events (the emit above included),
        # plus the in-flight table and any open trace spans
        if state in ("quarantined", "dead"):
            self._flight_dump(rep, reason=f"{state}: {reason}")

    def _flight_dump(self, rep: Replica, reason: str) -> None:
        """Dump one replica's flight recorder (no-op when tracing is off).
        Never raises — the dump rides a failure path that must complete."""
        fr = rep.flightrec
        if fr is None:
            return
        inflight = []
        try:
            for uid, (state, req) in list(rep.engine._index.items()):
                if state == "done" or req is None:
                    continue
                inflight.append(
                    {
                        "uid": int(uid),
                        "state": state,
                        "generated": len(req.out_tokens),
                        "priority": int(req.priority),
                        "trace": req.trace,
                    }
                )
        except Exception:  # noqa: BLE001 — a husk's host tables may be torn
            pass
        spans = self.tracer.open_spans() if self.tracer is not None else []
        path = None
        tcfg = self.trace_config
        if tcfg is not None and tcfg.flight_dump_dir:
            path = os.path.join(tcfg.flight_dump_dir, f"flight_{rep.name}.json")
        doc = fr.dump(reason=reason, inflight=inflight, open_spans=spans, path=path)
        rep.engine._log.event(
            "flight_dump", replica=rep.name, reason=reason,
            events=len(doc["events"]), inflight=len(inflight),
            open_spans=len(spans), path=path,
        )

    @staticmethod
    def _classify(exc: BaseException) -> str:
        """``"poison"`` (numerics suspect — quarantine, recompute-only
        failover) or ``"crash"`` (process-style death — dead, KV export
        still trusted). Non-finite surfaces either as the typed
        :class:`NonFinitePoison` or as a message from the watchdog's
        ``nonfinite`` vocabulary."""
        if isinstance(exc, NonFinitePoison):
            return "poison"
        if "nonfinite" in str(exc).lower().replace("-", "").replace(" ", ""):
            return "poison"
        return "crash"

    def _on_replica_error(self, rep: Replica, exc: BaseException) -> None:
        """An engine raised (or was declared failed): classify, break the
        circuit, and migrate every in-flight request to survivors."""
        kind = self._classify(exc)
        rep.last_error = f"{type(exc).__name__}: {exc}"
        rep.engine.metrics.on_replica_error()
        self._set_health(
            rep, "quarantined" if kind == "poison" else "dead", reason=rep.last_error
        )
        self._migrate_all(rep, reason=kind, allow_kv=(kind != "poison"))

    def _on_replica_timeout(self, rep: Replica, dt: float) -> None:
        rep.consecutive_timeouts += 1
        rep.clean_ticks = 0
        rep.engine.metrics.on_replica_timeout()
        rep.engine._log.event(
            "replica_timeout", replica=rep.name, tick_s=round(dt, 4),
            consecutive=rep.consecutive_timeouts,
        )
        if rep.consecutive_timeouts >= self.config.quarantine_after_timeouts:
            rep.last_error = (
                f"tick timeout x{rep.consecutive_timeouts} "
                f"({dt:.3f}s > {self.config.tick_timeout_s}s)"
            )
            self._set_health(rep, "quarantined", reason=rep.last_error)
            # a hung-then-quarantined replica's host state is intact (the
            # tick finished, just late) — its KV rows are trustworthy
            self._migrate_all(rep, reason="timeout", allow_kv=True)
        elif rep.health == "healthy":
            self._set_health(
                rep, "degraded", reason=f"tick {dt:.3f}s > {self.config.tick_timeout_s}s"
            )

    def _on_replica_clean(self, rep: Replica) -> None:
        rep.consecutive_timeouts = 0
        if rep.health == "degraded":
            rep.clean_ticks += 1
            if rep.clean_ticks >= self.config.heal_after_ticks:
                rep.clean_ticks = 0
                self._set_health(rep, "healthy", reason="clean ticks")

    def _tick_replica(self, rep: Replica) -> int:
        """One guarded engine tick: exceptions classify the replica
        failed (and migrate its work); wall-time drives the
        degraded/quarantined transitions when ``tick_timeout_s`` is
        set."""
        try:
            with rep.lock:
                if not rep.busy:
                    return 0
                t0 = time.perf_counter()
                active = rep.engine.step()
                dt = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — any engine death is a replica fault
            self._on_replica_error(rep, e)
            return 0
        if self.config.tick_timeout_s is not None and dt > self.config.tick_timeout_s:
            self._on_replica_timeout(rep, dt)
        else:
            self._on_replica_clean(rep)
        return active if rep.is_serving else 0

    def _migrate_all(self, rep: Replica, reason: str, allow_kv: bool = True) -> dict:
        """Move EVERY in-flight request owned by ``rep`` to survivors:
        finished results are salvaged as-is, shed requests keep their
        structured error, and live requests fail over token-exactly via
        :meth:`ServingEngine.export_inflight`. Anything unsnapshottable
        lands in ``_lost`` with a reason (surfaced by
        :class:`FleetRequestError`) — counted, never silent."""
        with self._lock:
            idx = self.replicas.index(rep)
            owned = {
                loc[2]: fuid
                for fuid, loc in self._map.items()
                if loc[0] == "replica" and loc[1] == idx
            }
        migrated = lost = 0
        with rep.lock:
            eng = rep.engine
            for local, fuid in list(owned.items()):
                got = eng.done.get(local)
                if got is not None:
                    with self._lock:
                        self._map[fuid] = (
                            "done", got, eng._done_new.get(local), eng._done_lps.get(local)
                        )
                    del owned[local]
                    continue
                err = eng._shed.get(local)
                if err is not None:
                    with self._lock:
                        self._shed[fuid] = err
                        self._map.pop(fuid, None)
                    del owned[local]
            by_uid = {}
            if owned:
                try:
                    by_uid = {
                        int(s["uid"]): s for s in eng.export_inflight(include_kv=allow_kv)
                    }
                except Exception as e:  # noqa: BLE001 — a husk too broken to export
                    eng._log.event(
                        "failover_export_failed", replica=rep.name,
                        error=f"{type(e).__name__}: {e}",
                    )
        for local, fuid in owned.items():
            snap = by_uid.get(local)
            if snap is None:
                with self._lock:
                    self._map.pop(fuid, None)
                    self._lost[fuid] = (
                        f"in-flight on replica {rep.name!r} at {reason}; no snapshot recovered"
                    )
                    self.failovers_lost += 1
                rep.engine.metrics.on_failover_lost()
                if self.tracer is not None:
                    self.tracer.finish(
                        self._trace_ids.get(fuid), status="lost",
                        reason=f"no snapshot recovered ({reason})",
                    )
                lost += 1
                continue
            if self._failover_one(rep, fuid, snap, reason):
                migrated += 1
            else:
                lost += 1
        return {"migrated": migrated, "lost": lost}

    def _failover_choice(self, snap: dict):
        """``(path, handoff_pred, recompute_us)`` for one snapshot,
        priced BEFORE anything moves
        (:func:`~accelerate_tpu_torch.analysis.costmodel.price_failover`);
        ``config.failover`` pins the path for the A/B arms."""
        if snap.get("cache") is None:
            return "recompute", {"bytes": 0, "time_us": 0.0}, 0.0
        from .analysis.costmodel import price_failover

        src = next(
            (r for r in self.replicas if r.can_prefill()), self.replicas[0]
        )
        per_tok, fixed = src.engine.kv_handoff_dims()
        self._price_handoff(1)  # ensures _param_count and _generation are cached
        priced = price_failover(
            per_tok,
            len(snap["prompt"]),
            len(snap.get("out_tokens") or []),
            self._param_count,
            fixed_bytes=fixed,
            generation=self._generation,
        )
        mode = self.config.failover
        path = priced["path"] if mode == "auto" else mode
        return path, priced["handoff"], priced["recompute_us"]

    def _failover_one(self, src_rep: Replica, fuid: int, snap: dict, reason: str) -> bool:
        """Migrate ONE snapshotted request to a surviving replica; the
        KV-handoff leg retries with jittered backoff and falls back to
        recompute (always available) rather than losing the request."""
        cfg = self.config
        cand = self._routable_indices(decode=True, exclude=src_rep)
        if not cand:
            cand = self._routable_indices(exclude=src_rep)
        if not cand:
            with self._lock:
                self._map.pop(fuid, None)
                self._lost[fuid] = f"no surviving replica to migrate to ({reason})"
                self.failovers_lost += 1
            src_rep.engine.metrics.on_failover_lost()
            if self.tracer is not None:
                self.tracer.finish(
                    snap.get("trace"), status="lost",
                    reason=f"no surviving replica ({reason})",
                )
            return False
        with self._lock:
            loads = [r.load for r in self.replicas]
            d_idx = self._policy.pick_replica(loads, cand)
        dst = self.replicas[d_idx]
        path, pred, recompute_us = self._failover_choice(snap)
        moved = 0
        local = None
        if path == "handoff":
            moved = int(sum(x.numel() * x.element_size() for x in snap["cache"].values()))

            def leg():
                with dst.lock:
                    return dst.engine.import_inflight(snap)

            try:
                local = retry_call(
                    leg,
                    attempts=cfg.failover_retry_attempts,
                    base_delay=cfg.failover_retry_base_delay_s,
                    max_delay=0.5,
                    on_retry=lambda attempt, delay, e: dst.engine._log.event(
                        "failover_retry", fuid=fuid, dst=dst.name, attempt=attempt,
                        delay_s=round(delay, 4), error=f"{type(e).__name__}: {e}",
                    ),
                )
            except Exception:  # noqa: BLE001 — the KV leg is an optimisation, never a requirement
                path, moved, local = "recompute", 0, None
        if local is None:
            slim = {k: v for k, v in snap.items() if k not in ("cache", "rows")}
            with dst.lock:
                local = dst.engine.import_inflight(slim)
        with self._lock:
            self._map[fuid] = ("replica", d_idx, local)
            self.failovers += 1
            if path == "handoff":
                self.failovers_kv += 1
                self.failover_bytes_predicted += int(pred["bytes"])
                self.failover_bytes_moved += moved
                self.failover_time_us_predicted += float(pred["time_us"])
            else:
                self.failovers_recompute += 1
                self.failover_recompute_us_predicted += float(recompute_us)
        src_rep.engine.metrics.on_failover_out()
        if self.tracer is not None:
            # drain migrations get their own segment class so a planned
            # removal never pollutes the failover latency distribution
            self.tracer.seg(
                snap.get("trace"), "drain" if reason == "drain" else "failover",
                src=src_rep.name, dst=dst.name, path=path, reason=reason,
                moved_bytes=moved,
                predicted_bytes=int(pred["bytes"]) if path == "handoff" else 0,
                predicted_us=round(float(pred["time_us"]), 3),
                recompute_us=round(float(recompute_us), 3),
            )
        dst.engine._log.event(
            "failover", fuid=fuid, src=src_rep.name, dst=dst.name, path=path,
            reason=reason, generated=len(snap.get("out_tokens") or []),
            predicted_bytes=int(pred["bytes"]) if path == "handoff" else 0,
            moved_bytes=moved, predicted_us=round(float(pred["time_us"]), 3),
            recompute_us=round(float(recompute_us), 3),
            trace=snap.get("trace"),
        )
        return True

    def fail_replica(self, name: str, error: Optional[BaseException] = None) -> dict:
        """Operator surface: declare a replica failed out-of-band (its
        pod died, its host is being reclaimed) — classifies, breaks the
        circuit, migrates its in-flight work. Returns the replica's
        post-transition health entry."""
        rep = self._replica_by_name(name)
        self._on_replica_error(
            rep, error if error is not None else RuntimeError("declared failed by operator")
        )
        return self.health()[rep.name]

    def drain(self, name: str) -> dict:
        """Gracefully remove one replica: stop admissions to it, migrate
        its in-flight work to survivors (token- and logprob-exact, same
        machinery as failure — but the engine is healthy so its KV is
        always exportable), then drop it from the fleet. Returns
        ``{"replica", "migrated", "lost"}``."""
        rep = self._replica_by_name(name)
        with self._lock:
            if not [r for r in self.replicas if r is not rep and r.routable]:
                raise ValueError(
                    f"cannot drain {name!r}: no other serving replica to take its work"
                )
            rep.draining = True
        res = self._migrate_all(rep, reason="drain", allow_kv=True)
        self._remove_replica(rep)
        rep.engine._log.event(
            "replica_drain", replica=rep.name, migrated=res["migrated"], lost=res["lost"]
        )
        return {"replica": rep.name, **res}

    def _remove_replica(self, rep: Replica) -> None:
        with self._lock:
            idx = self.replicas.index(rep)
            self.replicas.pop(idx)
            for fuid, loc in list(self._map.items()):
                if loc[0] != "replica":
                    continue
                if loc[1] == idx:  # only if a migration leg failed above
                    self._map.pop(fuid)
                    self._lost[fuid] = f"replica {rep.name!r} removed"
                    if self.tracer is not None:
                        self.tracer.finish(
                            self._trace_ids.get(fuid), status="lost",
                            reason=f"replica {rep.name!r} removed",
                        )
                elif loc[1] > idx:
                    self._map[fuid] = ("replica", loc[1] - 1, loc[2])

    def health(self) -> dict:
        """Per-replica health view: ``{name: {health, role, draining,
        consecutive_timeouts, last_error, load}}``."""
        with self._lock:
            return {
                r.name: {
                    "health": r.health,
                    "role": r.role,
                    "draining": r.draining,
                    "consecutive_timeouts": r.consecutive_timeouts,
                    "last_error": r.last_error,
                    "load": r.load,
                }
                for r in self.replicas
            }

    # -- driving --------------------------------------------------------- #

    def dispatch_pending(self, limit: Optional[int] = None) -> int:
        """Run queued disaggregated prefills: each pending request
        prefills on the least-loaded prefill replica (radix reuse
        applies), its KV rows hand off to the least-loaded decode
        replica, and the router's byte accounting updates. Returns the
        number dispatched."""
        n = 0
        while True:
            with self._lock:
                if not self._pending or (limit is not None and n >= limit):
                    return n
                d_cand = self._routable_indices(decode=True)
                if not d_cand:
                    # terminal for pending work: nothing can ever decode
                    # these — account them lost instead of leaking
                    # forever-pending entries
                    for entry in self._pending:
                        self._map.pop(entry["fuid"], None)
                        self._lost[entry["fuid"]] = (
                            "no decode-capable serving replica for pending handoff"
                        )
                        self.failovers_lost += 1
                        if self.tracer is not None:
                            self.tracer.finish(
                                entry.get("trace"), status="lost",
                                reason="no decode-capable serving replica",
                            )
                    self._pending.clear()
                    return n
                # prefill side lost? decode replicas self-prefill detached
                # (role is a preference, not a capability — and uid_key
                # keeps the sampling chain identical either way)
                p_cand = self._routable_indices(prefill=True) or d_cand
                entry = self._pending.pop(0)
                loads = [r.load for r in self.replicas]
                p_idx = self._policy.pick_replica(loads, p_cand)
                d_idx = self._policy.pick_replica(loads, d_cand)
                pred, _ = self._price_handoff(len(entry["prompt"]))
            p_rep, d_rep = self.replicas[p_idx], self.replicas[d_idx]
            try:
                with p_rep.lock:
                    crash_point("pre_handoff", replica=p_rep.name)
                    prefix = (
                        p_rep.radix.lookup(entry["prompt"]) if p_rep.radix is not None else None
                    )
                    handoff = p_rep.engine.prefill_detached(
                        entry["prompt"], entry["max_new_tokens"],
                        uid_key=entry["fuid"],
                        prefix_id=None if prefix is None else prefix[0],
                        trace=entry.get("trace"),
                    )
                    if p_rep.radix is not None and prefix is None:
                        p_rep.radix.observe(entry["prompt"])
            except Exception as e:  # noqa: BLE001 — prefill replica died mid-dispatch
                with self._lock:
                    # the entry never left the router: requeue at the head
                    # (nothing ran — redispatch is exact by construction)
                    self._pending.insert(0, entry)
                self._on_replica_error(p_rep, e)
                continue
            with d_rep.lock:
                local = d_rep.engine.submit_prefilled(
                    handoff, stop_sequences=entry["stop_sequences"],
                    priority=entry["priority"],
                )
            with self._lock:
                self._map[entry["fuid"]] = ("replica", d_idx, local)
                self.handoffs += 1
                self.handoff_bytes_predicted += pred["bytes"]
                self.handoff_bytes_moved += handoff["wire_bytes"]
                self.handoff_time_us_predicted += pred["time_us"]
            if self.tracer is not None:
                # the router-side handoff span carries both sides of the
                # price: critpath pins moved_bytes == predicted_bytes
                self.tracer.seg(
                    entry.get("trace"), "kv_handoff",
                    src=p_rep.name, dst=d_rep.name, tokens=int(handoff["total"]),
                    moved_bytes=int(handoff["wire_bytes"]),
                    predicted_bytes=int(pred["bytes"]),
                    predicted_us=round(float(pred["time_us"]), 3),
                )
            p_rep.engine._log.event(
                "kv_handoff", fuid=entry["fuid"], src=p_rep.name, dst=d_rep.name,
                tokens=handoff["total"], predicted_bytes=pred["bytes"],
                moved_bytes=handoff["wire_bytes"],
                predicted_us=round(pred["time_us"], 3),
                reused_prefix_tokens=handoff["reused_prefix_tokens"],
                trace=entry.get("trace"),
            )
            n += 1

    def step(self) -> int:
        """One fleet tick: dispatch pending handoffs, then one guarded
        engine tick per busy SERVING replica (quarantined/dead replicas
        never tick — an engine exception fails the replica over instead
        of propagating). Returns occupied slots across the fleet (plus
        pending handoffs)."""
        self.dispatch_pending()
        active = 0
        for rep in list(self.replicas):
            if rep.is_serving:
                active += self._tick_replica(rep)
        with self._lock:
            return active + len(self._pending)

    def run(self) -> dict:
        """Drive ticks until every replica drains; returns
        ``{fleet_uid: full token array}`` — including results salvaged
        off failed/drained replicas."""
        while self._work_remaining():
            self.step()
        out = {}
        with self._lock:
            items = list(self._map.items())
        for fuid, loc in items:
            if loc[0] == "replica":
                got = self.replicas[loc[1]].engine.done.get(loc[2])
                if got is not None:
                    out[fuid] = got
            elif loc[0] == "done":
                out[fuid] = loc[1]
        return out

    def drain_threaded(self) -> float:
        """Drain all queued/pending work with one thread per replica
        (wall-clock overlap across replicas: the kernels' ``ctypes`` calls
        and PyTorch's operators release the GIL); the caller's thread keeps
        dispatching handoffs.
        Returns elapsed seconds. Use :meth:`step` when determinism
        matters more than wall-clock.

        Worker-thread exceptions are NEVER invisible: each worker
        captures its exception, the caller's loop classifies it
        (:meth:`_on_replica_error` — replica marked failed, in-flight
        work failed over to survivors) and keeps draining. Only when no
        serving replica remains is the first captured exception
        re-raised — otherwise the fault is surfaced through replica
        health/events and the drain completes on the survivors."""
        t0 = time.perf_counter()
        stop = threading.Event()
        errors: list = []
        err_lock = threading.Lock()

        def worker(rep: Replica):
            while not stop.is_set():
                try:
                    with rep.lock:
                        # health is read under the same lock _set_health
                        # writes it: a failover on the caller's thread
                        # can't interleave with a half-observed state
                        if not rep.is_serving:
                            return
                        busy = rep.busy
                        if busy:
                            rep.engine.step()
                except Exception as e:  # noqa: BLE001 — surfaced by the caller's loop
                    with err_lock:
                        errors.append((rep, e))
                    return
                if not busy:
                    time.sleep(0.0005)

        threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in self.replicas]
        for t in threads:
            t.start()
        first_exc: Optional[BaseException] = None

        def handle_errors():
            nonlocal first_exc
            with err_lock:
                batch, errors[:] = list(errors), []
            for rep, exc in batch:
                if first_exc is None:
                    first_exc = exc
                # failover runs on the CALLER's thread: the dead worker
                # already released its lock on the way out, and survivors'
                # locks are only held a tick at a time
                self._on_replica_error(rep, exc)

        try:
            while True:
                handle_errors()
                if not self._work_remaining():
                    break
                self.dispatch_pending()
                time.sleep(0.0005)
        finally:
            stop.set()
            for t in threads:
                t.join()
            handle_errors()
        if first_exc is not None and not any(r.is_serving for r in self.replicas):
            raise first_exc
        return time.perf_counter() - t0

    def _work_remaining(self) -> bool:
        with self._lock:
            if self._pending and self._routable_indices(decode=True):
                return True
        return any(r.is_serving and r.busy for r in self.replicas)

    # -- request resolution ---------------------------------------------- #

    def _locate(self, fuid: int):
        """Raises the stored :class:`ShedError` for shed requests and a
        structured :class:`FleetRequestError` naming the last known state
        for unknown / failover-lost ids."""
        with self._lock:
            if fuid in self._shed:
                raise self._shed[fuid]
            loc = self._map.get(fuid)
            if loc is None:
                if fuid in self._lost:
                    raise FleetRequestError(
                        fuid, "lost", self._lost[fuid],
                        trace_id=self._trace_ids.get(fuid),
                    )
                raise FleetRequestError(fuid, "unknown", trace_id=self._trace_ids.get(fuid))
        return loc

    def _live_replica(self, fuid: int, loc) -> Replica:
        """The serving replica a map entry points at — raises the
        structured error instead of touching a failed engine (a transient
        state: failover re-homes the entry, after which the accessors
        resolve on the survivor)."""
        rep = self.replicas[loc[1]]
        if not rep.is_serving:
            raise FleetRequestError(
                fuid, f"on {rep.health} replica {rep.name!r}",
                rep.last_error or "failing over",
                trace_id=self._trace_ids.get(fuid),
            )
        return rep

    def poll(self, fuid: int):
        """Finished [prompt + generated] tokens, or None while pending.
        Raises the structured ShedError for a shed request (fleet- or
        replica-level) and :class:`FleetRequestError` for unknown or
        failover-lost ids. A request salvaged off a failed/drained
        replica resolves here exactly like a live one."""
        loc = self._locate(fuid)
        if loc[0] == "pending":
            return None
        if loc[0] == "done":
            return loc[1]
        rep = self._live_replica(fuid, loc)
        with rep.lock:
            try:
                return rep.engine.poll(loc[2])
            except ShedError as e:
                with self._lock:
                    self._shed[fuid] = e
                raise

    def partial(self, fuid: int) -> np.ndarray:
        """Tokens generated so far (streaming surface; empty while the
        request is queued or awaiting its handoff). A failed-over
        request keeps exposing its already-streamed tokens from the
        survivor — a delta streamer sees no regression across the
        migration."""
        loc = self._locate(fuid)
        if loc[0] == "pending":
            return np.zeros((0,), np.int32)
        if loc[0] == "done":
            return loc[2]
        rep = self._live_replica(fuid, loc)
        with rep.lock:
            return rep.engine.partial(loc[2])

    def logprobs(self, fuid: int) -> np.ndarray:
        loc = self._locate(fuid)
        if loc[0] == "pending":
            return np.zeros((0,), np.float32)
        if loc[0] == "done":
            return loc[3]
        rep = self._live_replica(fuid, loc)
        with rep.lock:
            return rep.engine.logprobs(loc[2])

    def cancel(self, fuid: int) -> np.ndarray:
        """Abort a request anywhere in the fleet (still-pending handoffs
        cancel before any prefill runs). Cancelling a request stranded
        on a quarantined/dead replica — or already LOST to a failed
        migration — succeeds WITHOUT touching the failed engine: the
        fleet-side tracking is dropped and the empty token array
        returned (the death already cancelled it for real)."""
        with self._lock:
            if fuid in self._shed:
                raise self._shed[fuid]
            loc = self._map.get(fuid)
            if loc is None:
                if fuid in self._lost:
                    del self._lost[fuid]
                    return np.zeros((0,), np.int32)
                raise FleetRequestError(fuid, "unknown", trace_id=self._trace_ids.get(fuid))
            if loc[0] == "pending":
                self._pending = [e for e in self._pending if e["fuid"] != fuid]
                del self._map[fuid]
                if self.tracer is not None:
                    self.tracer.finish(self._trace_ids.get(fuid), status="cancelled")
                return np.zeros((0,), np.int32)
            if loc[0] == "done":
                raise ValueError(f"request {fuid} already finished; poll() it instead")
        rep = self.replicas[loc[1]]
        if not rep.is_serving:
            with self._lock:
                self._map.pop(fuid, None)
            return np.zeros((0,), np.int32)
        with rep.lock:
            return rep.engine.cancel(loc[2])

    # -- observability ---------------------------------------------------- #

    def metrics_merged(self):
        """One fleet-view :class:`ServingMetrics` (summed counters,
        pooled latency windows — see ``ServingMetrics.merge``)."""
        from .telemetry.serving_metrics import ServingMetrics

        return ServingMetrics.merge([r.engine.metrics for r in self.replicas])

    def prometheus_text(self) -> str:
        """Prometheus exposition of every replica's metrics as ONE scrape
        (one HELP/TYPE block per metric, a ``replica`` label per
        sample)."""
        from .telemetry.serving_metrics import fleet_prometheus_text

        return fleet_prometheus_text([r.engine.metrics for r in self.replicas])

    def handoff_accounting(self) -> dict:
        with self._lock:
            return {
                "handoffs": self.handoffs,
                "handoffs_local": self.handoffs_local,
                "bytes_predicted": self.handoff_bytes_predicted,
                "bytes_moved": self.handoff_bytes_moved,
                "time_us_predicted": round(self.handoff_time_us_predicted, 3),
            }

    def failover_accounting(self) -> dict:
        """Byte/step accounting for every failover the router performed.
        ``bytes_predicted`` (the costmodel's pre-priced KV payload) is
        pinned equal to ``bytes_moved`` (actual leaf bytes shipped) by the
        test suite — failovers are priced BEFORE they happen, and the
        price must be honest."""
        with self._lock:
            return {
                "failovers": self.failovers,
                "failovers_kv": self.failovers_kv,
                "failovers_recompute": self.failovers_recompute,
                "failovers_lost": self.failovers_lost,
                "bytes_predicted": self.failover_bytes_predicted,
                "bytes_moved": self.failover_bytes_moved,
                "time_us_predicted": round(self.failover_time_us_predicted, 3),
                "recompute_us_predicted": round(self.failover_recompute_us_predicted, 3),
            }

    def radix_stats(self) -> dict:
        return {
            r.name: r.radix.stats() for r in self.replicas if r.radix is not None
        }
