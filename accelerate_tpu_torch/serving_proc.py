"""The multi-process serving fleet: a process supervisor over engine-worker
processes.

Counterpart of :mod:`accelerate_tpu.serving_proc`. What the in-process
fleet (:mod:`accelerate_tpu_torch.serving_fleet`) proves -- the health
state machine, priced token/logprob-exact failover, ``HandoffCodec`` wire
blobs, chaos coverage, request tracing, flight recording -- crosses the OS
process boundary here:

* **worker** (``python -m accelerate_tpu_torch.serving_proc --worker
  spec.json``): one single-threaded
  :class:`~accelerate_tpu_torch.serving.ServingEngine` per process, on the
  card unless the spec asks for the CPU (each worker its own CUDA
  context; the workers share the card by time-slicing), serving a strict
  request/response protocol over one localhost TCP connection
  (:mod:`accelerate_tpu_torch.serving_transport`). Every status poll ships
  failover snapshots, so the supervisor always holds a recovery point for
  each in-flight request, and the worker's kernel launch counts (K4's
  ``launches`` beside its decode steps). Single-threaded on purpose: no
  locks. A worker asked for ``cuda`` that finds no card exits non-zero
  with the reason in its log; it never carries on on the CPU.

* **supervisor** (:class:`ProcessSupervisor`): spawns and monitors the
  workers (``subprocess.Popen`` of a fresh interpreter, never ``fork``: a
  CUDA context does not survive one), drives the health machine off REAL
  process death -- an exit observed by ``wait()`` -> ``dead`` with priced
  failover of the worker's in-flight snapshots to survivors; transport
  timeout -> ``degraded`` -> ``quarantined`` (the hung process is
  SIGKILLed); heal after clean polls -- and respawns dead slots with
  jittered exponential backoff
  (:func:`accelerate_tpu_torch.utils.retry.backoff_delays`) behind a
  restart-storm circuit breaker. Worker death writes a flight-recorder
  dump holding the kill. All transport IO is confined to :meth:`pump` (one
  thread); the public submit/cancel surface crosses threads through a
  command queue and published snapshots only, never a socket. On the card
  the supervisor builds the serving kernels once before the first spawn,
  so every worker, a respawn included, reports 0 ``nvcc`` builds; and
  every worker's :class:`~accelerate_tpu_torch.aot.ProgramCache` opens the
  one :class:`~accelerate_tpu_torch.aot.ExecutableStore` at ``store_dir``
  (default ``{run_dir}/store``), so a respawn or a late worker finds every
  program the first workers recorded: its hello reports 0 ``compiles``
  and its ``deserialized`` programs, as the JAX package's workers do.

* **front door**: :func:`serve` pairs the supervisor with
  :class:`~accelerate_tpu_torch.telemetry.httpd.TelemetryHTTPD`
  (``POST /v1/generate`` in JSON or SSE, cancellation, priority/SLO
  headers, ``/healthz`` flipping 503 on zero live worker processes).
  SIGTERM drains: in-flight requests complete (or migrate off a failing
  worker), workers shut down, exit 0.

Failover exactness across SIGKILL: a killed process cannot export, so the
supervisor recovers from the LAST POLLED snapshot: the request's sampling
state (``gen_state``, its generator's state) and deterministic decode
regenerate the lost tail on the survivor. With ``ProcConfig.shadow_kv``
(dense layout) the snapshot also carries the rows, making the recovery a
priced KV import whose bytes are pinned predicted == moved. A status reply
with every slot's rows must fit one frame (``MAX_FRAME_BYTES``): size the
dense engine's ``num_slots x max_len`` rows to it.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from .serving_transport import (
    MAX_FRAME_BYTES,
    PeerClosedError,
    TransportError,
    WorkerError,
    decode_snapshots,
    encode_snapshots,
    recv_msg,
    request,
    send_msg,
)
from .utils.retry import backoff_delays

#: supervisor-side worker health states. ``spawning`` is the pre-hello
#: window of a launched process; ``healthy``/``degraded`` serve traffic
#: (mirroring ``serving_fleet.HEALTH_STATES``); ``quarantined`` means the
#: process was SIGKILLed for hanging or poisoned numerics; ``dead`` is an
#: observed process exit.
WORKER_STATES = ("spawning", "healthy", "degraded", "quarantined", "dead")

#: states that accept routed work
SERVING_WORKER_STATES = ("healthy", "degraded")

#: env var carrying a process-level ReplicaChaos spec into ONE worker
PROC_CHAOS_ENV = "ACCELERATE_TPU_PROC_CHAOS"

#: kernel libraries a serving worker launches (``kernels/build.py`` names):
#: K4 for the paged decode, K5 for int4 projections
SERVING_KERNELS = ("paged_attention", "int4_matmul")


@dataclasses.dataclass
class ProcConfig:
    """Supervisor + worker-fleet knobs. Everything is JSON-able: the
    worker slice of this config is written to a per-worker spec file the
    subprocess reads at boot."""

    workers: int = 2
    #: ``"module:callable"`` model factory; called in the worker process
    #: with ``model_kwargs`` and ``device=``. MUST be deterministic (seeded
    #: init): the cross-process exactness story requires every worker to
    #: hold bit-identical weights.
    model_spec: str = "accelerate_tpu_torch.serving_proc:default_model"
    model_kwargs: Optional[dict] = None
    #: ServingEngine kwargs (num_slots, prompt_buckets, tick_block, ...)
    engine: Optional[dict] = None
    #: the workers' device: ``cuda`` unless ``cpu`` is asked for
    device: str = "cuda"
    #: run artifacts: per-worker eventlog JSONLs, worker logs, flight
    #: dumps, worker spec files
    run_dir: str = os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_proc")
    #: the executable store every worker's ProgramCache shares (default
    #: ``{run_dir}/store``): the zero-compile warm start of respawns and
    #: late workers
    store_dir: Optional[str] = None
    #: prompt lengths each worker prefills at boot (plus one detached
    #: handoff paste on the dense layout), so the first served tick finds
    #: every lazy initialisation done
    warm_prompt_lens: tuple = (4,)
    warm_max_new_tokens: int = 2
    #: status-poll cadence and the per-RPC transport timeout that drives
    #: degraded/quarantined escalation
    poll_interval_s: float = 0.02
    heartbeat_timeout_s: float = 5.0
    quarantine_after_timeouts: int = 2
    heal_after_polls: int = 8
    spawn_timeout_s: float = 180.0
    #: respawn policy: jittered exponential backoff per slot, a per-slot
    #: attempt cap, and a fleet-wide restart-storm circuit breaker
    max_respawns: int = 3
    respawn_backoff_base_s: float = 0.05
    respawn_backoff_max_s: float = 2.0
    respawn_backoff_jitter: float = 0.5
    storm_threshold: int = 5
    storm_window_s: float = 30.0
    #: include trimmed KV rows in every status-poll snapshot: SIGKILL
    #: failover becomes a priced KV import (bytes predicted == moved)
    #: instead of exact recompute, at the cost of snapshot bandwidth
    shadow_kv: bool = False
    #: flight-recorder ring capacity per worker
    flight_capacity: int = 256
    #: chaos injection: ``{"worker", "label", "action", "hits"}``,
    #: installed (via env) into the NAMED worker incarnation only, so a
    #: respawn serves clean
    chaos: Optional[dict] = None
    #: extra env for worker processes (applied last)
    worker_env: Optional[dict] = None
    #: model/engine seed (worker weights + sampling streams)
    seed: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["warm_prompt_lens"] = list(self.warm_prompt_lens)
        return d


def default_model(seed: int = 0, device=None, dtype: str = "float32", **config_overrides):
    """Default worker model factory: a seeded tiny Llama (identical
    weights in every process by construction). Overrides apply on top of
    :meth:`~accelerate_tpu_torch.models.llama.LlamaConfig.tiny`, never the
    full-size defaults (a worker must boot in seconds). ``dtype`` is a
    torch dtype's name (the spec is JSON)."""
    import torch

    from .models.llama import LlamaConfig, create_llama_model

    return create_llama_model(LlamaConfig.tiny(**config_overrides), seed=seed, device=device,
                              dtype=getattr(torch, dtype))


def _load_factory(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"model_spec must be 'module:callable', got {spec!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), fn_name)


def subset_snapshots(blob: bytes, uids) -> bytes:
    """The snapshots of ``uids`` out of an :func:`encode_snapshots` bundle,
    re-packed as a bundle of their own without decoding a row: a failover
    import ships each victim's rows only."""
    keep = {int(u) for u in uids}
    arrays = {}
    n = 0
    with np.load(io.BytesIO(blob)) as z:
        for i in range(int(z["count"][0])):
            p = f"s{i}_"
            if int(z[p + "imeta"][0]) not in keep:
                continue
            for key in z.files:
                if key.startswith(p):
                    arrays[f"s{n}_" + key[len(p):]] = z[key]
            n += 1
    arrays["count"] = np.asarray([n], np.int64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# ===================================================================== #
# worker half (runs in the subprocess; single-threaded, lock-free)
# ===================================================================== #


def _launch_counts() -> dict:
    """This process's launch counts of the serving kernels' wrappers."""
    from .ops import paged_attention, qmatmul

    return {"paged_decode_attention": int(paged_attention.launches), "int4_matmul": int(qmatmul.launches)}


class EngineWorker:
    """One engine process: builds the model/engine from a spec dict, warms
    it, connects back to the supervisor, and serves the transport protocol
    until ``shutdown`` (or death)."""

    def __init__(self, spec: dict):
        from .kernels import build
        from .serving import ServingEngine
        from .telemetry.eventlog import EventLog

        self.spec = spec
        self.name = spec["name"]
        self.slot = int(spec["slot"])
        self.token = spec["token"]
        self.device = spec.get("device", "cuda")
        self._draining = False
        self._fault: Optional[dict] = None
        #: done results not yet acknowledged by a supervisor status poll
        self._unacked: dict = {}
        self._reported: set = set()
        self._steps_base = 0
        #: host time spent in ticks and in status replies (the poll cost),
        #: and the largest status reply's snapshot bundle
        self._timing = {"ticks": 0, "tick_ms": 0.0, "polls": 0, "status_ms": 0.0, "blob_bytes_max": 0}
        self._profile_pending = False
        self._tick_profile: Optional[dict] = None

        log_path = os.path.join(spec["run_dir"], f"events_{self.name}.jsonl")
        # rank = slot index: merge_events disambiguates the per-process
        # seq counters of concurrent workers by this id
        self.log = EventLog(log_path, rank=self.slot, main_process_only=False)

        builds0, prebuilt0 = build.nvcc_builds, build.prebuilt_loads
        t0 = time.perf_counter()
        if str(self.device).startswith("cuda"):
            import torch

            torch.empty(1, device=self.device)  # the process's CUDA context
            torch.cuda.synchronize(self.device)
        self.device_init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        factory = _load_factory(spec["model_spec"])
        model = factory(**(spec.get("model_kwargs") or {}), device=self.device)
        self.model_s = time.perf_counter() - t0
        from .aot import ExecutableStore, ProgramCache

        pc = ProgramCache(store=ExecutableStore(spec["store_dir"]), name=self.name)
        self.engine = ServingEngine(
            model, program_cache=pc, telemetry_log=self.log, seed=int(spec.get("seed", 0)), device=self.device,
            **(spec.get("engine") or {}),
        )
        self.engine.metrics.replica = self.name
        t0 = time.perf_counter()
        self._warm(spec)
        self.warm_s = time.perf_counter() - t0
        self.warm_builds = build.nvcc_builds - builds0
        self.warm_prebuilt = build.prebuilt_loads - prebuilt0
        self.warm_compiles = int(pc.misses)
        self.warm_deserialized = int(pc.deserialized)
        self.log.emit(
            "event", "proc_worker_warm", worker=self.name, severity="info",
            compiles=self.warm_compiles, deserialized=self.warm_deserialized,
            nvcc_builds=self.warm_builds, prebuilt_loads=self.warm_prebuilt,
            model_s=round(self.model_s, 4), warm_s=round(self.warm_s, 4),
        )

    def _warm(self, spec: dict) -> None:
        """Prefill each warm length, run decode ticks, and (dense layout)
        one detached handoff paste, the path failover imports take: the
        first served tick then finds every kernel library loaded and every
        lazy initialisation done."""
        vocab = int(self.engine.model.config.vocab_size)
        lens = [int(v) for v in spec.get("warm_prompt_lens") or (4,)]
        n_new = int(spec.get("warm_max_new_tokens", 2))
        for ln in lens:
            prompt = (np.arange(1, ln + 1) % max(2, vocab - 2) + 1).astype(np.int32)
            self.engine.submit(prompt, max_new_tokens=n_new)
        self.engine.run()
        if not self.engine.paged and self.engine.draft_model is None:
            ln = min(lens) if lens else 4
            prompt = (np.arange(2, ln + 2) % max(2, vocab - 2) + 1).astype(np.int32)
            h = self.engine.prefill_detached(prompt, max_new_tokens=n_new, uid_key=2**30 + self.slot)
            self.engine.submit_prefilled(dict(h))
            self.engine.run()
        self._sync()
        # warm results never leave the process
        self.engine.done.clear()

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.engine.device)

    # ------------------------------------------------------------------ #
    # protocol
    # ------------------------------------------------------------------ #

    def hello(self) -> dict:
        per_tok = fixed = 0
        if not self.engine.paged and self.engine.draft_model is None:
            per_tok, fixed = self.engine.kv_handoff_dims()
        return {
            "op": "hello",
            "worker": self.name,
            "slot": self.slot,
            "token": self.token,
            "pid": os.getpid(),
            "device": str(self.engine.device),
            "compiles": self.warm_compiles,
            "deserialized": self.warm_deserialized,
            "nvcc_builds": self.warm_builds,
            "prebuilt_loads": self.warm_prebuilt,
            "device_init_s": self.device_init_s,
            "model_s": self.model_s,
            "warm_s": self.warm_s,
            "kv_bytes_per_token": int(per_tok),
            "kv_fixed_bytes": int(fixed),
            "max_len": int(self.engine.max_len),
            "vocab_size": int(self.engine.model.config.vocab_size),
            "num_hidden_layers": int(self.engine.model.config.num_hidden_layers),
        }

    def _busy(self) -> bool:
        return self.engine.active_count > 0 or len(self.engine.queue) > 0

    def _step(self) -> None:
        """One engine tick; engine faults become a structured report in
        the next status reply instead of a silent death. A process-level
        chaos action (SIGKILL/SIGSTOP) fires inside the tick's labeled
        crash points and never returns."""
        from .serving_fleet import NonFinitePoison

        t0 = time.perf_counter()
        try:
            self.engine.step()
        except NonFinitePoison as e:
            self._fault = {"kind": "poison", "detail": str(e)}
            self.log.emit("event", "proc_worker_fault", worker=self.name, severity="error", fault="poison",
                          detail=str(e))
        except Exception as e:  # noqa: BLE001 - reported, then surfaced by status
            self._fault = {"kind": "error", "detail": f"{type(e).__name__}: {e}"}
            self.log.emit("event", "proc_worker_fault", worker=self.name, severity="error", fault="error",
                          detail=str(e))
        self._timing["ticks"] += 1
        self._timing["tick_ms"] += (time.perf_counter() - t0) * 1e3

    def _profiled_ticks(self) -> None:
        """The tick's device idle share (``profile_tick``): one tick timed
        without the profiler (host clock, the card synchronized before and
        after), the next traced with ``torch.profiler`` for the device's
        busy time (the union of the traced kernels' intervals). The
        profiler loses the first few device events of a window, so lead
        marker kernels (``torch.cuda._sleep``, a microsecond each) open it
        and one closes it; a window whose markers do not bracket the tick
        is traced again behind a longer lead."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        t0 = time.perf_counter()
        self._step()
        self._sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        result = {"tick_wall_ms": wall_ms, "device_busy_ms": None, "idle_share": None, "attempts": 0}
        for attempt, lead in enumerate((256, 2048, 8192), 1):
            if not self._busy():
                break
            result["attempts"] = attempt
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(lead):
                    torch.cuda._sleep(1000)
                self._sync()
                self._step()
                self._sync()
                torch.cuda._sleep(1000)
                self._sync()
            events = [ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]
            kept = [ev for ev in events if "spin_kernel" not in ev.name]
            spins = [ev.time_range.start for ev in events if "spin_kernel" in ev.name]
            if not kept:
                continue
            first, last = min(ev.time_range.start for ev in kept), max(ev.time_range.start for ev in kept)
            if any(t < first for t in spins) and sum(t > last for t in spins) == 1:
                busy, end = 0.0, float("-inf")
                for a, b in sorted((ev.time_range.start, ev.time_range.end) for ev in kept):
                    busy += max(0.0, b - max(a, end))
                    end = max(end, b)
                result.update(device_busy_ms=busy / 1e3, idle_share=1.0 - busy / 1e3 / wall_ms)
                break
        self._tick_profile = result

    def _status(self, obj: dict) -> tuple:
        t0 = time.perf_counter()
        for uid in obj.get("ack") or []:
            self._unacked.pop(int(uid), None)
        for uid, toks in self.engine.done.items():
            if uid in self._reported:
                continue
            self._reported.add(uid)
            self._unacked[int(uid)] = {
                "tokens": [int(t) for t in np.asarray(toks).ravel()],
                "lps": [float(v) for v in np.asarray(self.engine.logprobs(uid)).ravel()],
            }
        include_kv = bool(obj.get("shadow_kv")) and not self.engine.paged and self.engine.draft_model is None
        snaps = self.engine.export_inflight(include_kv=include_kv)
        meta, blob = encode_snapshots(snaps)
        if include_kv and len(blob) > MAX_FRAME_BYTES - (1 << 20):
            # every snapshot's rows would not fit one frame: this poll ships
            # none (a failover from it recomputes) rather than fail the reply
            self.log.emit("event", "proc_worker_kv_dropped", worker=self.name, severity="warning",
                          bytes=len(blob), cap=MAX_FRAME_BYTES)
            snaps = self.engine.export_inflight(include_kv=False)
            meta, blob = encode_snapshots(snaps)
        progress = {
            str(s["uid"]): {
                "tokens": [int(t) for t in s.get("out_tokens") or []],
                "lps": [float(v) for v in s.get("out_lps") or []],
            }
            for s in snaps
        }
        fault, self._fault = self._fault, None
        from .kernels import build

        self._timing["polls"] += 1
        self._timing["blob_bytes_max"] = max(self._timing["blob_bytes_max"], len(blob))
        reply = {
            "op": "status",
            "busy": self._busy(),
            "queue": len(self.engine.queue),
            "active": int(self.engine.active_count),
            "done": {str(u): r for u, r in self._unacked.items()},
            "progress": progress,
            "snaps": meta,
            "compiles": int(self.engine.program_cache.misses),
            "deserialized": int(self.engine.program_cache.deserialized),
            "nvcc_builds": int(build.nvcc_builds),
            "prebuilt_loads": int(build.prebuilt_loads),
            "launches": _launch_counts(),
            "decode_steps": int(self.engine.decode_steps - self._steps_base),
            "tick_profile": self._tick_profile,
            "timing": dict(self._timing),
            "fault": fault,
            "metrics": self._metrics_snapshot(),
        }
        # this reply's own cost lands in the next one
        self._timing["status_ms"] += (time.perf_counter() - t0) * 1e3
        return reply, blob

    def _metrics_snapshot(self) -> dict:
        snap = self.engine.metrics.snapshot()
        return {
            k: (float(v) if isinstance(v, float) else int(v))
            for k, v in snap.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }

    def _handle(self, obj: dict, blob: bytes) -> tuple:
        op = obj.get("op")
        if op == "status":
            return self._status(obj)
        if op == "submit":
            if self._draining:
                return {"err": {"kind": "draining", "detail": "worker is draining"}}, b""
            from .scheduling import ShedError

            try:
                uid = self.engine.submit(
                    np.asarray(obj["prompt"], np.int32),
                    max_new_tokens=int(obj["max_new_tokens"]),
                    stop_sequences=[tuple(s) for s in obj.get("stop_sequences") or []] or None,
                    priority=int(obj.get("priority", 0)),
                    trace=obj.get("trace"),
                )
            except ShedError as e:
                return {"err": {"kind": "shed", "detail": str(e)}}, b""
            # the stream's sampling state as the engine seeds it: a
            # snapshotless failover resumes it exactly
            gen_state = self.engine._gen_state(self.engine._request_generator(uid))
            return {"uid": int(uid), "gen_state": [int(v) for v in gen_state]}, b""
        if op == "submit_prefilled":
            from .serving_fleet import HandoffCodec

            handoff = HandoffCodec.decode(blob, self.engine)
            uid = self.engine.submit_prefilled(handoff, priority=int(obj.get("priority", 0)))
            return {"uid": int(uid)}, b""
        if op == "import_snaps":
            keep = {int(u) for u in obj.get("uids") or []}
            allow_kv = bool(obj.get("allow_kv", True))
            uids, kv_bytes = {}, {}
            for snap in decode_snapshots(blob, self.engine):
                if keep and int(snap["uid"]) not in keep:
                    continue
                if not allow_kv:
                    snap.pop("cache", None)
                    snap.pop("rows", None)
                moved = 0
                if snap.get("cache") is not None:
                    moved = sum(t.numel() * t.element_size() for t in snap["cache"].values())
                uids[str(snap["uid"])] = int(self.engine.import_inflight(snap))
                kv_bytes[str(snap["uid"])] = int(moved)
            return {"uids": uids, "kv_bytes": kv_bytes}, b""
        if op == "export":
            include_kv = bool(obj.get("include_kv", True)) and not self.engine.paged \
                and self.engine.draft_model is None
            snaps = self.engine.export_inflight(include_kv=include_kv)
            meta, blob_out = encode_snapshots(snaps)
            return {"snaps": meta}, blob_out
        if op == "cancel":
            uid = int(obj["uid"])
            try:
                toks = self.engine.cancel(uid)
            except (KeyError, ValueError):
                return {"err": {"kind": "unknown_uid", "detail": f"no request {uid} in flight"}}, b""
            self._reported.add(uid)
            self.engine.done.pop(uid, None)
            return {"tokens": [int(t) for t in np.asarray(toks).ravel()]}, b""
        if op == "reset_counts":
            # the launch counters and the decode steps start again at 0
            from .ops import paged_attention, qmatmul

            paged_attention.launches = 0
            qmatmul.launches = 0
            self._steps_base = self.engine.decode_steps
            self._timing = {"ticks": 0, "tick_ms": 0.0, "polls": 0, "status_ms": 0.0, "blob_bytes_max": 0}
            return {"ok": True}, b""
        if op == "profile_tick":
            if self.engine.device.type != "cuda":
                return {"err": {"kind": "unsupported", "detail": "profile_tick traces the card's kernels"}}, b""
            self._profile_pending = True
            self._tick_profile = None
            return {"ok": True}, b""
        if op == "drain":
            self._draining = True
            return {"ok": True}, b""
        if op == "shutdown":
            return {"op": "bye", "ok": True}, b""
        return {"err": {"kind": "bad_op", "detail": f"unknown op {op!r}"}}, b""

    def run(self, conn: socket.socket) -> int:
        """The event loop: wait for a frame, tick the engine between
        frames. Single-threaded; ``select`` is the scheduler: a read only
        starts once bytes are waiting, so an idle wait can never desync
        mid-frame."""
        import select

        from .ft.crashpoints import crash_point

        send_msg(conn, self.hello())
        self.log.emit("event", "proc_worker_hello", worker=self.name, severity="info", pid=os.getpid())
        while True:
            wait_s = 0.001 if self._busy() else 0.05
            readable, _, _ = select.select([conn], [], [], wait_s)
            if not readable:
                if self._busy():
                    crash_point("pre_tick", replica=self.name)
                    if self._profile_pending:
                        self._profile_pending = False
                        self._profiled_ticks()
                    else:
                        self._step()
                continue
            conn.settimeout(None)
            try:
                obj, blob = recv_msg(conn)
            except (PeerClosedError, ConnectionError, OSError):
                # supervisor went away: nothing left to serve
                self.log.emit("event", "proc_worker_orphaned", worker=self.name, severity="warning")
                return 0
            try:
                reply, rblob = self._handle(obj, blob)
            except Exception as e:  # noqa: BLE001 - protocol errors stay structured
                reply, rblob = {"err": {"kind": "error", "detail": f"{type(e).__name__}: {e}"}}, b""
            conn.settimeout(None)
            send_msg(conn, reply, rblob)
            if reply.get("op") == "bye":
                self.log.emit("event", "proc_worker_shutdown", worker=self.name, severity="info")
                self.log.close()
                return 0


def worker_main(spec_path: str) -> int:
    """Subprocess entry: read the spec, check the device, build + warm the
    engine, install chaos (if this worker is the named target), connect,
    serve. Chaos is installed only AFTER the warm pass: the warm prompts
    run real decode ticks through the same labeled crash points, and an
    injected fault's ``hits`` countdown must index served traffic."""
    with open(spec_path) as f:
        spec = json.load(f)
    from .test_utils.fault_injection import ReplicaChaos
    from .utils.environment import resolve_device

    try:
        resolve_device(spec.get("device", "cuda"))
    except RuntimeError as e:
        print(f"worker {spec['name']}: {e}", file=sys.stderr, flush=True)
        return 3
    worker = EngineWorker(spec)
    ReplicaChaos.install_from_env(spec["name"])
    conn = socket.create_connection(("127.0.0.1", int(spec["port"])), timeout=30.0)
    conn.settimeout(None)
    try:
        return worker.run(conn)
    finally:
        conn.close()


# ===================================================================== #
# supervisor half (parent process; IO confined to pump())
# ===================================================================== #


class ProcessSupervisor:
    """Spawns, monitors, heals, and respawns engine-worker subprocesses.

    Thread contract: all sockets and all mutable fleet state belong to the
    thread that calls :meth:`pump` (and the other pump-thread methods:
    :meth:`start`, :meth:`drain_worker`, :meth:`reset_counts`,
    :meth:`request_tick_profile`, :meth:`shutdown`). Other threads (the
    HTTP front door) interact only through the command queue
    (``submit``/``cancel``) and the published snapshot
    (``poll``/``partial``/``health``/``prometheus_text``/``worker_stats``),
    which one short-critical-section lock guards: no blocking call ever
    runs under it.
    """

    def __init__(self, config: Optional[ProcConfig] = None):
        self.config = config or ProcConfig()
        cfg = self.config
        if cfg.device not in ("cuda", "cpu"):
            raise ValueError(f"unsupported worker device {cfg.device!r}; use 'cuda' or 'cpu'")
        from .utils.environment import resolve_device

        resolve_device(cfg.device)  # no card: refuse here, before any worker is spawned
        self.run_dir = cfg.run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        self.store_dir = cfg.store_dir or os.path.join(self.run_dir, "store")
        os.makedirs(self.store_dir, exist_ok=True)

        from .telemetry.eventlog import EventLog
        from .telemetry.trace import Tracer

        self._log = EventLog(os.path.join(self.run_dir, "events_supervisor.jsonl"), rank=0, main_process_only=False)
        self._tracer = Tracer(log=self._log)
        self._log.add_tap(self._tap_worker_events)
        self._recorders: dict = {}

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(max(8, cfg.workers * 2))
        self._listener.settimeout(0.0)
        self.port = self._listener.getsockname()[1]

        self._slots: list = []
        #: every worker incarnation by name, kept after it dies: its pid,
        #: health, spin-up seconds, hello and last polled status
        self._incarnations: dict = {}
        self._reqs: dict = {}
        self._next_fuid = 0
        self._pending_fuids: set = set()
        self._cmds: "queue.Queue" = queue.Queue()
        self._pub_lock = threading.Lock()
        self._pub = {"streams": {}, "health": {}, "prom": "", "summary": {}, "stats": {}}
        self._acct = {
            "failovers": 0, "failovers_kv": 0, "failovers_recompute": 0,
            "failovers_lost": 0, "bytes_predicted": 0, "bytes_moved": 0,
        }
        self._respawn_times: deque = deque()
        self._breaker_open = False
        self._drain_flag = threading.Event()
        self._respawns_total = 0
        self._token = f"sup-{os.getpid()}-{id(self):x}"

    # ------------------------------------------------------------------ #
    # flight recording: supervisor-side per-worker ring of every event
    # that names the worker, dumped on its death/quarantine
    # ------------------------------------------------------------------ #

    def _tap_worker_events(self, rec: dict) -> None:
        fr = self._recorders.get(rec.get("worker"))
        if fr is not None:
            fr.record(rec)

    # ------------------------------------------------------------------ #
    # spawn / lifecycle (pump-thread only)
    # ------------------------------------------------------------------ #

    def _build_kernels(self) -> None:
        """On the card: build the serving kernel libraries once, here, so
        every worker (a respawn included) loads them built: 0 ``nvcc``
        builds in a worker."""
        if self.config.device != "cuda":
            return
        from .kernels import build

        before = build.nvcc_builds
        build.build_all(SERVING_KERNELS)
        self._log.emit("event", "proc_kernels_built", severity="info", builds=build.nvcc_builds - before,
                       libraries=list(SERVING_KERNELS))

    def start(self, wait: bool = True) -> None:
        """Spawn every slot; with ``wait``, pump until all workers said
        hello (or the spawn deadline passes, which marks them dead and
        schedules respawns)."""
        self._build_kernels()
        for i in range(self.config.workers):
            self._slots.append(self._new_slot(i))
            self._spawn_slot(self._slots[i])
        if wait:
            deadline = time.monotonic() + self.config.spawn_timeout_s
            while time.monotonic() < deadline:
                self.pump()
                if all(s["health"] != "spawning" for s in self._slots):
                    break
                time.sleep(0.02)
        self._publish()

    def _new_slot(self, i: int) -> dict:
        return {
            "slot": i, "name": f"w{i}", "proc": None, "conn": None,
            "health": "spawning", "reason": "initial spawn",
            "timeouts": 0, "clean": 0, "respawns": 0,
            "hello": None, "shadow": None, "uids": {},
            "next_spawn_at": None, "spawn_deadline": None, "spawned_at": None,
            "next_poll_at": 0.0, "gave_up": False, "acked": [],
        }

    def _spawn_slot(self, slot: dict) -> None:
        cfg = self.config
        name = slot["name"]
        spec = {
            "name": name,
            "slot": slot["slot"],
            "port": self.port,
            "token": self._token,
            "run_dir": self.run_dir,
            "store_dir": self.store_dir,
            "device": cfg.device,
            "model_spec": cfg.model_spec,
            "model_kwargs": cfg.model_kwargs or {},
            "engine": cfg.engine or {},
            "warm_prompt_lens": list(cfg.warm_prompt_lens),
            "warm_max_new_tokens": cfg.warm_max_new_tokens,
            "seed": cfg.seed,
        }
        spec_path = os.path.join(self.run_dir, f"worker_{name}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env.pop(PROC_CHAOS_ENV, None)
        if cfg.chaos and cfg.chaos.get("worker") == name:
            env[PROC_CHAOS_ENV] = json.dumps(cfg.chaos)
        if cfg.worker_env:
            env.update(cfg.worker_env)
        log_path = os.path.join(self.run_dir, f"worker_{name}.log")
        with open(log_path, "ab") as out:
            slot["proc"] = subprocess.Popen(
                [sys.executable, "-m", "accelerate_tpu_torch.serving_proc", "--worker", spec_path],
                stdout=out, stderr=subprocess.STDOUT, env=env,
            )
        slot["health"] = "spawning"
        slot["reason"] = "spawned"
        slot["conn"] = None
        slot["hello"] = None
        slot["status"] = None
        slot["spawned_at"] = time.monotonic()
        slot["spawn_deadline"] = slot["spawned_at"] + cfg.spawn_timeout_s
        self._incarnations[name] = {"slot": slot["slot"], "health": "spawning", "pid": slot["proc"].pid,
                                    "spinup_s": None, "hello": None}
        from .telemetry.flightrec import FlightRecorder

        self._recorders[name] = FlightRecorder(cfg.flight_capacity, name=name)
        self._log.emit(
            "event", "proc_spawn", worker=name, severity="info",
            slot=slot["slot"], pid=slot["proc"].pid, incarnation=slot["respawns"],
        )

    def _accept_hellos(self) -> None:
        """Non-blocking accept of worker callbacks; a completed hello
        promotes its slot to healthy."""
        while True:
            try:
                conn, _addr = self._listener.accept()
            except (BlockingIOError, socket.timeout):
                return
            try:
                conn.settimeout(self.config.heartbeat_timeout_s)
                hello, _ = recv_msg(conn)
            except (TransportError, OSError):
                conn.close()
                continue
            if hello.get("op") != "hello" or hello.get("token") != self._token:
                conn.close()
                continue
            matched = None
            for slot in self._slots:
                if slot["name"] == hello.get("worker") and slot["health"] == "spawning":
                    matched = slot
                    break
            if matched is None:
                conn.close()
                continue
            matched["conn"] = conn
            matched["hello"] = hello
            spinup_s = time.monotonic() - matched["spawned_at"]
            self._incarnations[matched["name"]].update(spinup_s=spinup_s, hello=hello)
            matched["timeouts"] = 0
            matched["clean"] = 0
            self._set_health(matched, "healthy", "hello")
            self._log.emit(
                "event", "proc_hello", worker=matched["name"], severity="info",
                pid=hello.get("pid"), compiles=hello.get("compiles"),
                deserialized=hello.get("deserialized"), nvcc_builds=hello.get("nvcc_builds"),
                spinup_s=round(spinup_s, 4),
            )

    # ------------------------------------------------------------------ #
    # health machine
    # ------------------------------------------------------------------ #

    def _set_health(self, slot: dict, state: str, reason: str) -> None:
        if state not in WORKER_STATES:
            raise ValueError(f"unknown worker state {state!r}")
        prev = slot["health"]
        slot["health"] = state
        slot["reason"] = reason
        if slot["name"] in self._incarnations:
            self._incarnations[slot["name"]]["health"] = state
        if state in ("healthy", "spawning"):
            slot["timeouts"] = 0
            slot["clean"] = 0
        self._log.emit(
            "event", "proc_health", worker=slot["name"],
            severity="warning" if state in ("quarantined", "dead") else "info",
            prev=prev, state=state, reason=reason,
        )
        if state in ("quarantined", "dead") and prev not in ("quarantined", "dead"):
            self._flight_dump(slot, reason)

    def _on_worker_exit(self, slot: dict, returncode: int) -> None:
        """REAL process death: SIGKILL shows up as a negative returncode
        (the signal number); either way the worker is gone: migrate its
        snapshots and schedule a respawn."""
        sig = -returncode if returncode is not None and returncode < 0 else 0
        self._log.emit(
            "event", "proc_exit", worker=slot["name"], severity="error",
            returncode=returncode, signal=sig, killed=bool(sig == signal.SIGKILL),
        )
        self._close_conn(slot)
        self._set_health(slot, "dead", f"process exit rc={returncode}")
        self._migrate_worker(slot, kind="crash", allow_kv=True)
        self._schedule_respawn(slot)

    def _on_worker_timeout(self, slot: dict) -> None:
        """Transport/heartbeat timeout: degrade, then quarantine (and
        SIGKILL: a hung process holds no consistency we can trust to a
        graceful stop) once the threshold trips."""
        slot["timeouts"] += 1
        slot["clean"] = 0
        self._log.emit("event", "proc_timeout", worker=slot["name"], severity="warning", timeouts=slot["timeouts"])
        if slot["timeouts"] >= self.config.quarantine_after_timeouts:
            self._kill_slot(slot)
            self._set_health(slot, "quarantined", "heartbeat timeouts")
            self._migrate_worker(slot, kind="timeout", allow_kv=True)
            self._schedule_respawn(slot)
        else:
            self._set_health(slot, "degraded", "heartbeat timeout")

    def _on_worker_poison(self, slot: dict, detail: str) -> None:
        """Non-finite poison reported by the worker: numerics are suspect,
        so quarantine, kill, and fail over WITHOUT trusting its KV
        snapshots (recompute only)."""
        self._kill_slot(slot)
        self._set_health(slot, "quarantined", f"poison: {detail}")
        self._migrate_worker(slot, kind="poison", allow_kv=False)
        self._schedule_respawn(slot)

    def _on_worker_clean(self, slot: dict) -> None:
        """A clean status poll; enough of them heal a degraded worker."""
        slot["timeouts"] = 0
        if slot["health"] == "degraded":
            slot["clean"] += 1
            if slot["clean"] >= self.config.heal_after_polls:
                self._set_health(slot, "healthy", "healed")

    def _schedule_respawn(self, slot: dict) -> None:
        """Jittered-backoff respawn with a per-slot attempt cap and the
        fleet-wide restart-storm circuit breaker."""
        cfg = self.config
        if slot["respawns"] >= cfg.max_respawns:
            slot["gave_up"] = True
            self._log.emit("event", "proc_respawn_giveup", worker=slot["name"], severity="error",
                           respawns=slot["respawns"])
            return
        now = time.monotonic()
        while self._respawn_times and now - self._respawn_times[0] > cfg.storm_window_s:
            self._respawn_times.popleft()
        if len(self._respawn_times) >= cfg.storm_threshold:
            self._breaker_open = True
            slot["gave_up"] = True
            self._log.emit(
                "event", "proc_respawn_storm", worker=slot["name"], severity="error",
                respawns_in_window=len(self._respawn_times), window_s=cfg.storm_window_s,
            )
            return
        self._respawn_times.append(now)
        delays = list(
            backoff_delays(
                attempts=slot["respawns"] + 2,
                base_delay=cfg.respawn_backoff_base_s,
                max_delay=cfg.respawn_backoff_max_s,
                jitter=cfg.respawn_backoff_jitter,
            )
        )
        delay = delays[-1] if delays else cfg.respawn_backoff_base_s
        slot["respawns"] += 1
        self._respawns_total += 1
        slot["name"] = f"w{slot['slot']}.{slot['respawns']}"
        slot["uids"] = {}
        slot["shadow"] = None
        slot["acked"] = []
        slot["next_spawn_at"] = now + delay
        self._log.emit(
            "event", "proc_respawn_scheduled", worker=slot["name"], severity="info",
            slot=slot["slot"], delay_s=round(delay, 4), attempt=slot["respawns"],
        )

    # ------------------------------------------------------------------ #
    # failover (priced; snapshots are the recovery points)
    # ------------------------------------------------------------------ #

    def _migrate_worker(self, slot: dict, kind: str, allow_kv: bool) -> None:
        """Fail the dead/quarantined worker's in-flight requests over to
        survivors from its last polled snapshots, priced BEFORE the import
        and bytes pinned predicted == moved after. Each survivor takes its
        share in one import (the snapshots it gets, re-packed) and one more
        for requests with no snapshot (submitted after the last poll),
        rebuilt from the supervisor's own record. No routable survivor
        means lost-with-reason, never silence."""
        victims = {fuid: r for fuid, r in self._reqs.items() if r["state"] == "routed" and r["slot"] is slot}
        if not victims:
            return
        meta_by_uid = {}
        blob = b""
        if slot["shadow"] is not None:
            meta_list, blob = slot["shadow"]
            meta_by_uid = {int(m["uid"]): m for m in meta_list}
        hello = slot["hello"] or {}
        per_tok = int(hello.get("kv_bytes_per_token", 0))
        fixed = int(hello.get("kv_fixed_bytes", 0))
        shares: dict = {}
        for fuid, r in victims.items():
            survivor = self._route(exclude=slot, pending={k: len(v[1]) for k, v in shares.items()})
            if survivor is None:
                self._lose(r, fuid, slot, kind, f"no routable survivor after {kind}")
                continue
            shares.setdefault(survivor["slot"], (survivor, []))[1].append(fuid)
        for survivor, fuids in shares.values():
            with_snap = [f for f in fuids if victims[f]["uid"] in meta_by_uid]
            without = [f for f in fuids if victims[f]["uid"] not in meta_by_uid]
            for group, bundle in ((with_snap, lambda g: subset_snapshots(blob, [victims[f]["uid"] for f in g])),
                                  (without, lambda g: encode_snapshots([self._record_snapshot(victims[f])
                                                                        for f in g])[1])):
                if not group:
                    continue
                try:
                    reply, _ = request(
                        survivor["conn"],
                        {"op": "import_snaps", "uids": [victims[f]["uid"] for f in group],
                         "allow_kv": bool(allow_kv) and group is with_snap},
                        bundle(group),
                        timeout=self.config.heartbeat_timeout_s,
                    )
                except (TransportError, OSError) as e:
                    # the survivor failed mid-failover: its own health event
                    # fires on the next pump
                    for f in group:
                        self._log.emit("event", "proc_failover_retry", worker=slot["name"], severity="warning",
                                       fuid=f, survivor=survivor["name"], detail=str(e))
                        self._lose(victims[f], f, slot, kind, f"failover import failed: {e}")
                    continue
                for f in group:
                    self._moved(victims[f], f, slot, survivor, kind, reply, meta_by_uid.get(victims[f]["uid"]),
                                allow_kv, per_tok, fixed)
        slot["uids"] = {}

    def _lose(self, r: dict, fuid: int, slot: dict, kind: str, reason: str) -> None:
        r["state"] = "lost"
        r["lost_reason"] = reason
        self._acct["failovers_lost"] += 1
        self._log.emit("event", "proc_failover_lost", worker=slot["name"], severity="error", fuid=fuid, failure=kind)
        self._finish_trace(r, "lost")

    def _moved(self, r: dict, fuid: int, slot: dict, survivor: dict, kind: str, reply: dict, m, allow_kv: bool,
               per_tok: int, fixed: int) -> None:
        """Account one imported request: priced against its snapshot's rows
        when it carried them, moved bytes as the survivor counted them."""
        old_uid = str(r["uid"])
        use_kv = bool(allow_kv and m is not None and m.get("has_kv"))
        predicted = (int(m["rows"]) * per_tok + fixed) if use_kv else 0
        moved = int(reply.get("kv_bytes", {}).get(old_uid, 0))
        new_uid = int(reply["uids"][old_uid])
        r["slot"] = survivor
        r["uid"] = new_uid
        survivor["uids"][new_uid] = fuid
        self._acct["failovers"] += 1
        if use_kv and moved:
            self._acct["failovers_kv"] += 1
            self._acct["bytes_predicted"] += predicted
            self._acct["bytes_moved"] += moved
        else:
            self._acct["failovers_recompute"] += 1
        self._tracer.seg(r.get("trace"), "failover", src=slot["name"], dst=survivor["name"], failure=kind,
                         predicted_bytes=predicted, moved_bytes=moved)
        self._log.emit(
            "event", "proc_failover", worker=slot["name"], severity="warning", fuid=fuid, dst=survivor["name"],
            failure=kind, kv=use_kv, snapshot=m is not None, generated=0 if m is None else int(m["generated"]),
            predicted_bytes=predicted, moved_bytes=moved,
        )

    @staticmethod
    def _record_snapshot(r: dict) -> dict:
        """A snapshot rebuilt from the supervisor's record of a request its
        dead worker never reported (the sampling state captured at submit
        keeps the stream exact)."""
        return {
            "uid": r["uid"],
            "prompt": np.asarray(r["prompt"], np.int32),
            "max_new_tokens": r["max_new"],
            "out_tokens": [],
            "out_lps": [],
            "stop_sequences": tuple(tuple(s) for s in r["stops"]),
            "priority": r["priority"],
            "trace": r.get("trace"),
            "gen_state": np.asarray(r["gen_state"], np.uint8),
        }

    # ------------------------------------------------------------------ #
    # pump (the single IO thread)
    # ------------------------------------------------------------------ #

    def pump(self) -> None:
        """One supervision iteration: accept hellos, serve queued
        commands, poll worker status, observe process exits, respawn due
        slots, publish. Call in a loop (``serve``'s main loop, or a test
        harness's)."""
        self._accept_hellos()
        self._serve_commands()
        now = time.monotonic()
        for slot in self._slots:
            if slot["health"] in SERVING_WORKER_STATES and now >= slot["next_poll_at"]:
                slot["next_poll_at"] = now + self.config.poll_interval_s
                self._poll_slot(slot)
        self._reap_exits()
        self._respawn_due()
        self._publish()

    def _poll_slot(self, slot: dict) -> None:
        try:
            reply, blob = request(
                slot["conn"],
                {"op": "status", "ack": slot["acked"], "shadow_kv": self.config.shadow_kv},
                timeout=self.config.heartbeat_timeout_s,
            )
        except socket.timeout:
            self._on_worker_timeout(slot)
            return
        except (TransportError, OSError):
            # a dropped connection almost always means the process just
            # died (SIGKILL mid-frame); the exit can lag the socket close
            # by a scheduler beat, so give it a moment to become reapable:
            # a real death taken for a timeout would quarantine-dump
            # without the kill evidence
            rc = slot["proc"].poll()
            if rc is None:
                try:
                    rc = slot["proc"].wait(timeout=0.25)
                except subprocess.TimeoutExpired:
                    rc = None
            if rc is not None:
                self._on_worker_exit(slot, rc)
            else:
                self._on_worker_timeout(slot)
            return
        slot["acked"] = []
        fault = reply.get("fault")
        if fault and fault.get("kind") == "poison":
            self._on_worker_poison(slot, fault.get("detail", ""))
            return
        if fault:
            self._log.emit("event", "proc_worker_error", worker=slot["name"], severity="error",
                           detail=fault.get("detail", ""))
        self._on_worker_clean(slot)
        slot["status"] = {
            "queue": reply.get("queue", 0), "active": reply.get("active", 0),
            "busy": reply.get("busy", False), "compiles": reply.get("compiles", 0),
            "deserialized": reply.get("deserialized", 0), "nvcc_builds": reply.get("nvcc_builds", 0),
            "launches": reply.get("launches", {}), "decode_steps": reply.get("decode_steps", 0),
            "tick_profile": reply.get("tick_profile"), "timing": reply.get("timing", {}),
            "metrics": reply.get("metrics", {}),
        }
        self._incarnations[slot["name"]].update(slot["status"])
        # progress -> published streams
        for uid_s, prog in (reply.get("progress") or {}).items():
            fuid = slot["uids"].get(int(uid_s))
            if fuid is None:
                continue
            r = self._reqs[fuid]
            r["tokens"] = list(prog.get("tokens") or [])
            r["lps"] = list(prog.get("lps") or [])
        # done results
        for uid_s, res in (reply.get("done") or {}).items():
            uid = int(uid_s)
            slot["acked"].append(uid)
            fuid = slot["uids"].pop(uid, None)
            if fuid is None:
                continue
            r = self._reqs[fuid]
            r["state"] = "done"
            r["final"] = list(res.get("tokens") or [])
            r["lps"] = list(res.get("lps") or [])
            r["tokens"] = r["final"][len(r["prompt"]):]
            self._finish_trace(r, "ok")
            self._log.emit("event", "proc_done", worker=slot["name"], severity="info", fuid=fuid,
                           tokens=len(r["tokens"]))
        # fresh failover snapshots (the recovery points)
        snaps_meta = reply.get("snaps")
        if snaps_meta is not None:
            slot["shadow"] = (snaps_meta, blob)

    def _reap_exits(self) -> None:
        for slot in self._slots:
            proc = slot["proc"]
            if proc is None or slot["health"] == "dead":
                continue
            rc = proc.poll()
            if rc is None:
                continue
            if slot["health"] == "quarantined":
                # already handled (we killed it); just observe the exit
                self._log.emit("event", "proc_exit", worker=slot["name"], severity="info", returncode=rc,
                               after="quarantine")
                slot["proc"] = None
                continue
            self._on_worker_exit(slot, rc)

    def _respawn_due(self) -> None:
        now = time.monotonic()
        for slot in self._slots:
            if slot["health"] == "spawning" and slot["spawn_deadline"] is not None \
                    and now > slot["spawn_deadline"] and slot["hello"] is None:
                self._log.emit("event", "proc_spawn_timeout", worker=slot["name"], severity="error")
                self._kill_slot(slot)
                self._set_health(slot, "dead", "spawn timeout")
                self._schedule_respawn(slot)
                continue
            if (
                slot["health"] in ("dead", "quarantined")
                and slot["next_spawn_at"] is not None
                and now >= slot["next_spawn_at"]
                and not self._breaker_open
                and not slot["gave_up"]
            ):
                slot["next_spawn_at"] = None
                self._spawn_slot(slot)

    # ------------------------------------------------------------------ #
    # measurement controls (pump-owner thread)
    # ------------------------------------------------------------------ #

    def _serving_slots(self) -> list:
        return [s for s in self._slots if s["health"] in SERVING_WORKER_STATES and s["conn"] is not None]

    def reset_counts(self) -> None:
        """Set every live worker's kernel launch counts, decode steps and
        tick timers to 0 (and forget the last polled ones): what a
        measurement does just before the traffic it counts."""
        for slot in self._serving_slots():
            request(slot["conn"], {"op": "reset_counts"}, timeout=self.config.heartbeat_timeout_s)
            self._incarnations[slot["name"]].update(launches={}, decode_steps=0, timing={})

    def request_tick_profile(self) -> None:
        """Ask every live worker to profile its next busy tick (card only):
        the result arrives in a later status poll, in
        ``worker_stats()[name]["tick_profile"]``."""
        for slot in self._serving_slots():
            request(slot["conn"], {"op": "profile_tick"}, timeout=self.config.heartbeat_timeout_s)
            self._incarnations[slot["name"]]["tick_profile"] = None

    # ------------------------------------------------------------------ #
    # command surface (any thread): queue in, published snapshot out
    # ------------------------------------------------------------------ #

    def submit(
        self,
        prompt_ids,
        max_new_tokens: int = 16,
        stop_sequences=None,
        priority: int = 0,
        wait: bool = False,
        timeout: float = 30.0,
    ) -> int:
        """Route one request to the fleet; returns the fleet-wide id.
        ``wait=True`` blocks until the pump thread actually routed (or
        shed) it and raises the structured failure."""
        fuid = self._mint_fuid()
        reply: Optional[queue.Queue] = queue.Queue(maxsize=1) if wait else None
        self._cmds.put(
            {
                "op": "submit", "fuid": fuid,
                "prompt": [int(t) for t in np.asarray(prompt_ids).ravel()],
                "max_new_tokens": int(max_new_tokens),
                "stops": [list(s) for s in (stop_sequences or [])],
                "priority": int(priority),
                "reply": reply,
            }
        )
        if reply is not None:
            result = reply.get(timeout=timeout)
            if result.get("err"):
                raise FleetRequestError(fuid, result["err"])
        return fuid

    def cancel(self, fuid: int, timeout: float = 30.0) -> list:
        """Cancel a request; returns its tokens so far."""
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._cmds.put({"op": "cancel", "fuid": int(fuid), "reply": reply})
        result = reply.get(timeout=timeout)
        if result.get("err"):
            raise KeyError(f"request {fuid}: {result['err']}")
        return result.get("tokens", [])

    def _mint_fuid(self) -> int:
        with self._pub_lock:
            fuid = self._next_fuid
            self._next_fuid += 1
            # visible as "queued" until the pump routes the command and the
            # next publish carries the real state: a poll racing the pump
            # must not see "unknown request" for an id submit() handed out
            self._pending_fuids.add(fuid)
        return fuid

    def _serve_commands(self) -> None:
        """Serve the queued commands in order; each run of consecutive
        submits goes out as one burst (:meth:`_cmd_submit_burst`)."""
        cmds = []
        while True:
            try:
                cmds.append(self._cmds.get_nowait())
            except queue.Empty:
                break
        burst: list = []
        for cmd in cmds + [None]:
            if cmd is not None and cmd["op"] == "submit":
                burst.append(cmd)
                continue
            if burst:
                self._cmd_submit_burst(burst)
                burst = []
            if cmd is not None and cmd["op"] == "cancel":
                self._cmd_cancel(cmd)

    def _reply(self, cmd: dict, result: dict) -> None:
        q = cmd.get("reply")
        if q is not None:
            q.put(result)

    def _shed(self, cmd: dict, err: str) -> None:
        self._reqs[cmd["fuid"]] = {"state": "shed", "prompt": cmd["prompt"], "tokens": []}
        self._reply(cmd, {"err": err})

    def _cmd_submit_burst(self, cmds: list) -> None:
        """Route a burst of submits (least outstanding, counting the burst's
        own), then send each worker its share back to back before reading
        its replies: a worker serves the frames already waiting before it
        ticks, so the burst lands whole, in one round trip a worker."""
        shares: dict = {}
        for cmd in cmds:
            if self._drain_flag.is_set():
                self._shed(cmd, "supervisor draining")
                continue
            slot = self._route(pending={k: len(v[1]) for k, v in shares.items()})
            if slot is None:
                self._log.emit("event", "proc_shed", severity="warning", fuid=cmd["fuid"],
                               reason="zero routable workers")
                self._shed(cmd, "zero routable workers")
                continue
            trace = self._tracer.start(fuid=cmd["fuid"], prompt_len=len(cmd["prompt"]))
            shares.setdefault(slot["slot"], (slot, []))[1].append((cmd, trace))
        for slot, share in shares.values():
            replies = []
            try:
                slot["conn"].settimeout(self.config.heartbeat_timeout_s)
                for cmd, trace in share:
                    send_msg(slot["conn"], {
                        "op": "submit", "prompt": cmd["prompt"], "max_new_tokens": cmd["max_new_tokens"],
                        "stop_sequences": cmd["stops"], "priority": cmd["priority"], "trace": trace,
                    })
                for _ in share:
                    replies.append(recv_msg(slot["conn"])[0])
            except (TransportError, OSError):
                pass  # the worker failed at submit time: its health event fires on the next poll
            for i, (cmd, trace) in enumerate(share):
                if i >= len(replies):
                    self._tracer.finish(trace, status="error")
                    self._shed(cmd, "worker transport failure; retry")
                elif replies[i].get("err") is not None:
                    e = WorkerError(replies[i]["err"])
                    self._tracer.finish(trace, status="shed")
                    self._shed(cmd, f"{e.kind}: {e}")
                else:
                    self._routed(slot, cmd, trace, replies[i])

    def _routed(self, slot: dict, cmd: dict, trace, reply: dict) -> None:
        fuid, uid = cmd["fuid"], int(reply["uid"])
        self._reqs[fuid] = {
            "fuid": fuid, "state": "routed", "slot": slot, "uid": uid,
            "prompt": cmd["prompt"], "max_new": cmd["max_new_tokens"],
            "stops": cmd["stops"], "priority": cmd["priority"],
            "trace": trace, "gen_state": reply.get("gen_state") or [],
            "tokens": [], "lps": [], "final": None,
        }
        slot["uids"][uid] = fuid
        self._log.emit(
            "event", "proc_submit", worker=slot["name"], severity="info",
            fuid=fuid, uid=uid, prompt_len=len(cmd["prompt"]),
            max_new_tokens=cmd["max_new_tokens"], trace=trace,
        )
        self._reply(cmd, {"ok": True, "worker": slot["name"]})

    def _cmd_cancel(self, cmd: dict) -> None:
        r = self._reqs.get(cmd["fuid"])
        if r is None:
            self._reply(cmd, {"err": "unknown request"})
            return
        if r["state"] != "routed":
            self._reply(cmd, {"tokens": r.get("tokens", [])})
            return
        slot = r["slot"]
        try:
            reply, _ = request(slot["conn"], {"op": "cancel", "uid": r["uid"]},
                               timeout=self.config.heartbeat_timeout_s)
            tokens = reply.get("tokens", [])
        except (TransportError, OSError):
            tokens = r.get("tokens", [])
        slot["uids"].pop(r["uid"], None)
        r["state"] = "cancelled"
        r["final"] = tokens
        r["tokens"] = tokens[len(r["prompt"]):] if len(tokens) >= len(r["prompt"]) else tokens
        self._finish_trace(r, "cancelled")
        self._log.emit("event", "proc_cancel", worker=slot["name"], severity="info", fuid=cmd["fuid"])
        self._reply(cmd, {"tokens": tokens})

    def _route(self, exclude: Optional[dict] = None, pending: Optional[dict] = None) -> Optional[dict]:
        """Least-outstanding routable worker (real liveness: a slot whose
        process died is never routable, whatever its last status said);
        ``pending`` adds requests on their way to a slot (by slot index)."""
        pending = pending or {}
        best, best_load = None, None
        for slot in self._slots:
            if slot is exclude or slot["health"] not in SERVING_WORKER_STATES:
                continue
            if slot["conn"] is None:
                continue
            load = len(slot["uids"]) + pending.get(slot["slot"], 0)
            if best is None or load < best_load:
                best, best_load = slot, load
        return best

    # ------------------------------------------------------------------ #
    # published read surface (any thread; lock-guarded dict copies)
    # ------------------------------------------------------------------ #

    def _publish(self) -> None:
        streams = {}
        for fuid, r in self._reqs.items():
            streams[fuid] = {
                "state": r["state"],
                "tokens": list(r.get("tokens") or []),
                "lps": list(r.get("lps") or []),
                "final": None if r.get("final") is None else list(r["final"]),
                "lost_reason": r.get("lost_reason"),
            }
        health = {
            slot["name"]: {
                "health": slot["health"], "reason": slot["reason"],
                "slot": slot["slot"], "respawns": slot["respawns"],
                "pid": slot["proc"].pid if slot["proc"] else None,
                "outstanding": len(slot["uids"]),
                "compiles": (slot.get("status") or {}).get("compiles"),
                "deserialized": (slot.get("status") or {}).get("deserialized"),
                "nvcc_builds": (slot.get("status") or {}).get("nvcc_builds"),
                "draining": self._drain_flag.is_set(),
            }
            for slot in self._slots
        }
        stats = {name: dict(inc) for name, inc in self._incarnations.items()}
        summary = {
            "requests": len(self._reqs),
            "done": sum(1 for r in self._reqs.values() if r["state"] == "done"),
            "routed": sum(1 for r in self._reqs.values() if r["state"] == "routed"),
            "lost": sum(1 for r in self._reqs.values() if r["state"] == "lost"),
            "breaker_open": self._breaker_open,
            "respawns_total": self._respawns_total,
            "accounting": dict(self._acct),
        }
        prom = self._prometheus(health, summary)
        with self._pub_lock:
            # minted fuids whose submit the pump has served now show up in
            # streams; the rest are still queued commands
            self._pending_fuids.difference_update(streams)
            for fuid in self._pending_fuids:
                streams[fuid] = {"state": "queued", "tokens": [], "lps": [], "final": None, "lost_reason": None}
            self._pub["streams"] = streams
            self._pub["health"] = health
            self._pub["summary"] = summary
            self._pub["prom"] = prom
            self._pub["stats"] = stats

    def _prometheus(self, health: dict, summary: dict) -> str:
        lines = [
            "# HELP proc_worker_state worker health (0 healthy, 1 degraded, 2 quarantined, 3 dead, 4 spawning)",
            "# TYPE proc_worker_state gauge",
        ]
        level = {"healthy": 0, "degraded": 1, "quarantined": 2, "dead": 3, "spawning": 4}
        for name, h in sorted(health.items()):
            lines.append(f'proc_worker_state{{worker="{name}"}} {level.get(h["health"], -1)}')
        lines += [
            "# HELP proc_worker_outstanding requests routed to the worker",
            "# TYPE proc_worker_outstanding gauge",
        ]
        for name, h in sorted(health.items()):
            lines.append(f'proc_worker_outstanding{{worker="{name}"}} {h["outstanding"]}')
        for key in ("requests", "done", "routed", "lost", "respawns_total"):
            lines.append(f"# TYPE proc_{key} gauge")
            lines.append(f"proc_{key} {summary[key]}")
        for key, val in sorted(summary["accounting"].items()):
            lines.append(f"# TYPE proc_{key}_total counter")
            lines.append(f"proc_{key}_total {val}")
        lines.append("# TYPE proc_breaker_open gauge")
        lines.append(f"proc_breaker_open {int(summary['breaker_open'])}")
        return "\n".join(lines) + "\n"

    def health(self) -> dict:
        with self._pub_lock:
            return dict(self._pub["health"])

    def summary(self) -> dict:
        with self._pub_lock:
            return dict(self._pub["summary"])

    def worker_stats(self) -> dict:
        """Per worker incarnation (a dead one's kept), from its hello and
        its last polled status: pid, health, spin-up seconds (spawn to
        hello), the hello (``compiles`` / ``deserialized``: the programs
        its boot compiled and installed from the store; ``nvcc_builds`` /
        ``prebuilt_loads``: the kernel libraries it built and found built;
        ``model_s``, ``warm_s``), the serving kernels' launch counts and
        the decode steps since the last :meth:`reset_counts`, host tick and
        status-reply timers, the last tick profile, and the engine's numeric
        metrics."""
        with self._pub_lock:
            return dict(self._pub["stats"])

    def prometheus_text(self) -> str:
        with self._pub_lock:
            return self._pub["prom"]

    def failover_accounting(self) -> dict:
        with self._pub_lock:
            return dict(self._acct)

    def _stream(self, fuid: int) -> dict:
        with self._pub_lock:
            s = self._pub["streams"].get(int(fuid))
            if s is None and int(fuid) in self._pending_fuids:
                # minted but not yet published: the submit is still queued
                s = {"state": "queued", "tokens": [], "lps": [], "final": None, "lost_reason": None}
        if s is None:
            raise KeyError(f"unknown request {fuid}")
        return s

    def poll(self, fuid: int):
        """Finished [prompt + generated] tokens, or None while pending.
        Lost/shed requests raise their structured reason."""
        s = self._stream(fuid)
        if s["state"] in ("lost", "shed"):
            raise FleetRequestError(fuid, s.get("lost_reason") or s["state"])
        if s["state"] in ("done", "cancelled") and s["final"] is not None:
            return np.asarray(s["final"], np.int64)
        return None

    def partial(self, fuid: int) -> np.ndarray:
        """Generated-so-far tokens (streaming read)."""
        s = self._stream(fuid)
        return np.asarray(s["tokens"], np.int64)

    def logprobs(self, fuid: int) -> np.ndarray:
        s = self._stream(fuid)
        return np.asarray(s["lps"], np.float64)

    def request_state(self, fuid: int) -> str:
        return self._stream(fuid)["state"]

    # ------------------------------------------------------------------ #
    # drain / shutdown (pump-owner thread)
    # ------------------------------------------------------------------ #

    def request_drain(self) -> None:
        """Stop accepting new work (the SIGTERM handler sets this; it is
        the only supervisor method that is async-signal safe)."""
        self._drain_flag.set()

    def draining(self) -> bool:
        return self._drain_flag.is_set()

    def drained(self) -> bool:
        return self._drain_flag.is_set() and not any(r["state"] == "routed" for r in self._reqs.values())

    def drain_worker(self, name: str) -> dict:
        """Gracefully remove ONE live worker: export its full in-flight
        state (KV included), migrate to survivors, shut it down. The
        planned-maintenance twin of crash failover; same pricing."""
        slot = next((s for s in self._slots if s["name"] == name), None)
        if slot is None or slot["health"] not in SERVING_WORKER_STATES:
            raise KeyError(f"no live worker {name!r}")
        reply, blob = request(slot["conn"], {"op": "export", "include_kv": True},
                              timeout=self.config.heartbeat_timeout_s)
        slot["shadow"] = (reply.get("snaps") or [], blob)
        self._set_health(slot, "dead", "drained")
        self._migrate_worker(slot, kind="drain", allow_kv=True)
        self._shutdown_slot(slot)
        self._publish()
        return {"migrated": len(reply.get("snaps") or [])}

    def _work_remaining(self) -> bool:
        return any(r["state"] == "routed" for r in self._reqs.values())

    def run_until_drained(self, timeout_s: float = 300.0) -> bool:
        """Pump until every routed request resolved; the SIGTERM drain
        path of :func:`serve`."""
        deadline = time.monotonic() + timeout_s
        while self._work_remaining() and time.monotonic() < deadline:
            self.pump()
            time.sleep(0.002)
        return not self._work_remaining()

    def shutdown(self) -> None:
        """Stop everything: polite shutdown RPC per live worker, then
        SIGKILL stragglers (a worker still booting at once), close the
        logs."""
        # every worker is told first, then each is waited for: they exit together
        said_bye = [self._bye(slot) for slot in self._slots]
        for slot, bye in zip(self._slots, said_bye):
            self._reap(slot, bye)
        self._listener.close()
        self._log.emit("event", "proc_supervisor_shutdown", severity="info", accounting=dict(self._acct),
                       respawns=self._respawns_total)
        self._log.close()

    def _shutdown_slot(self, slot: dict) -> None:
        self._reap(slot, self._bye(slot))

    def _bye(self, slot: dict) -> bool:
        """The polite shutdown RPC; whether the worker acknowledged it."""
        if slot["conn"] is None:
            return False
        try:
            request(slot["conn"], {"op": "shutdown"}, timeout=2.0)
            return True
        except (TransportError, OSError):
            return False
        finally:
            self._close_conn(slot)

    def _reap(self, slot: dict, said_bye: bool) -> None:
        """Wait for the worker's exit; SIGKILL it if it does not come (at
        once for a worker that never said hello: it is still booting)."""
        proc = slot["proc"]
        if proc is not None and proc.poll() is None:
            try:
                proc.wait(timeout=5.0 if said_bye else 0.1)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)

    def _kill_slot(self, slot: dict) -> None:
        self._close_conn(slot)
        proc = slot["proc"]
        if proc is not None and proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self._log.emit("event", "proc_kill_stuck", worker=slot["name"], severity="error")

    def _close_conn(self, slot: dict) -> None:
        if slot["conn"] is not None:
            try:
                slot["conn"].close()
            except OSError:
                pass
            slot["conn"] = None

    def _flight_dump(self, slot: dict, reason: str) -> None:
        fr = self._recorders.get(slot["name"])
        if fr is None:
            return
        inflight = [
            {"fuid": fuid, "uid": r["uid"], "generated": len(r.get("tokens") or []), "trace": r.get("trace")}
            for fuid, r in self._reqs.items()
            if r["state"] == "routed" and r["slot"] is slot
        ]
        path = os.path.join(self.run_dir, f"flight_{slot['name']}.json")
        fr.dump(reason=reason, inflight=inflight, path=path)
        self._log.emit("event", "proc_flight_dump", worker=slot["name"], severity="info", path=path, reason=reason)

    def _finish_trace(self, r: dict, status: str) -> None:
        if r.get("trace") is not None:
            self._tracer.finish(r["trace"], status=status)
            r["trace_closed"] = True


class FleetRequestError(RuntimeError):
    """Structured terminal failure for one fleet request (lost to a
    failover dead-end, or shed at the supervisor edge)."""

    def __init__(self, fuid: int, detail):
        super().__init__(f"request {fuid}: {detail}")
        self.fuid = int(fuid)
        self.detail = detail


# ===================================================================== #
# serve(): supervisor + HTTP/SSE front door + signal-driven drain
# ===================================================================== #


def serve(
    config: Optional[ProcConfig] = None,
    http_host: str = "127.0.0.1",
    http_port: int = 0,
    ready_file: Optional[str] = None,
    max_runtime_s: Optional[float] = None,
) -> int:
    """Run the multi-process fleet behind the HTTP front door until
    SIGTERM/SIGINT, then drain: stop accepting, let in-flight requests
    finish (or migrate off failing workers), shut workers down, exit 0.
    ``ready_file`` (written once serving) and ``max_runtime_s`` exist for
    test harnesses."""
    from .telemetry.httpd import TelemetryHTTPD

    sup = ProcessSupervisor(config)
    sup.start(wait=True)
    httpd = TelemetryHTTPD.for_supervisor(sup, host=http_host, port=http_port)
    httpd.start()

    def _term(_signum, _frame):
        sup.request_drain()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    if ready_file:
        with open(ready_file, "w") as f:
            json.dump({"http_port": httpd.port, "pid": os.getpid()}, f)
    deadline = None if max_runtime_s is None else time.monotonic() + max_runtime_s
    while not sup.draining():
        sup.pump()
        time.sleep(0.002)
        if deadline is not None and time.monotonic() > deadline:
            sup.request_drain()
    drained = sup.run_until_drained()
    httpd.stop()
    sup.shutdown()
    return 0 if drained else 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("accelerate_tpu_torch.serving_proc")
    ap.add_argument("--worker", default=None, help="worker spec JSON (subprocess entry)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker_main(args.worker)
    ap.error("this module is the worker entry point; use `python -m accelerate_tpu_torch.commands.serve`")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
