"""Crash-point fault injection for the checkpoint save and restore paths
and the serving fleet.

Copies of :class:`accelerate_tpu.test_utils.fault_injection.SimulatedCrash`,
``CrashPoint``, ``ReplicaChaos`` (its in-process actions) and
``corrupt_file``. The save protocol
(``checkpointing.save_accelerator_state``) and the restore path call
:func:`accelerate_tpu_torch.ft.crashpoints.crash_point` at every state
transition; :class:`CrashPoint` installs a hook that kills them there,
driving the crash-at-every-point matrix of
``tests/test_torch_fault_tolerance.py`` that proves ``load_state()``
auto-resume always lands on a valid checkpoint::

    with CrashPoint("pre_rename"):
        with pytest.raises(SimulatedCrash):
            accelerator.save_state()        # dies mid-commit
    accelerator.load_state()                # resumes from the last GOOD one

``CrashPoint(..., action="kill")`` hard-kills the process with
``os._exit`` (no atexit, no finally blocks). :func:`corrupt_file`
truncates, garbles or deletes committed files to exercise the manifest's
size/crc32 detection. :class:`ReplicaChaos` faults one replica of a
:class:`~accelerate_tpu_torch.serving_fleet.FleetRouter` at a serving
crash point; its process-level actions (``sigkill``, ``sigstop``) fault
one engine-worker process of the multi-process fleet
(:mod:`accelerate_tpu_torch.serving_proc`), installed at the worker's boot
by :meth:`ReplicaChaos.install_from_env`.
"""

from __future__ import annotations

import json
import os
import signal
import time
from pathlib import Path

from ..ft.crashpoints import (
    ALL_CRASH_POINTS,
    CRASH_POINTS,
    RESTORE_CRASH_POINTS,
    SERVING_CRASH_POINTS,
    set_crash_hook,
)

__all__ = [
    "SimulatedCrash",
    "CrashPoint",
    "ReplicaChaos",
    "corrupt_file",
    "CRASH_POINTS",
    "RESTORE_CRASH_POINTS",
    "SERVING_CRASH_POINTS",
    "ALL_CRASH_POINTS",
]


class SimulatedCrash(RuntimeError):
    """Raised by :class:`CrashPoint` — deliberately NOT an ``OSError`` so
    the checkpoint path's IO retry decorator never absorbs it (a real
    kill isn't retryable either)."""


class CrashPoint:
    """Context manager that crashes the save at a labeled point.

    ``label`` must be one of
    :data:`~accelerate_tpu_torch.ft.crashpoints.ALL_CRASH_POINTS` (save-path
    ``CRASH_POINTS`` or restore-path ``RESTORE_CRASH_POINTS``). ``hits``
    delays the crash to the Nth time the label is reached (e.g.
    the second model's pytree write). ``action``: ``"raise"`` (default)
    raises :class:`SimulatedCrash`; ``"kill"`` calls ``os._exit(17)``.
    The hook is process-wide and cleared on exit; ``fired`` records
    whether the crash actually triggered."""

    EXIT_CODE = 17

    def __init__(self, label: str, action: str = "raise", hits: int = 1):
        if label not in ALL_CRASH_POINTS:
            raise ValueError(f"unknown crash point {label!r}; choose from {ALL_CRASH_POINTS}")
        if action not in ("raise", "kill"):
            raise ValueError(f"action must be raise|kill, got {action!r}")
        self.label = label
        self.action = action
        self.hits = max(1, int(hits))
        self.fired = False
        self._seen = 0

    def _hook(self, label: str, **ctx):
        if label != self.label:
            return
        self._seen += 1
        if self._seen < self.hits:
            return
        self.fired = True
        if self.action == "kill":
            os._exit(self.EXIT_CODE)
        raise SimulatedCrash(f"simulated crash at checkpoint save point {self.label!r}")

    def __enter__(self):
        set_crash_hook(self._hook)
        return self

    def __exit__(self, *exc):
        set_crash_hook(None)
        return False


class ReplicaChaos:
    """Chaos controller for the serving fleet, the serving twin of
    :class:`CrashPoint`: it drives the crash-at-every-point failover
    matrix of ``tests/test_torch_fleet.py``.

    Targets one labeled serving point
    (:data:`~accelerate_tpu_torch.ft.crashpoints.SERVING_CRASH_POINTS`:
    ``pre_tick`` / ``mid_prefill`` / ``mid_decode`` inside
    ``ServingEngine.step`` and ``pre_handoff`` in the router's
    disaggregated dispatch), on ONE named replica of a fleet (the serving
    crash points pass ``replica=<name>``; ``replica=None`` matches any).
    ``action``:

    * ``"crash"``   -- raise :class:`SimulatedCrash` (the replica died; its
      rows may still be exportable);
    * ``"poison"``  -- raise ``serving_fleet.NonFinitePoison`` (numerics are
      suspect: the router quarantines the replica and fails over by
      recompute only, never trusting its rows);
    * ``"hang"``    -- sleep ``hang_s`` (drives tick-timeout degradation);
    * ``"latency"`` -- sleep ``latency_s`` (slow-replica jitter).

    ``hits`` delays firing to the Nth matching visit; with ``repeat`` the
    hook fires on every later visit too (a persistently sick replica),
    else once. ``fired`` / ``count`` record what happened. Both raising
    actions use exception types that are not ``OSError``: the failover
    handoff leg's retry wrapper must never absorb a simulated death.

    **Process-level actions** (the multi-process fleet's faults, installed
    into one engine-worker process by :meth:`install_from_env` at boot):

    * ``"sigkill"`` -- ``os.kill(os.getpid(), SIGKILL)``: the kernel
      removes the process mid-tick; the supervisor observes a ``-9`` exit
      and fails the worker's in-flight snapshots over;
    * ``"sigstop"`` -- ``os.kill(os.getpid(), SIGSTOP)``: the process
      freezes (a real hang, not a sleep); the supervisor's heartbeat
      timeouts escalate degraded -> quarantined and SIGKILL it."""

    #: actions that end (or freeze) the whole process rather than raise
    PROCESS_ACTIONS = ("sigkill", "sigstop")

    def __init__(
        self,
        label: str,
        replica: str = None,
        action: str = "crash",
        hits: int = 1,
        repeat: bool = False,
        latency_s: float = 0.005,
        hang_s: float = 0.05,
    ):
        if label not in SERVING_CRASH_POINTS:
            raise ValueError(f"unknown serving crash point {label!r}; choose from {SERVING_CRASH_POINTS}")
        if action not in ("crash", "poison", "hang", "latency") + self.PROCESS_ACTIONS:
            raise ValueError(f"action must be crash|poison|hang|latency|sigkill|sigstop, got {action!r}")
        self.label = label
        self.replica = replica
        self.action = action
        self.hits = max(1, int(hits))
        self.repeat = bool(repeat)
        self.latency_s = float(latency_s)
        self.hang_s = float(hang_s)
        self.fired = False
        self.count = 0
        self._seen = 0

    def _hook(self, label: str, **ctx):
        if label != self.label:
            return
        if self.replica is not None and ctx.get("replica") != self.replica:
            return
        self._seen += 1
        if self._seen < self.hits or (self.fired and not self.repeat):
            return
        self.fired = True
        self.count += 1
        if self.action in ("hang", "latency"):
            time.sleep(self.hang_s if self.action == "hang" else self.latency_s)
            return
        if self.action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
            return  # unreachable: the kernel removes the process
        if self.action == "sigstop":
            os.kill(os.getpid(), signal.SIGSTOP)
            return  # resumes here only if something SIGCONTs the process
        where = f"{self.label!r}" + (f" on replica {self.replica!r}" if self.replica else "")
        if self.action == "poison":
            from ..serving_fleet import NonFinitePoison

            raise NonFinitePoison(f"simulated non-finite poison at {where}")
        raise SimulatedCrash(f"simulated replica crash at {where}")

    def __enter__(self):
        set_crash_hook(self._hook)
        return self

    def __exit__(self, *exc):
        set_crash_hook(None)
        return False

    # ------------------------------------------------------------------ #
    # process-level installation (engine-worker processes)
    # ------------------------------------------------------------------ #

    def to_env_spec(self, worker: str) -> str:
        """This chaos for ONE named worker process, as the JSON the
        ``ACCELERATE_TPU_PROC_CHAOS`` environment variable carries."""
        return json.dumps(
            {
                "worker": worker,
                "label": self.label,
                "action": self.action,
                "hits": self.hits,
                "repeat": self.repeat,
                "hang_s": self.hang_s,
                "latency_s": self.latency_s,
            }
        )

    @classmethod
    def install_from_env(cls, worker: str, env_var: str = "ACCELERATE_TPU_PROC_CHAOS"):
        """Worker-boot hook: if the environment variable names THIS
        worker, build the chaos and install its hook for good (no context
        manager: the process lives inside the chaos until it dies).
        Returns the installed instance or None. The supervisor sets the
        variable only on the targeted incarnation, so a respawn boots
        clean."""
        spec = os.environ.get(env_var)
        if not spec:
            return None
        cfg = json.loads(spec)
        if cfg.get("worker") not in (None, worker):
            return None
        chaos = cls(
            cfg["label"],
            replica=worker,
            action=cfg.get("action", "sigkill"),
            hits=int(cfg.get("hits", 1)),
            repeat=bool(cfg.get("repeat", False)),
            latency_s=float(cfg.get("latency_s", 0.005)),
            hang_s=float(cfg.get("hang_s", 0.05)),
        )
        set_crash_hook(chaos._hook)
        return chaos


def corrupt_file(path, mode: str = "truncate", nbytes: int = 16) -> str:
    """Damage a checkpoint file in place to exercise integrity checks.

    ``mode``: ``"truncate"`` chops ``nbytes`` off the end (size mismatch),
    ``"garbage"`` flips bytes in place keeping the size (crc32 mismatch),
    ``"delete"`` removes the file (missing-file detection). Returns the
    path for chaining."""
    p = Path(path)
    if mode == "delete":
        p.unlink()
        return str(p)
    data = p.read_bytes()
    if mode == "truncate":
        p.write_bytes(data[: max(0, len(data) - nbytes)])
    elif mode == "garbage":
        if not data:
            raise ValueError(f"cannot garble empty file {p}")
        n = min(nbytes, len(data))
        head = bytes((b ^ 0xFF) for b in data[:n])
        p.write_bytes(head + data[n:])
    else:
        raise ValueError(f"mode must be truncate|garbage|delete, got {mode!r}")
    return str(p)
