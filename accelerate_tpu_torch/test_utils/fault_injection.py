"""Crash-point fault injection for the checkpoint save and restore paths.

Copies of :class:`accelerate_tpu.test_utils.fault_injection.SimulatedCrash`,
``CrashPoint`` and ``corrupt_file``. The save protocol
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
size/crc32 detection. The serving fleet's ``ReplicaChaos`` waits for the
fleet (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import os
from pathlib import Path

from ..ft.crashpoints import ALL_CRASH_POINTS, CRASH_POINTS, RESTORE_CRASH_POINTS, set_crash_hook

__all__ = [
    "SimulatedCrash",
    "CrashPoint",
    "corrupt_file",
    "CRASH_POINTS",
    "RESTORE_CRASH_POINTS",
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
