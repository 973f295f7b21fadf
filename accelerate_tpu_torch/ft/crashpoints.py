"""Labeled crash points inside the checkpoint save and restore paths.

Counterpart of :mod:`accelerate_tpu.ft.crashpoints`, with the same three
label tuples. ``checkpointing.save_accelerator_state`` calls
:func:`crash_point` at every state transition of the atomic commit
protocol. In production the calls are free (one ``is None`` check); under
test, :class:`accelerate_tpu_torch.test_utils.fault_injection.CrashPoint`
installs a hook that raises (or kills the process) at a chosen label,
driving the crash-at-every-point matrix that proves resume always lands on
a valid checkpoint.

The save labels, in save order:

* ``pre_write``   -- before anything touches disk (no ``.tmp`` dir yet)
* ``mid_pytree``  -- after the first model's tensors were written (sync
  save) or copied to the host (async save): the tmp dir holds a partial
  array set
* ``pre_manifest``-- all data written, manifest not yet written (tmp dir
  complete but uncommitted)
* ``pre_rename``  -- manifest written (COMMITTED) but the tmp dir not yet
  renamed to its final name (recoverable by ``CheckpointManager.gc``)
* ``mid_prune``   -- new checkpoint visible, ``total_limit`` pruning in
  progress

``load_accelerator_state`` is instrumented the same way (a kill
mid-restore must leave the checkpoint untouched so a fresh auto-resume
lands on it again). The restore labels, in restore order:

* ``pre_restore``       -- checkpoint located (and its topology
  compared), nothing restored yet
* ``mid_restore_arrays``-- after the first model's tensors were copied in
  (optimizer state not yet)
* ``pre_restore_rng``   -- arrays, schedulers and samplers restored, host
  RNG not yet touched

The serving labels keep the JAX package's names. ``ServingEngine.step``
calls the first three at the tick's phase boundaries, where the engine's
host state is consistent; the fleet router's disaggregated dispatch calls
``pre_handoff``. Each passes ``replica=<name>``:

* ``pre_tick``    -- the start of a tick, before shedding and admissions
* ``mid_prefill`` -- before each prefilling slot's next window or bucket
* ``mid_decode``  -- before the decode tick runs
* ``pre_handoff`` -- before a prefill replica runs a detached prefill.
"""

from __future__ import annotations

from typing import Callable, Optional

#: every labeled save-path point, in the order the save path reaches them
CRASH_POINTS = ("pre_write", "mid_pytree", "pre_manifest", "pre_rename", "mid_prune")

#: every labeled restore-path point, in the order the load path reaches
#: them — restore never mutates the checkpoint, so a crash at ANY of
#: these must leave it as valid as it was
RESTORE_CRASH_POINTS = ("pre_restore", "mid_restore_arrays", "pre_restore_rng")

#: serving-fleet points (ServingEngine tick phases + the router's
#: disaggregated dispatch) — each at a boundary where the engine's host
#: state is consistent, so in-flight work is exactly exportable
SERVING_CRASH_POINTS = ("pre_tick", "mid_prefill", "mid_decode", "pre_handoff")

#: the full label set CrashPoint accepts
ALL_CRASH_POINTS = CRASH_POINTS + RESTORE_CRASH_POINTS + SERVING_CRASH_POINTS

_hook: Optional[Callable[..., None]] = None


def set_crash_hook(hook: Optional[Callable[..., None]]):
    """Install (or clear, with ``None``) the process-wide crash hook.
    Test-only machinery — production code never sets a hook."""
    global _hook
    _hook = hook


def crash_point(label: str, **ctx):
    """Invoke the crash hook, if any, with ``label`` (+ context kwargs —
    serving passes ``replica=``). Called by the save path at each
    protocol transition and by the serving tick phases; a no-op unless a
    hook is installed."""
    if _hook is not None:
        _hook(label, **ctx)
