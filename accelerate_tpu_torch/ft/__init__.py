"""Fault tolerance: atomic checkpoint commits, integrity manifests,
preemption-safe auto-resume, and fault-injection crash points.

Counterpart of :mod:`accelerate_tpu.ft`. A kill mid-save must never
leave a checkpoint that a later ``Accelerator.load_state()`` mistakes for
a complete one, and pruning must never delete the last good checkpoint
before a new one has committed. This package provides the pieces
``checkpointing.py`` builds its atomic commit protocol from:

* :mod:`~accelerate_tpu_torch.ft.manifest` -- the ``commit_success.json``
  schema (identical to the JAX package's): per-file sizes + crc32
  digests, written last; its presence IS the commit point.
* :mod:`~accelerate_tpu_torch.ft.manager` -- :class:`CheckpointManager`:
  discovery that skips uncommitted/corrupt directories, deep
  ``verify()``, ``gc()`` of orphaned ``.tmp`` dirs (recovering fully
  written ones), and post-commit ``prune()`` that never touches the
  resume source.
* :mod:`~accelerate_tpu_torch.ft.preemption` -- :class:`PreemptionHandler`:
  SIGTERM/SIGINT -> a flag surfaced as ``Accelerator.should_checkpoint``
  / ``Accelerator.should_stop``.
* :mod:`~accelerate_tpu_torch.ft.topology` -- the manifest's topology
  record, its comparison on load, and the elastic planners (RNG
  re-derivation, sampler redistribution). ``predict_reshard`` and
  ``ReshardPrediction`` are not ported: they price a reshard across a
  mesh, which the port does not have yet (ROADMAP.md Queue 1 item 8).
* :mod:`~accelerate_tpu_torch.ft.crashpoints` -- the labeled points inside
  the save and restore paths that
  :mod:`accelerate_tpu_torch.test_utils.fault_injection` kills at.
"""

from .crashpoints import (
    ALL_CRASH_POINTS,
    CRASH_POINTS,
    RESTORE_CRASH_POINTS,
    crash_point,
    set_crash_hook,
)
from .manager import CheckpointManager, VerifyResult
from .manifest import (
    MANIFEST_NAME,
    MANIFEST_SCHEMA_VERSION,
    SUPPORTED_SCHEMA_VERSIONS,
    TMP_SUFFIX,
    build_manifest,
    read_manifest,
    verify_manifest,
    write_manifest,
)
from .preemption import PreemptionHandler
from .topology import (
    ELASTIC,
    IDENTICAL,
    UNKNOWN,
    TopologyDelta,
    build_topology_record,
    compare_topology,
    derive_rng_state,
    live_topology,
    redistribute_sampler_state,
)

__all__ = [
    "ALL_CRASH_POINTS",
    "CRASH_POINTS",
    "RESTORE_CRASH_POINTS",
    "crash_point",
    "set_crash_hook",
    "MANIFEST_NAME",
    "MANIFEST_SCHEMA_VERSION",
    "SUPPORTED_SCHEMA_VERSIONS",
    "TMP_SUFFIX",
    "build_manifest",
    "write_manifest",
    "read_manifest",
    "verify_manifest",
    "CheckpointManager",
    "VerifyResult",
    "PreemptionHandler",
    "ELASTIC",
    "IDENTICAL",
    "UNKNOWN",
    "TopologyDelta",
    "build_topology_record",
    "compare_topology",
    "live_topology",
    "derive_rng_state",
    "redistribute_sampler_state",
]
