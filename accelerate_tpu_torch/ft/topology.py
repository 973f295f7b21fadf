"""Topology records and the planners of an elastic restore.

Counterpart of :mod:`accelerate_tpu.ft.topology`, the part one process
needs. Every checkpoint's manifest (schema v2) carries a topology record:
the process count, the mesh, the data-parallel degree, the seed, and
every saved tensor's shape, dtype and bytes. On load,
:func:`compare_topology` classifies the restore as ``identical`` (the
bit-exact path), ``elastic`` (saved on another topology) or ``unknown``
(a schema-v1 manifest without a record).

The port trains one process on one card, so its live topology is always
the same one (process count 1, every mesh axis 1, data-parallel degree
1) and an elastic restore can only meet a checkpoint another layout
wrote; ``load_accelerator_state`` refuses it with ``NotImplementedError``
before restoring anything (multi-process training is ROADMAP.md Queue 1
item 8). The elastic planners are kept, exact copies of the JAX
package's arithmetic, for that item: :func:`derive_rng_state` re-derives
a process's host RNG from ``(seed, step, process_index)``, and
:func:`redistribute_sampler_state` re-splits a loader's global sample
offset over a new global batch. ``predict_reshard`` (the cost model's
price of the reshard) is not ported: the port has no cost model for a
mesh yet.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

#: version of the ``topology`` block inside the (v2) integrity manifest
TOPOLOGY_SCHEMA_VERSION = 1

#: restore-compatibility tiers, strongest first
IDENTICAL = "identical"
ELASTIC = "elastic"
UNKNOWN = "unknown"

#: the JAX package's mesh axes (``parallel/mesh.py::AXIS_NAMES``); on one
#: card each is 1
MESH_AXES = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


def _nontrivial(shape: Optional[dict]) -> dict[str, int]:
    """Mesh shape normalised to its non-trivial axes -- ``{"data": 4,
    "tensor": 1}`` and ``{"data": 4}`` describe the same topology."""
    if not shape:
        return {}
    return {str(a): int(s) for a, s in shape.items() if int(s) > 1}


def _leaves(prefix: str, tree):
    """``(name, tensor)`` for every tensor in a nesting of dicts, lists and
    tuples, named as ``jax.tree_util.keystr`` names a pytree path."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(f"{prefix}[{k!r}]", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(f"{prefix}[{i}]", v)


def capture_array_specs(tag: str, tree) -> dict[str, dict]:
    """``{leaf_name: {shape, dtype, spec, bytes}}`` for every tensor of a
    state about to be saved under directory ``tag``. ``spec`` is ``None``:
    one card holds every tensor whole."""
    out: dict[str, dict] = {}
    for name, t in _leaves(tag, tree):
        out[name] = {
            "shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch."),
            "spec": None,
            "bytes": t.numel() * t.element_size(),
        }
    return out


def live_topology(accelerator) -> dict:
    """The running job's topology in the same shape as the saved record."""
    return {
        "process_count": int(accelerator.num_processes),
        "mesh_shape": {a: 1 for a in MESH_AXES},
        "mesh_devices": 1,
        "dcn_axes": [],
        "data_parallel_degree": 1,
    }


def build_topology_record(accelerator, array_trees: Sequence[tuple]) -> dict:
    """The topology block for this save, stamped into the manifest by
    ``save_accelerator_state``. ``array_trees`` is ``[(dir_name, state),
    ...]``: exactly the host copies handed to the writers, keyed by their
    checkpoint subdirectory."""
    from ..utils.random import get_seed

    arrays: dict[str, dict] = {}
    for tag, tree in array_trees:
        arrays.update(capture_array_specs(tag, tree))
    return {
        "schema_version": TOPOLOGY_SCHEMA_VERSION,
        **live_topology(accelerator),
        "zero_stage": 0,
        "seed": get_seed(),
        "arrays": arrays,
    }


@dataclass
class TopologyDelta:
    """Outcome of :func:`compare_topology`.

    ``status`` is one of :data:`IDENTICAL` / :data:`ELASTIC` /
    :data:`UNKNOWN`; ``changes`` is a human-readable list of what moved
    (empty for identical)."""

    status: str
    changes: list[str] = field(default_factory=list)
    saved: Optional[dict] = None
    live: Optional[dict] = None

    @property
    def is_elastic(self) -> bool:
        return self.status == ELASTIC

    def describe(self) -> str:
        if self.status == IDENTICAL:
            return "identical topology: bit-exact restore (RNG pickles + sampler positions reused)"
        if self.status == UNKNOWN:
            return (
                "no topology record (pre-elastic checkpoint): restore is only "
                "verifiable on the topology that wrote it"
            )
        return "topology changed: elastic restore (arrays reshard on load, RNG re-derived, sampler offset redistributed)"


def _shape_str(shape: dict) -> str:
    nt = _nontrivial(shape)
    if not nt:
        return "single-device"
    return ",".join(f"{a}={s}" for a, s in sorted(nt.items()))


def compare_topology(saved: Optional[dict], live: dict) -> TopologyDelta:
    """Classify a restore of a checkpoint whose manifest carried ``saved``
    (or ``None`` for schema-v1 manifests) onto the ``live`` topology."""
    if not saved:
        return TopologyDelta(UNKNOWN, saved=saved, live=live)
    changes: list[str] = []
    if int(saved.get("process_count", 1)) != int(live.get("process_count", 1)):
        changes.append(
            f"process count {saved.get('process_count')} -> {live.get('process_count')}"
        )
    s_shape, l_shape = _nontrivial(saved.get("mesh_shape")), _nontrivial(live.get("mesh_shape"))
    if s_shape != l_shape:
        changes.append(f"mesh {_shape_str(saved.get('mesh_shape', {}))} -> {_shape_str(live.get('mesh_shape', {}))}")
    s_dp, l_dp = saved.get("data_parallel_degree"), live.get("data_parallel_degree")
    if s_dp is not None and l_dp is not None and int(s_dp) != int(l_dp):
        changes.append(f"data-parallel degree {s_dp} -> {l_dp}")
    if tuple(saved.get("dcn_axes", ())) != tuple(live.get("dcn_axes", ())):
        changes.append(
            f"dcn axes {list(saved.get('dcn_axes', []))} -> {list(live.get('dcn_axes', []))}"
        )
    status = ELASTIC if changes else IDENTICAL
    return TopologyDelta(status, changes=changes, saved=saved, live=live)


# ---------------------------------------------------------------------------
# deterministic host-RNG re-derivation (elastic restores)
# ---------------------------------------------------------------------------

def derive_rng_state(seed: Optional[int], process_index: int, step: int = 0) -> dict:
    """Deterministic per-process host RNG for a topology-changed resume:
    ``(seed, step, process_index)`` folded through a ``SeedSequence``, as
    the JAX package folds them (the same inputs give the same seeds).
    Reproducible, but NOT a continuation of the saved streams; callers
    must announce that."""
    # domain tag keeps these streams disjoint from any other SeedSequence
    # use of the same seed
    entropy = [0xE1A57, int(seed) if seed is not None else 0, int(step), int(process_index)]
    ss = np.random.SeedSequence(entropy)
    py_seed, np_seed = (int(x) for x in ss.generate_state(2, np.uint64))
    return {"python_seed": py_seed, "numpy_seed": np_seed % (2**32), "seed": seed}


def apply_derived_rng_state(derived: dict) -> None:
    """Seed python, numpy and torch (torch from the numpy seed) from
    :func:`derive_rng_state` output and restore the recorded seed without
    reseeding (``utils.random.restore_seed_for_keys``)."""
    from ..utils.random import restore_seed_for_keys

    random.seed(derived["python_seed"])
    np.random.seed(derived["numpy_seed"])
    torch.manual_seed(derived["numpy_seed"])
    restore_seed_for_keys(derived.get("seed"))


# ---------------------------------------------------------------------------
# sampler / dataloader redistribution
# ---------------------------------------------------------------------------

def redistribute_sampler_state(state: dict, new_global_batch_size: Optional[int]) -> tuple[dict, int]:
    """Recompute a saved dataloader position for a new data-parallel
    degree. The saved ``batches_yielded`` counts *global* batches of
    ``global_batch_size`` samples; the invariant that survives an elastic
    restore is the global sample offset -- their product. Returns
    ``(new_state, replayed_samples)`` where ``replayed_samples`` counts
    samples that will be delivered a second time because the offset is
    not divisible by the new global batch (rounded DOWN: replaying a few
    samples is benign, skipping unseen ones is not)."""
    old_gb = state.get("global_batch_size")
    yielded = int(state.get("batches_yielded", 0) or 0)
    if not old_gb or not new_global_batch_size or int(old_gb) == int(new_global_batch_size):
        return dict(state), 0
    offset = yielded * int(old_gb)
    new_batches = offset // int(new_global_batch_size)
    replayed = offset - new_batches * int(new_global_batch_size)
    new_state = dict(state)
    new_state["batches_yielded"] = new_batches
    new_state["global_batch_size"] = int(new_global_batch_size)
    return new_state, replayed
