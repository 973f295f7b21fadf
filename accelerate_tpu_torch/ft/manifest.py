"""The checkpoint integrity manifest (``commit_success.json``).

Counterpart of :mod:`accelerate_tpu.ft.manifest`, with the schema kept
identical: the same file name, schema version, keys, digest policy and
durable write, so a checkpoint either package writes verifies in the
other. The manifest is the **commit point** of the atomic save protocol:
the arrays and state files are written into ``checkpoint_N.tmp/``, and
only then does the main process build and write the manifest and rename
the directory. A directory without a parseable, matching manifest is by
definition uncommitted: discovery
(:class:`~accelerate_tpu_torch.ft.manager.CheckpointManager`) never
returns it, and ``gc()`` may delete it.

Schema (``MANIFEST_SCHEMA_VERSION`` 2; v1 files parse identically, they
just carry no ``topology`` block)::

    {
      "schema_version": 2,
      "step": 12,                      # accelerator.step at save time
      "iteration": 3,                  # ProjectConfiguration.iteration (or null)
      "num_processes": 1,
      "files": {                       # small top-level state files
        "accelerate_state.json": {"size": 97, "crc32": 2614},
        "rng_state_0.pkl":       {"size": 1201, "crc32": 991},
        ...
      },
      "pytree_files": {                # every file under the array dirs
        "model/model.safetensors": 307, ...   # relpath -> size (bytes)
      },
      "pytree_dirs": ["model", "optimizer"],
      "orbax_metadata": {"model": false, "optimizer": false},
      "topology": {...}                # v2: what wrote this checkpoint
    }                                  # (ft/topology.py)

``orbax_metadata`` records, per array directory, whether it carries the
orbax markers the JAX package's directories hold; the port's
(safetensors and ``torch.save`` files) carry none, so it is ``false``
there, and deep verification checks the markers only where it is
``true``.

Digest policy: crc32 (zlib) for the small JSON/pkl control files -- they
decide *what* gets restored, so silent corruption there is the worst
case; the large array files get exact sizes. ``verify_manifest`` re-walks
the directory and reports every mismatch rather than stopping at the
first.
"""

from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Optional

MANIFEST_NAME = "commit_success.json"
MANIFEST_SCHEMA_VERSION = 2

#: versions ``read_manifest`` accepts: v1 (pre-elastic, no topology
#: record) still commits and restores on an identical topology
SUPPORTED_SCHEMA_VERSIONS = (1, 2)

#: suffix a checkpoint directory carries until its rename commit
TMP_SUFFIX = ".tmp"

#: crc32 is computed for top-level files up to this size (the control
#: files are KBs; a custom_checkpoint pkl holding a replay buffer could
#: be huge — size-check only past the cap)
DIGEST_SIZE_LIMIT = 64 * 1024 * 1024

#: the markers orbax's StandardCheckpointer writes into every pytree dir of
#: a JAX-package checkpoint
_ORBAX_METADATA_FILES = ("_METADATA", "_CHECKPOINT_METADATA")


def _crc32(path: Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def build_manifest(ckpt_dir, *, step: Optional[int] = None, iteration: Optional[int] = None,
                   num_processes: int = 1, topology: Optional[dict] = None) -> dict:
    """Walk a fully written checkpoint directory and produce its manifest
    dict. Called by the main process AFTER the all-host barrier, so every
    shard file is on disk. The manifest file itself is excluded."""
    root = Path(ckpt_dir)
    files: dict[str, dict] = {}
    pytree_files: dict[str, int] = {}
    pytree_dirs: list[str] = []
    orbax_metadata: dict[str, bool] = {}

    for entry in sorted(root.iterdir()):
        if entry.name == MANIFEST_NAME:
            continue
        if entry.is_dir():
            pytree_dirs.append(entry.name)
            orbax_metadata[entry.name] = any((entry / m).exists() for m in _ORBAX_METADATA_FILES)
            for sub in sorted(entry.rglob("*")):
                if sub.is_file():
                    pytree_files[sub.relative_to(root).as_posix()] = sub.stat().st_size
        else:
            size = entry.stat().st_size
            rec = {"size": size}
            if size <= DIGEST_SIZE_LIMIT:
                rec["crc32"] = _crc32(entry)
            files[entry.name] = rec

    manifest = {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "step": step,
        "iteration": iteration,
        "num_processes": num_processes,
        "files": files,
        "pytree_files": pytree_files,
        "pytree_dirs": pytree_dirs,
        "orbax_metadata": orbax_metadata,
    }
    if topology is not None:
        manifest["topology"] = topology
    return manifest


def write_manifest(ckpt_dir, manifest: dict) -> str:
    """Durably write the manifest: write + flush + fsync a sibling temp
    file, then ``os.replace`` onto ``commit_success.json`` — a crash
    mid-write must not leave a half-written manifest that *parses* (a
    truncated JSON fails to parse, which verify treats as uncommitted,
    so even the non-fsync'd worst case degrades safely)."""
    path = Path(ckpt_dir) / MANIFEST_NAME
    tmp = path.with_suffix(".json.writing")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return str(path)


def read_manifest(ckpt_dir) -> Optional[dict]:
    """Parse a checkpoint's manifest; ``None`` when missing, unparseable,
    or of an unknown schema version (all three mean: not committed)."""
    path = Path(ckpt_dir) / MANIFEST_NAME
    if not path.is_file():
        return None
    try:
        manifest = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(manifest, dict) or manifest.get("schema_version") not in SUPPORTED_SCHEMA_VERSIONS:
        return None
    return manifest


def verify_manifest(ckpt_dir, *, deep: bool = True) -> list[str]:
    """Check a checkpoint directory against its manifest; returns a list
    of human-readable problems (empty == valid).

    Shallow: manifest present + parseable + known schema. Deep adds:
    every recorded file exists with the exact recorded size, crc32
    matches where recorded, and each pytree dir recorded with orbax
    metadata still carries its marker."""
    root = Path(ckpt_dir)
    if not root.is_dir():
        return [f"not a directory: {root}"]
    manifest = read_manifest(root)
    if manifest is None:
        raw = root / MANIFEST_NAME
        if raw.is_file():
            return [f"manifest unreadable or unknown schema: {raw}"]
        return ["no commit manifest (uncommitted or pre-fault-tolerance checkpoint)"]
    if not deep:
        return []

    problems: list[str] = []
    for name, rec in manifest.get("files", {}).items():
        path = root / name
        if not path.is_file():
            problems.append(f"missing file: {name}")
            continue
        size = path.stat().st_size
        if size != rec.get("size"):
            problems.append(f"size mismatch: {name} is {size}B, manifest says {rec.get('size')}B")
            continue
        if "crc32" in rec and _crc32(path) != rec["crc32"]:
            problems.append(f"crc32 mismatch: {name} is corrupt")
    for rel, size in manifest.get("pytree_files", {}).items():
        path = root / rel
        if not path.is_file():
            problems.append(f"missing pytree file: {rel}")
        elif path.stat().st_size != size:
            problems.append(f"size mismatch: {rel} is {path.stat().st_size}B, manifest says {size}B")
    for d in manifest.get("pytree_dirs", []):
        if not (root / d).is_dir():
            problems.append(f"missing pytree dir: {d}")
        elif manifest.get("orbax_metadata", {}).get(d) and not any(
            (root / d / m).exists() for m in _ORBAX_METADATA_FILES
        ):
            problems.append(f"pytree dir lost its orbax metadata: {d}")
    return problems
