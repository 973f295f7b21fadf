"""Checkpoint discovery, verification, recovery, GC, and pruning.

Counterpart of :mod:`accelerate_tpu.ft.manager`, with the same semantics.

Operates on the directory layout ``save_accelerator_state`` produces
under ``{project_dir}/checkpoints/``::

    checkpoints/
      checkpoint_0/                 # committed (has commit_success.json)
      checkpoint_1/
      checkpoint_2.tmp/             # in-flight, crashed, or recoverable

The invariants this module maintains:

* discovery (``latest`` / ``all_valid``) never returns an uncommitted or
  manifest-failing directory;
* a ``.tmp`` dir whose manifest IS valid was fully written and committed
  — only the final rename was lost — so ``gc()`` finishes the rename
  instead of deleting data;
* ``prune`` keeps the newest ``total_limit`` checkpoints and NEVER
  removes a protected path (the checkpoint a run resumed from, the one
  it just wrote) — so no code path can delete the last valid checkpoint
  before a newer one has committed.
"""

from __future__ import annotations

import logging
import re
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

from .manifest import TMP_SUFFIX, read_manifest, verify_manifest

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")


def checkpoint_index(path) -> Optional[int]:
    """``checkpoint_7`` -> 7 (also accepts ``checkpoint_7.tmp``); ``None``
    for anything else."""
    name = Path(path).name
    if name.endswith(TMP_SUFFIX):
        name = name[: -len(TMP_SUFFIX)]
    m = _CKPT_RE.match(name)
    return int(m.group(1)) if m else None


@dataclass
class VerifyResult:
    """Outcome of :meth:`CheckpointManager.verify` for one directory."""

    path: str
    ok: bool
    problems: list = field(default_factory=list)
    manifest: Optional[dict] = None


class CheckpointManager:
    """Manage the ``checkpoint_N`` family under one base directory.

    ``Accelerator.load_state(input_dir=None)`` uses ``latest()``
    for auto-resume. The manager holds no state beyond ``base_dir`` —
    every call re-reads the filesystem, so it stays correct under
    concurrent writers."""

    def __init__(self, base_dir):
        self.base_dir = Path(base_dir)

    # ------------------------------------------------------------------ #
    # discovery
    # ------------------------------------------------------------------ #

    def all_checkpoints(self) -> list[Path]:
        """Committed-named (no ``.tmp``) checkpoint dirs, oldest first.
        Makes no validity claim — see :meth:`all_valid`."""
        if not self.base_dir.is_dir():
            return []
        out = [
            d for d in self.base_dir.iterdir()
            if d.is_dir() and not d.name.endswith(TMP_SUFFIX) and checkpoint_index(d) is not None
        ]
        return sorted(out, key=checkpoint_index)

    def tmp_dirs(self) -> list[Path]:
        """``checkpoint_N.tmp`` leftovers, oldest first."""
        if not self.base_dir.is_dir():
            return []
        out = [
            d for d in self.base_dir.iterdir()
            if d.is_dir() and d.name.endswith(TMP_SUFFIX) and checkpoint_index(d) is not None
        ]
        return sorted(out, key=checkpoint_index)

    def all_valid(self, deep: bool = False) -> list[Path]:
        """Committed checkpoints whose manifest verifies, oldest first."""
        return [d for d in self.all_checkpoints() if self.verify(d, deep=deep).ok]

    def latest(self, deep: bool = True) -> Optional[Path]:
        """The newest VALID checkpoint, walking back past corrupt or
        uncommitted ones (a truncated newest checkpoint must not block
        resume from the one before it)."""
        for d in reversed(self.all_checkpoints()):
            result = self.verify(d, deep=deep)
            if result.ok:
                return d
            logger.warning(f"skipping invalid checkpoint {d.name}: {result.problems[:3]}")
        return None

    # ------------------------------------------------------------------ #
    # integrity
    # ------------------------------------------------------------------ #

    def verify(self, path=None, deep: bool = True) -> VerifyResult:
        """Deep integrity check of one checkpoint dir (default: the
        newest committed one)."""
        if path is None:
            ckpts = self.all_checkpoints()
            if not ckpts:
                return VerifyResult(str(self.base_dir), False, ["no checkpoints found"])
            path = ckpts[-1]
        problems = verify_manifest(path, deep=deep)
        return VerifyResult(str(path), not problems, problems, manifest=read_manifest(path))


    # ------------------------------------------------------------------ #
    # recovery / GC / pruning
    # ------------------------------------------------------------------ #

    def recover(self) -> list[Path]:
        """Finish interrupted renames: a ``checkpoint_N.tmp`` whose
        manifest deep-verifies was fully committed (the manifest is only
        ever written after the all-host barrier) — rename it to
        ``checkpoint_N`` unless that name already exists. Returns the
        recovered paths."""
        recovered = []
        for tmp in self.tmp_dirs():
            final = tmp.with_name(tmp.name[: -len(TMP_SUFFIX)])
            if final.exists():
                continue  # a committed twin exists; the tmp is garbage
            if not verify_manifest(tmp, deep=True):
                tmp.rename(final)
                logger.info(f"recovered committed checkpoint from interrupted rename: {final.name}")
                recovered.append(final)
        return recovered

    def gc(self, dry_run: bool = False) -> dict:
        """Garbage-collect: first :meth:`recover` committed ``.tmp`` dirs,
        then delete the rest (partial writes from crashed or failed
        saves). Never touches a committed-named directory. Returns
        ``{"recovered": [...], "removed": [...]}`` of the ``.tmp`` names."""
        recoverable = {
            t for t in self.tmp_dirs()
            if not t.with_name(t.name[: -len(TMP_SUFFIX)]).exists()
            and not verify_manifest(t, deep=True)
        }
        report = {
            "recovered": sorted(t.name for t in recoverable),
            "removed": sorted(t.name for t in self.tmp_dirs() if t not in recoverable),
        }
        if not dry_run:
            self.recover()
            for tmp in self.tmp_dirs():
                shutil.rmtree(tmp, ignore_errors=True)
        return report

    def prune(self, total_limit: Optional[int], protect: Iterable = ()) -> list[Path]:
        """Delete the oldest committed checkpoints beyond ``total_limit``,
        never touching ``protect``-ed paths (resolved for comparison).
        Runs strictly AFTER a new checkpoint commits — callers must not
        invoke this with a save in flight. Returns the removed paths."""
        if not total_limit or total_limit < 1:
            return []
        protected = {Path(p).resolve() for p in protect}
        ckpts = self.all_checkpoints()
        removed = []
        from .crashpoints import crash_point

        for victim in ckpts[:-total_limit] if len(ckpts) > total_limit else []:
            if victim.resolve() in protected:
                continue
            crash_point("mid_prune")
            shutil.rmtree(victim, ignore_errors=True)
            removed.append(victim)
        return removed
