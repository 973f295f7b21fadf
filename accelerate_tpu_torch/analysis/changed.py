"""Git-diff-scoped file selection for ``kernel-check --changed``.

The port's copy of :mod:`accelerate_tpu.analysis.changed`:

* diff base = the merge-base with ``origin/main`` (or ``main``) when one
  exists, else ``HEAD~1``, else the empty tree: it works on a branch, on
  main itself, and on a fresh repository's first commit;
* uncommitted work counts (``git diff`` + ``git status`` untracked);
* only existing ``.py`` files are returned.

When git is unavailable or the directory is not a work tree the resolver
returns ``None`` and the caller falls back to its full path set:
``--changed`` degrades to a no-op, never to a silent skip of findings.
"""

from __future__ import annotations

import pathlib
import subprocess
from typing import Optional

_CANDIDATE_BASES = ("origin/main", "main")


def _git(args, cwd) -> Optional[str]:
    try:
        out = subprocess.run(["git", *args], cwd=cwd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def diff_base(repo_root=".") -> Optional[str]:
    """The ref changes are measured against: the merge-base with main when
    it exists and differs from HEAD, else the parent commit."""
    for ref in _CANDIDATE_BASES:
        base = _git(["merge-base", "HEAD", ref], repo_root)
        if base:
            base = base.strip()
            head = _git(["rev-parse", "HEAD"], repo_root)
            if head and base != head.strip():
                return base
    if _git(["rev-parse", "HEAD~1"], repo_root):
        return "HEAD~1"
    return None


def changed_python_files(repo_root=".", base: Optional[str] = None):
    """``.py`` paths touched since ``base`` (committed, staged, unstaged and
    untracked), or ``None`` when git cannot answer."""
    root = pathlib.Path(repo_root)
    if _git(["rev-parse", "--is-inside-work-tree"], root) is None:
        return None
    base = base or diff_base(root)
    names: list = []
    if base is not None:
        committed = _git(["diff", "--name-only", base, "HEAD"], root)
        if committed is None:
            return None
        names.extend(committed.splitlines())
    for args in (["diff", "--name-only", "HEAD"], ["ls-files", "--others", "--exclude-standard"]):
        listed = _git(args, root)
        if listed is not None:
            names.extend(listed.splitlines())
    out = []
    seen = set()
    for name in names:
        name = name.strip()
        if not name.endswith(".py") or name in seen:
            continue
        seen.add(name)
        p = root / name
        if p.exists():
            out.append(str(p))
    return sorted(out)
