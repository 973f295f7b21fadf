"""Version comparison helpers, as :mod:`accelerate_tpu.utils.versions` has
them, with :func:`is_torch_version` in place of ``is_jax_version``."""

from __future__ import annotations

import importlib.metadata
import operator

_OPS = {
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
    ">=": operator.ge,
    ">": operator.gt,
}


def _parse(version: str) -> tuple:
    parts = []
    for piece in version.split("+")[0].split("."):
        digits = "".join(ch for ch in piece if ch.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def compare_versions(library_or_version, op: str, requirement_version: str) -> bool:
    """Compare an installed library's version (or a literal version string)
    against ``requirement_version`` with operator ``op``."""
    if op not in _OPS:
        raise ValueError(f"operator must be one of {sorted(_OPS)}, got {op!r}")
    if not isinstance(library_or_version, str) or any(c.isalpha() for c in library_or_version.split(".")[0]):
        # a library's name
        library_or_version = importlib.metadata.version(str(library_or_version))
    a, b = _parse(library_or_version), _parse(requirement_version)
    # zero-pad to one length, so (2, 11) == (2, 11, 0)
    n = max(len(a), len(b))
    a += (0,) * (n - len(a))
    b += (0,) * (n - len(b))
    return _OPS[op](a, b)


def is_torch_version(op: str, version: str) -> bool:
    import torch

    return compare_versions(torch.__version__, op, version)
