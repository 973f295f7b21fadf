"""Rule registry of the port's kernel analyzer: stable IDs, severities,
findings, and ``# tpu-lint: disable=...`` suppression handling.

The port's copy of :mod:`accelerate_tpu.analysis.rules`, kernel tier only
(``TPU1001``-``TPU1006``): the IDs, names, severities and the suppression
syntax are the reference's, so a finding maps to its counterpart. The
summaries say what each rule checks on the card; the TPU constants behind
them (VMEM, the MXU lane and sublane) were derived again for Hopper
(:mod:`.kernel_rules`). Stdlib only.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

ERROR = "error"
WARNING = "warning"

TIER_KERNEL = "kernel"


@dataclass(frozen=True)
class Rule:
    """A registered rule with a stable ID."""

    id: str
    name: str
    severity: str
    tier: str
    summary: str


RULES: dict[str, Rule] = {
    r.id: r
    for r in (
        Rule("TPU1001", "kernel-vmem-overflow", ERROR, TIER_KERNEL,
             "shared memory one block asks for (staged tiles x stages + scratch) exceeds the card's per-block "
             "maximum: the launch is refused"),
        Rule("TPU1002", "kernel-tile-misaligned", WARNING, TIER_KERNEL,
             "tile misaligned to 128-byte rows (a warp's 4-byte loads, one L2 line) or 8-row groups (the "
             "ldmatrix/mma.sync row granule): the padded fraction of every tile is wasted bandwidth"),
        Rule("TPU1003", "kernel-index-map-race-or-gap", ERROR, TIER_KERNEL,
             "the output index maps evaluated over the grid leave an output tile unwritten (garbage) or let two "
             "blocks write one (a race: CUDA blocks run in no order)"),
        Rule("TPU1004", "kernel-alias-hazard", WARNING, TIER_KERNEL,
             "aliased operand whose input and output index maps disagree at some block: a cross-block "
             "read-after-write race"),
        Rule("TPU1005", "unregistered-pallas-call", ERROR, TIER_KERNEL,
             "kernel launch with no registered KernelCostSpec: every analysis above it is blind to its cost"),
        Rule("TPU1006", "kernel-cost-contract-drift", WARNING, TIER_KERNEL,
             "declared KernelCostSpec disagrees with the counted cost (the plain version's operations, the "
             "declared tiles' bytes) beyond tolerance: the contract no longer describes the kernel"),
    )
}


@dataclass
class Finding:
    """One finding, bound to a rule ID (``path``/``line`` absent when the
    launch has no source location)."""

    rule: str
    message: str
    path: Optional[str] = None
    line: Optional[int] = None
    severity: str = field(default="")

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")
        if not self.severity:
            self.severity = RULES[self.rule].severity

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "name": RULES[self.rule].name,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


#: ``# tpu-lint: disable`` silences every rule on that line;
#: ``# tpu-lint: disable=TPU1005,TPU1002`` silences those IDs.
_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable(?:=([A-Za-z0-9_,\s]+))?")


def suppressions_for_line(source_line: str) -> Optional[frozenset]:
    """Rule IDs suppressed on this line: ``None`` without a suppression
    comment, an empty frozenset for a bare ``disable`` (everything), else
    the named IDs."""
    m = _SUPPRESS_RE.search(source_line)
    if m is None:
        return None
    if m.group(1) is None:
        return frozenset()
    return frozenset(part.strip().upper() for part in m.group(1).split(",") if part.strip())


def apply_suppressions(findings: list, source_lines: list) -> list:
    """Drop findings whose source line carries a matching suppression."""
    kept = []
    for f in findings:
        if f.line is not None and 1 <= f.line <= len(source_lines):
            ids = suppressions_for_line(source_lines[f.line - 1])
            if ids is not None and (not ids or f.rule in ids):
                continue
        kept.append(f)
    return kept


def apply_file_suppressions(findings: list) -> list:
    """:func:`apply_suppressions` for findings anchored in files on disk,
    order kept."""
    by_path: dict = {}
    for f in findings:
        if f.path and f.line:
            by_path.setdefault(f.path, []).append(f)
    dropped = set()
    for path, group in by_path.items():
        try:
            with open(path) as fh:
                lines = fh.read().splitlines()
        except OSError:
            continue
        kept = {id(f) for f in apply_suppressions(group, lines)}
        dropped.update(id(f) for f in group if id(f) not in kept)
    return [f for f in findings if id(f) not in dropped]


def filter_findings(findings: list, select=None, ignore=()) -> list:
    """Keep only ``select`` (when given) minus ``ignore`` rule IDs."""
    sel = {s.upper() for s in select} if select else None
    ign = {s.upper() for s in ignore}
    return [f for f in findings if (sel is None or f.rule in sel) and f.rule not in ign]
