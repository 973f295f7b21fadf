"""``accelerate_tpu_torch.analysis``: the kernel analyzer (TPU1001-1006).

The port's counterpart of the kernel tier of :mod:`accelerate_tpu.analysis`.
``kernel_check(fn, *sample_args)`` traces ``fn`` on ``meta`` tensors,
records every CUDA launch its kernel wrappers would make (grid, tiles,
index maps, shared memory, aliases, the plain version) and checks each
with the TPU10xx rules re-derived for Hopper (:mod:`.kernel_rules`):
shared memory against the card's per-block maximum, tile alignment,
index-map coverage and cross-block races, alias hazards, and the
registered cost contracts. ``scan_paths`` is the AST registration gate.
The other analysis tiers are not ported (ROADMAP.md).
"""

from .kernelmodel import KernelReport, KernelSite, kernel_check, scan_paths
from .report import exit_code, render_sarif, render_text
from .rules import RULES, Finding, filter_findings
from .selfcheck import run_kernel_selfcheck

__all__ = [
    "RULES",
    "Finding",
    "KernelReport",
    "KernelSite",
    "exit_code",
    "filter_findings",
    "kernel_check",
    "render_sarif",
    "render_text",
    "run_kernel_selfcheck",
    "scan_paths",
]
