"""Kernel model: record every CUDA launch of a traced program and count
what each kernel does.

Counterpart of :mod:`accelerate_tpu.analysis.kernelmodel`. The reference
reads each ``pallas_call`` out of a traced jaxpr; the port traces the
program on ``meta`` tensors (PyTorch's abstract values) inside a
:class:`~accelerate_tpu_torch.kernels.launch.LaunchRecorder`, and every
kernel wrapper records the :class:`~accelerate_tpu_torch.kernels.launch.LaunchSite`
it would launch: the grid and threads a block, each operand's tile,
backing shape, dtype, index map and shared-memory stages, the aliases,
and the plain function that computes what the kernel computes. Nothing
is allocated on a device and no kernel is built.

* :class:`KernelSite`: one recorded launch with its location (the first
  frame outside the wrappers), its operands' tiles (the wrapper's
  :class:`~accelerate_tpu_torch.kernels.launch.TileSpec`, read as it is:
  the counterpart of the reference's ``BlockInfo``), its registered
  :class:`~accelerate_tpu_torch.kernels.contracts.KernelCostSpec` and a
  repeat count (identical launches from one line merge, as a ``scan``'s
  trip count multiplies a site in the reference);
* :func:`counted_cost`: the operations of the site's plain version,
  counted on ``meta`` operands with perfmodel's nominal model, and the
  bytes of every declared tile each block visits: what TPU1006 holds a
  declaration to. ``chip_smoke.py`` holds every kernel to its plain
  version on the card, which closes the loop from count to kernel;
* :func:`smem_occupancy_bytes`: what TPU1001 holds to the card's limit;
* :func:`interpret_probe`: runs the program on small concrete operands,
  CPU tensors (the plain versions) or CUDA tensors (the kernels).

``kernel_check(fn, *sample_args)`` is the entry point; ``scan_paths`` is
the AST registration gate behind ``kernel-check <paths>`` and
``--changed``.
"""

from __future__ import annotations

import ast
import itertools
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..kernels import reference as _reference  # noqa: F401  (registers the tree's contracts)
from ..kernels.contracts import KernelCostSpec, registered_spec
from ..kernels.launch import LaunchRecorder, RecordedLaunch, TileSpec
from ..utils.environment import resolve_device
from .perfmodel import count_flops
from .rules import Finding, apply_file_suppressions, apply_suppressions, filter_findings

#: grids with more blocks than this are not enumerated (TPU1003/1004 skip,
#: the byte count takes one tile an operand a block): the walk stays small
MAX_ENUMERATED_GRID = 4096


def _human(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} PB"


@dataclass
class KernelSite:
    """One recorded launch (or ``count`` identical ones from one line)."""

    kernel_name: str
    location: str  # " (path:line)" or ""
    path: Optional[str] = None
    line: Optional[int] = None
    grid: tuple = ()
    threads: int = 0
    count: int = 1
    in_tiles: list = field(default_factory=list)
    out_tiles: list = field(default_factory=list)
    io_aliases: tuple = ()
    smem_scratch: int = 0
    spec: Optional[KernelCostSpec] = None
    plain: Optional[Callable] = None
    operands: tuple = ()  # the wrapper's operands, on meta

    @property
    def grid_steps(self) -> int:
        """Blocks of the grid (the name the reference's rules use)."""
        out = 1
        for g in self.grid:
            out *= int(g)
        return out

    @property
    def enumerable(self) -> bool:
        return bool(self.grid) and 0 < self.grid_steps <= MAX_ENUMERATED_GRID

    def as_dict(self) -> dict:
        flops, hbm = counted_cost(self)
        return {
            "kernel": self.kernel_name,
            "location": self.location.strip(),
            "grid": [int(g) for g in self.grid],
            "threads": self.threads,
            "count": self.count,
            "registered": self.spec is not None,
            "in_tiles": [_tile_dict(t) for t in self.in_tiles],
            "out_tiles": [_tile_dict(t) for t in self.out_tiles],
            "io_aliases": [list(p) for p in self.io_aliases],
            "smem_occupancy_bytes": smem_occupancy_bytes(self),
            "counted_flops": flops,
            "counted_hbm_bytes": hbm,
        }


def _tile_dict(t: TileSpec) -> dict:
    return {
        "origin": t.name, "tile_shape": list(t.tile), "array_shape": list(t.shape),
        "dtype": str(t.dtype).replace("torch.", ""), "tile_bytes": t.tile_bytes, "stages": t.stages,
    }


# -- extraction -------------------------------------------------------------


def to_meta(tree):
    """Every tensor of ``tree`` as an empty ``meta`` tensor of its shape and
    dtype (requiring a gradient where it did)."""

    def meta(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty(t.shape, dtype=t.dtype, device="meta").requires_grad_(t.requires_grad)

    return pytree.tree_map(meta, tree)


def _site_from_launch(rec: RecordedLaunch) -> KernelSite:
    s = rec.site
    return KernelSite(
        kernel_name=s.kernel,
        location=f" ({rec.path}:{rec.line})" if rec.path else "",
        path=rec.path,
        line=rec.line,
        grid=tuple(int(g) for g in s.grid),
        threads=int(s.threads),
        in_tiles=list(s.ins),
        out_tiles=list(s.outs),
        io_aliases=tuple(tuple(p) for p in s.aliases),
        smem_scratch=int(s.smem_scratch),
        spec=registered_spec(s.kernel),
        plain=s.plain,
        operands=tuple(s.operands),
    )


def _site_key(site: KernelSite) -> tuple:
    def tiles(ts):
        return tuple((t.name, tuple(t.tile), tuple(t.shape), t.dtype, t.stages) for t in ts)

    operands = tuple((tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor) else repr(o) for o in site.operands)
    return (site.kernel_name, site.path, site.line, site.grid, site.threads, tiles(site.in_tiles),
            tiles(site.out_tiles), site.io_aliases, site.smem_scratch, operands)


def extract_kernel_sites(fn, sample_args: Sequence) -> list:
    """Every launch ``fn(*sample_args)`` makes, traced on ``meta`` copies
    of the sample arguments, in program order; identical launches from one
    line merge into one site with a count."""
    with LaunchRecorder() as rec:
        fn(*to_meta(tuple(sample_args)))
    sites: list = []
    by_key: dict = {}
    for launch in rec.launches:
        site = _site_from_launch(launch)
        key = _site_key(site)
        if key in by_key:
            by_key[key].count += 1
        else:
            by_key[key] = site
            sites.append(site)
    return sites


# -- the counted cost (what TPU1006 holds declarations to) -------------------


def tile_visits(tile: TileSpec, site: KernelSite) -> list:
    """``[(block, [tile index, ...]), ...]`` over every block of the grid."""
    blocks = itertools.product(*(range(int(g)) for g in site.grid))
    return [(block, tile.tiles_of(block)) for block in blocks]


def counted_cost(site: KernelSite) -> tuple:
    """``(flops, hbm_bytes)`` of every launch the site stands for: the
    plain version's nominal operations on the site's operands, and every
    declared tile's bytes once for each time a block visits it (a tile a
    block revisits is counted again: the naive bound a contract must also
    price). A site that declares no tiles counts no bytes."""
    flops = count_flops(site.plain, *site.operands) if site.plain is not None else 0
    hbm = 0
    for tile in site.in_tiles + site.out_tiles:
        if tile.index_map is not None and site.enumerable:
            hbm += tile.tile_bytes * sum(len(v) for _, v in tile_visits(tile, site))
        else:
            hbm += tile.tile_bytes * site.grid_steps
    return flops * site.count, hbm * site.count


def smem_occupancy_bytes(site: KernelSite) -> int:
    """The shared memory one block asks for, as TPU1001 models it: every
    staged tile times its stages, plus the declared scratch."""
    return sum(t.tile_bytes * t.stages for t in site.in_tiles + site.out_tiles) + site.smem_scratch


# -- report + entry point ---------------------------------------------------


@dataclass
class KernelReport:
    """Everything ``kernel_check`` learns about one function."""

    fn_name: str
    generation: str = "h100"
    smem_capacity_bytes: int = 0
    sites: list = field(default_factory=list)
    findings: list = field(default_factory=list)
    interpret_probe: str = "skipped"

    @property
    def ok(self) -> bool:
        return not any(f.is_error for f in self.findings)

    def as_dict(self) -> dict:
        return {
            "fn": self.fn_name,
            "generation": self.generation,
            "smem_capacity_bytes": self.smem_capacity_bytes,
            "interpret_probe": self.interpret_probe,
            "sites": [s.as_dict() for s in self.sites],
            "findings": [f.as_dict() for f in self.findings],
        }

    def render_text(self) -> str:
        lines = [
            f"kernel-check: {self.fn_name} — {len(self.sites)} launch site"
            f"{'s' if len(self.sites) != 1 else ''}, {self.generation} shared memory "
            f"{_human(self.smem_capacity_bytes)}/block"
        ]
        for s in self.sites:
            flops, hbm = counted_cost(s)
            reg = "registered" if s.spec is not None else "UNREGISTERED"
            count = f" x{s.count}" if s.count > 1 else ""
            lines.append(
                f"  {s.kernel_name}{count} grid={'x'.join(str(g) for g in s.grid) or '1'} threads={s.threads}"
                f" [{reg}]{s.location}"
            )
            lines.append(
                f"    shared memory {_human(smem_occupancy_bytes(s))} (staged tiles x stages + scratch)"
                f"  counted {flops / 1e6:.2f} MFLOP, {_human(hbm)} hbm"
            )
            if s.spec is not None:
                try:
                    lines.append(
                        f"    declared {float(s.spec.flops(*s.operands)) / 1e6:.2f} MFLOP, "
                        f"{_human(s.spec.hbm_bytes(*s.operands))} hbm, "
                        f"shared memory {_human(s.spec.smem_bytes(*s.operands))}"
                    )
                except Exception as e:  # a broken spec is reported (TPU1006), not fatal
                    lines.append(f"    declared: spec raised {type(e).__name__}: {e}")
        lines.append(f"  interpret probe: {self.interpret_probe}")
        if self.findings:
            from .report import format_finding

            lines.append("  findings:")
            lines.extend(f"    {format_finding(f)}" for f in self.findings)
        else:
            lines.append("  findings: none")
        return "\n".join(lines)


def _materialize_tiny(sample_args, device: torch.device):
    """Deterministic concrete tensors of the sample arguments' shapes and
    dtypes on ``device``, made with numpy from seed 0."""
    rng = np.random.default_rng(0)

    def concrete(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = tuple(t.shape)
        if t.dtype.is_floating_point:
            arr = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        elif t.dtype == torch.bool:
            arr = np.zeros(shape, np.bool_)
        else:
            arr = rng.integers(0, 8, size=shape).astype(np.int64)
        return torch.from_numpy(arr).to(device=device, dtype=t.dtype)

    return pytree.tree_map(concrete, tuple(sample_args))


def interpret_probe(fn, sample_args, sites: Sequence, device: torch.device) -> str:
    """Run ``fn`` on concrete operands on ``device`` and report whether its
    floating outputs are finite: on the CPU the wrappers compute their
    plain versions, on the card they launch their kernels. Non-fatal by
    design: a probe that cannot run (a launch the card refuses) reports
    why instead of failing the check."""
    if not sites:
        return "skipped (no kernel launches)"
    try:
        out = fn(*_materialize_tiny(sample_args, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        bad = sum(
            int((~torch.isfinite(t)).sum())
            for t in pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.is_floating_point()
        )
    except Exception as e:  # the probe's boundary: report, never raise
        return f"failed on {device.type}: {type(e).__name__}: {e}"
    if bad:
        return f"ran on {device.type}: {bad} non-finite output element(s)"
    return f"ran on {device.type}: outputs finite"


def kernel_check(
    fn,
    *sample_args: Any,
    generation: Optional[str] = None,
    select: Optional[Sequence[str]] = None,
    ignore: Sequence[str] = (),
    probe: bool = True,
    device=None,
) -> KernelReport:
    """Trace ``fn(*sample_args)`` on ``meta`` tensors and return a
    :class:`KernelReport`: every launch site, the TPU1001-1006 findings and,
    with ``probe``, the outcome of running ``fn`` on concrete operands on
    ``device`` (the card unless ``"cpu"`` is asked for). Sample arguments
    are tensors of any device (only their shapes and dtypes are read), or
    trees of them. ``generation=None`` judges against the attached card's
    own shared memory, and the H100 row without a card."""
    from .costmodel import DEFAULT_GENERATION, device_generation, smem_bytes

    probe_device = resolve_device(device) if probe else None
    capacity = smem_bytes(generation)
    if generation is None:
        generation = device_generation() or DEFAULT_GENERATION
    report = KernelReport(
        fn_name=getattr(fn, "__name__", "step_fn"), generation=generation, smem_capacity_bytes=capacity
    )
    report.sites = extract_kernel_sites(fn, sample_args)
    from .kernel_rules import check_kernel_rules

    findings = check_kernel_rules(report.sites, generation=generation, capacity=capacity)
    if probe:
        report.interpret_probe = interpret_probe(fn, sample_args, report.sites, probe_device)
    report.findings = filter_findings(apply_file_suppressions(findings), select=select, ignore=ignore)
    return report


# -- AST registration gate (paths mode / --changed) -------------------------


def _is_load(node) -> bool:
    """``load("<source>")`` or ``<module>.load("<source>")``."""
    if not isinstance(node, ast.Call) or not node.args:
        return False
    func = node.func
    name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
    first = node.args[0]
    return name == "load" and isinstance(first, ast.Constant) and isinstance(first.value, str)


def scan_paths(paths: Sequence[str]) -> list:
    """AST scan for unregistered launches (TPU1005) in ``paths`` (files or
    directories): after ``lib = load("<source>")``, every ``lib.<entry>(...)``
    call must name an entry with a registered contract, unless its line
    suppresses the rule. The cheap gate ``--changed`` scopes; the traced
    :func:`kernel_check` proves a contract right. The scan imports nothing
    it scans: the tree's contracts are registered by its own imports."""
    files: list = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    kept: list = []
    for path in sorted(set(files)):
        try:
            with open(path) as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError):
            continue
        libs = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and _is_load(node.value):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        libs[target.id] = node.value.args[0].value
        findings = []
        for node in ast.walk(tree):
            func = getattr(node, "func", None) if isinstance(node, ast.Call) else None
            if not (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) and func.value.id in libs):
                continue
            if registered_spec(func.attr) is not None:
                continue
            findings.append(
                Finding(
                    "TPU1005",
                    f"launch of `{func.attr}` (from `{libs[func.value.id]}`) has no registered KernelCostSpec — "
                    "every analysis above it prices it at zero; register a contract with "
                    "accelerate_tpu_torch.kernels.contracts.kernel_cost",
                    path=path,
                    line=node.lineno,
                )
            )
        kept.extend(apply_suppressions(findings, src.splitlines()))
    return kept
