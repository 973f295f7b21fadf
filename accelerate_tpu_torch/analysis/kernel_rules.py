"""TPU10xx: the kernel rules over recorded launch sites, re-derived for Hopper.

Counterpart of :mod:`accelerate_tpu.analysis.kernel_rules`. The rule IDs,
severities and suppression syntax are the reference's; the TPU constants
behind them are not, and two rules read the card's execution model:

* ``TPU1001`` (error): shared-memory occupancy. A block's occupancy is
  every staged tile's bytes times its stages plus the kernel's declared
  scratch; it must fit the card's per-block maximum (the attached card's
  own, or the H100's 232,448 bytes of
  :data:`~accelerate_tpu_torch.analysis.costmodel.SMEM_BYTES_TABLE`), or
  the launch is refused. This replaces
  the reference's VMEM occupancy (every block double-buffered while the
  grid pipelines) against ``VMEM_KB_TABLE``: on the card the kernel, not
  a pipeline, decides how many stages a tile has, so it declares them.
* ``TPU1002`` (warning): tile alignment. A tile's innermost extent in
  bytes is padded to 128 bytes (32 threads' 4-byte loads; one L2 line)
  and its next dimension to 8 rows (the ``ldmatrix``/``mma.sync`` row
  granule), where the reference pads to the 128-wide MXU lane and the
  dtype's VPU sublane. The waste of every tile is priced: an (8, 100) f32
  tile is 400 bytes padded to 512, 22%, the reference's figure too.
* ``TPU1003`` (error): coverage and races, proven by evaluating every
  output index map at every block. An output tile no block writes is
  garbage. On the card *any* output tile two blocks write is a race: CUDA
  blocks run in no order. The reference lets a tile be revisited by
  consecutive grid steps (its accumulation pattern), which assumes the
  TPU's sequential grid; the port's accumulations loop inside one block
  instead. So a map that pins every block to one tile fires twice here
  (the gap and the race) where the reference fires once (the gap).
* ``TPU1004`` (warning): alias hazard. An aliased operand whose input and
  output maps disagree at some block reads a tile another block may
  already have overwritten: a cross-block read-after-write race. The same
  check as the reference's.
* ``TPU1005`` (error): a launch with no registered
  :class:`~accelerate_tpu_torch.kernels.contracts.KernelCostSpec`.
* ``TPU1006`` (warning): contract drift. The declared FLOPs and bytes
  against the counted ones (the plain version's operations, the declared
  tiles' bytes) beyond the spec's tolerance; the same comparison as the
  reference's.

Rules that need tiles or index maps skip a site that declares none, as
the reference skips dynamic index maps.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

from .kernelmodel import KernelSite, _human, counted_cost, smem_occupancy_bytes, tile_visits
from .rules import Finding

#: bytes an innermost tile extent pads to: 32 threads x 4-byte loads, one L2 line
ROW_BYTES = 128
#: rows the next dimension pads to: the ldmatrix / mma.sync row granule
ROW_GROUP = 8


def _anchor(site: KernelSite) -> dict:
    return {"path": site.path, "line": site.line}


def check_smem_overflow(site: KernelSite, generation: str, cap: int) -> list:
    """TPU1001: a block's shared memory must fit the card's per-block
    maximum, ``cap`` bytes."""
    occ = smem_occupancy_bytes(site)
    if occ <= cap:
        return []
    return [
        Finding(
            "TPU1001",
            f"kernel `{site.kernel_name}`{site.location}: shared memory {_human(occ)} a block (staged tiles x "
            f"stages + scratch) exceeds {generation}'s {cap:,} bytes a block — {occ / cap:.1f}x over; the launch "
            "is refused: shrink the tiles or stage them fewer times",
            **_anchor(site),
        )
    ]


def _pad_up(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def check_tile_alignment(site: KernelSite) -> list:
    """TPU1002: innermost extent in 128-byte rows, the next in 8-row groups."""
    findings = []
    for tile in site.in_tiles + site.out_tiles:
        dims = [int(d) for d in tile.tile]
        if not dims or tile.tile_bytes == 0:
            continue
        inner = _pad_up(dims[-1] * tile.itemsize, ROW_BYTES) // tile.itemsize
        rows = _pad_up(dims[-2], ROW_GROUP) if len(dims) > 1 else None
        if inner == dims[-1] and (rows is None or rows == dims[-2]):
            continue
        numel = tile.tile_bytes // tile.itemsize
        padded = numel // dims[-1] * inner
        if rows is not None:
            padded = padded // dims[-2] * rows
        waste = 1.0 - numel / padded
        shape = (rows, inner) if rows is not None else (inner,)
        findings.append(
            Finding(
                "TPU1002",
                f"kernel `{site.kernel_name}`{site.location}: tile {tile.name} {tuple(dims)} "
                f"{str(tile.dtype).replace('torch.', '')} misaligned to {ROW_BYTES}-byte rows in "
                f"{ROW_GROUP}-row groups — padded to {shape} trailing dims, {waste:.0%} of every tile is wasted "
                "bandwidth",
                **_anchor(site),
            )
        )
    return findings


def check_index_map_coverage(site: KernelSite) -> list:
    """TPU1003: every output tile written by exactly one block."""
    if not site.enumerable:
        return []
    findings = []
    for tile in site.out_tiles:
        if tile.index_map is None:
            continue
        expected = set(itertools.product(*(range(n) for n in tile.tiles_per_dim())))
        writers: dict = {}
        for block, visited in tile_visits(tile, site):
            for idx in visited:
                writers.setdefault(idx, [])
                if block not in writers[idx]:
                    writers[idx].append(block)
        uncovered = sorted(expected - set(writers))
        if uncovered:
            sample = ", ".join(str(u) for u in uncovered[:3])
            findings.append(
                Finding(
                    "TPU1003",
                    f"kernel `{site.kernel_name}`{site.location}: output {tile.name} index map leaves "
                    f"{len(uncovered)} of {len(expected)} output tile(s) unwritten (e.g. {sample}) — those regions "
                    "are garbage; the map must cover ceil(shape/tile) on every dim",
                    **_anchor(site),
                )
            )
        races = {idx: blocks for idx, blocks in writers.items() if len(blocks) > 1}
        if races:
            idx, blocks = sorted(races.items())[0]
            findings.append(
                Finding(
                    "TPU1003",
                    f"kernel `{site.kernel_name}`{site.location}: output tile {idx} is written by blocks "
                    f"{blocks[:4]} — a write race: CUDA blocks run in no order; give each output tile one block "
                    "and accumulate inside it",
                    **_anchor(site),
                )
            )
    return findings


def check_alias_hazard(site: KernelSite) -> list:
    """TPU1004: an aliased operand's input and output maps agree at every block."""
    if not site.enumerable or not site.io_aliases:
        return []
    findings = []
    for in_idx, out_idx in site.io_aliases:
        if in_idx >= len(site.in_tiles) or out_idx >= len(site.out_tiles):
            continue
        src, dst = site.in_tiles[in_idx], site.out_tiles[out_idx]
        if src.index_map is None or dst.index_map is None:
            continue
        for (block, reads), (_, writes) in zip(tile_visits(src, site), tile_visits(dst, site)):
            if reads != writes:
                step = block[0] if len(block) == 1 else block
                findings.append(
                    Finding(
                        "TPU1004",
                        f"kernel `{site.kernel_name}`{site.location}: operand {in_idx} is aliased to output "
                        f"{out_idx} but their index maps disagree at block {step} (reads tile "
                        f"{', '.join(map(str, reads))}, writes tile {', '.join(map(str, writes))}) — another block "
                        "may already have overwritten what it reads: aliased operands need identical maps",
                        **_anchor(site),
                    )
                )
                break
    return findings


def check_unregistered(site: KernelSite) -> list:
    """TPU1005: every launch of a checked program carries a contract."""
    if site.spec is not None:
        return []
    return [
        Finding(
            "TPU1005",
            f"launch of `{site.kernel_name}`{site.location} has no registered KernelCostSpec — every analysis "
            "above it prices it at zero; register a contract with accelerate_tpu_torch.kernels.contracts.kernel_cost",
            **_anchor(site),
        )
    ]


def check_cost_drift(site: KernelSite) -> list:
    """TPU1006: the declaration agrees with the counted cost."""
    spec = site.spec
    if spec is None or site.plain is None:
        return []
    counted_flops, counted_hbm = counted_cost(site)
    try:
        declared_flops = float(spec.flops(*site.operands)) * site.count
        declared_hbm = float(spec.hbm_bytes(*site.operands)) * site.count
    except Exception as e:  # a contract that cannot price the call is itself the finding
        return [
            Finding(
                "TPU1006",
                f"kernel `{site.kernel_name}`{site.location}: registered KernelCostSpec raised "
                f"{type(e).__name__}: {e} on these operands — the contract cannot price this launch",
                **_anchor(site),
            )
        ]
    checks = [("FLOPs", declared_flops, counted_flops)]
    if site.in_tiles or site.out_tiles:  # bytes are counted from declared tiles only
        checks.append(("HBM bytes", declared_hbm, counted_hbm))
    findings = []
    for label, declared, counted in checks:
        rel = abs(declared - counted) / max(float(counted), 1.0)
        if rel > spec.tolerance:
            findings.append(
                Finding(
                    "TPU1006",
                    f"kernel `{site.kernel_name}`{site.location}: declared {label} {declared:.4g} vs counted "
                    f"{counted:.4g} — {rel:.0%} drift (tolerance {spec.tolerance:.0%}); the contract no longer "
                    "describes the kernel",
                    **_anchor(site),
                )
            )
    return findings


def check_kernel_rules(sites: Sequence, *, generation: str = "h100", capacity: Optional[int] = None) -> list:
    """All six TPU10xx rules over every site, in program order; ``capacity``
    (bytes of shared memory a block may ask for) defaults to
    ``generation``'s row."""
    from .costmodel import smem_bytes

    cap = smem_bytes(generation) if capacity is None else capacity
    findings: list = []
    for site in sites:
        findings += check_smem_overflow(site, generation, cap)
        findings += check_tile_alignment(site)
        findings += check_index_map_coverage(site)
        findings += check_alias_hazard(site)
        findings += check_unregistered(site)
        findings += check_cost_drift(site)
    return findings
