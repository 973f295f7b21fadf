"""The kernel analyzer's selfcheck: every TPU10xx rule fires on its seeded
defect, every clean twin stays silent, and the cost model matches a
hand-computed reference exactly.

The port's copy of the kernel part of
:mod:`accelerate_tpu.analysis.selfcheck` (``_kernel_fixtures``,
``_kernel_clean_fixtures``, ``_kernel_reference``,
``run_kernel_selfcheck``). The six fixtures declare the reference's
defective launches (grid, tiles, index maps, alias) on the port's K8
kernels (:mod:`~accelerate_tpu_torch.kernels.fixtures`); the clean twins
are the port's K6 and K7 (:mod:`~accelerate_tpu_torch.kernels.reference`).
Everything here traces on ``meta`` tensors: no kernel runs (``chip_smoke.py``
runs the fixtures on the card).
"""

from __future__ import annotations

import torch

#: (1024, 512) f32 for the shared-memory hog, (16, 100) for the ragged tile, (16, 128) for the rest
_BIG, _RAGGED, _TILE = (1024, 512), (16, 100), (16, 128)


def _meta(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _kernel_fixtures():
    """``(rule -> (fn, sample_args), the name of TPU1006's kernel)``: the
    seeded TPU10xx defects, each on a grid of two blocks."""
    from ..kernels.fixtures import tile_add, tile_copy, tile_scale

    def vmem_hog(x):
        # (512, 512) f32 tiles in and out, each staged twice: 4 MiB a block,
        # 18x the 232,448 bytes an H100 block may ask for
        return tile_copy(x, tile=(512, 512), grid=(2,), in_map=lambda i: (i, 0), out_map=lambda i: (i, 0))

    def ragged_tile(x):
        # 100 f32 is 400 bytes, padded to 512: 22% of every tile wasted
        return tile_copy(x, tile=(8, 100), grid=(2,), in_map=lambda i: (i, 0), out_map=lambda i: (i, 0))

    def gapped_map(x, out=None):
        # the out map pins both blocks to tile (0, 0): tile (1, 0) is never
        # written (garbage), and tile (0, 0) is written by two blocks (a race)
        return tile_copy(x, tile=(8, 128), grid=(2,), in_map=lambda i: (i, 0), out_map=lambda i: (0, 0), out=out)

    def hazardous_alias(a, d):
        # operand 0 is aliased to the output but read at tile (0, 0) while
        # block i writes tile (i, 0): block 1 may read what block 0 wrote
        return tile_add(a, d, tile=(8, 128), grid=(2,), a_map=lambda i: (0, 0), d_map=lambda i: (i, 0),
                        out_map=lambda i: (i, 0), alias=True)

    def unregistered_call(x):
        return tile_copy(x, tile=(8, 128), grid=(2,), in_map=lambda i: (i, 0), out_map=lambda i: (i, 0))

    def drifting_call(x):
        # one multiply an element (2,048 FLOPs counted); the selfcheck
        # registers the reference's contract, 3 x 2 FLOPs an element (6x)
        return tile_scale(x, tile=(8, 128), grid=(2,), in_map=lambda i: (i, 0), out_map=lambda i: (i, 0))

    return {
        "TPU1001": (vmem_hog, (_meta(_BIG),)),
        "TPU1002": (ragged_tile, (_meta(_RAGGED),)),
        "TPU1003": (gapped_map, (_meta(_TILE),)),
        "TPU1004": (hazardous_alias, (_meta(_TILE), _meta(_TILE))),
        "TPU1005": (unregistered_call, (_meta(_TILE),)),
        "TPU1006": (drifting_call, (_meta(_TILE),)),
    }, "tile_scale"


def _kernel_clean_fixtures():
    """The clean twin of each rule: the port's K6 and K7, whose shared
    memory fits, tiles align, maps cover, aliases agree and contracts match
    the counted cost: zero findings."""
    from ..kernels.reference import block_accumulate, block_matmul_softmax

    def clean_softmax(x, w):
        return block_matmul_softmax(x, w)

    def clean_accumulate(a, d):
        return block_accumulate(a, d)

    softmax = (clean_softmax, (_meta((16, 128)), _meta((128, 128))))
    accumulate = (clean_accumulate, (_meta(_TILE), _meta(_TILE)))
    return {
        "TPU1001": softmax,
        "TPU1002": softmax,
        "TPU1003": softmax,
        "TPU1004": accumulate,  # aliased in place, maps agree: the legal twin
        "TPU1005": softmax,
        "TPU1006": softmax,
    }


def _kernel_reference() -> tuple:
    """The executable spec of the kernel cost math: K6 at (16, 128) @
    (128, 128), 8-row blocks, whose shared memory, counted FLOPs and bytes
    and declared cost are hand-computed here and must match extraction
    exactly, with zero findings; and its plain version against the softmax
    of the product. (The reference also holds perfmodel's roofline to the
    declaration; the roofline walk is not ported.)"""
    from ..kernels.reference import block_matmul_softmax
    from .kernelmodel import counted_cost, kernel_check, smem_occupancy_bytes

    B, D, N = 16, 128, 128

    def decode_step(x, w):
        return block_matmul_softmax(x, w)

    report = kernel_check(decode_step, _meta((B, D)), _meta((D, N)), probe=False)
    site = report.sites[0] if report.sites else None
    # hand: the logits block's dynamic shared memory in f32: 4 ring stages, each 32 contraction rows of w
    # (128 columns x 4 bytes + 16 of padding) and the 8 x 32 block of x (128 bytes + 16 a row); the logits
    # tile 8 x 132 f32; 8 rows x 4 warps of reductions; the join's flag (16 bytes)
    want_occ = 4 * (32 * 528 + 8 * 144) + 8 * 132 * 4 + 8 * 4 * 4 + 16  # = 76,560
    # hand: 2 B D N + 14 B N = 524,288 + 28,672 = 552,960 FLOPs (the reference's);
    # bytes: grid (2, 1, 1), one split (D = 128 is 4 stages of 32 rows, the least a split streams):
    # 2 blocks x (x tile 8 x 128 + w tile 128 x 128 + out tile 8 x 128) x 4 B = 147,456
    want_cost = (2 * B * D * N + 14 * B * N, 2 * (8 * D + D * 128 + 8 * 128) * 4)
    # hand, what the contract declares: w once per 8 rows + x once per 128-column tile + the
    # logits written, reread and rewritten + the tile maxima and sums: 164,096 B
    want_declared_hbm = (B // 8) * D * N * 4 + 1 * B * D * 4 + 3 * B * N * 4 + 2 * B * 1 * 4 * 2
    counted = counted_cost(site) if site else (0, 0)
    declared = (
        (int(site.spec.flops(*site.operands)), int(site.spec.hbm_bytes(*site.operands)),
         int(site.spec.smem_bytes(*site.operands)))
        if site and site.spec
        else (0, 0, 0)
    )
    gen = torch.Generator().manual_seed(0)
    xs, ws = torch.randn(B, D, generator=gen), torch.randn(D, N, generator=gen) / D**0.5
    parity = torch.allclose(block_matmul_softmax(xs, ws), torch.softmax(xs @ ws, dim=-1), rtol=0, atol=1e-6)
    checks = [
        ("one registered site", site is not None and site.spec is not None),
        (f"occupancy == {want_occ}", site is not None and smem_occupancy_bytes(site) == want_occ),
        (f"counted == {want_cost}", counted == want_cost),
        ("declared flops == counted, smem == occupancy",
         declared[0] == want_cost[0] and declared[2] == want_occ),
        (f"declared hbm == {want_declared_hbm}, within tolerance of counted", declared[1] == want_declared_hbm
         and site is not None and abs(declared[1] - counted[1]) <= site.spec.tolerance * counted[1]),
        ("zero findings", not report.findings),
        ("f32 plain version within 1e-6 of softmax(x @ w)", parity),
    ]
    ok = all(passed for _, passed in checks)
    lines = [
        f"[kernel selfcheck] cost reference ({B}x{D}@{D}x{N} softmax, 8-row blocks): "
        + ("exact" if ok else "MISMATCH: " + ", ".join(name for name, passed in checks if not passed))
    ]
    return ok, lines


def drift_contract(name: str):
    """TPU1006's fixture contract for kernel ``name``, the reference's: 3 x
    2 FLOPs an element against the one multiply counted, the bytes declared
    exactly (so only the FLOPs drift fires)."""
    from ..kernels.contracts import KernelCostSpec

    return KernelCostSpec(
        name=name,
        flops=lambda x: float(3 * 2 * x.shape[0] * x.shape[1]),
        hbm_bytes=lambda x: float(2 * x.shape[0] * x.shape[1] * 4),
        smem_bytes=lambda x: 0.0,
        notes="selfcheck fixture: deliberately mis-declared FLOPs",
    )


def run_kernel_selfcheck() -> tuple:
    """Prove TPU1001-TPU1006 each fire on their seeded defect, each clean
    twin yields zero findings, and the cost math matches the hand-computed
    reference exactly. Returns ``(ok, report lines)``."""
    from ..kernels.contracts import register_kernel_cost, unregister_kernel_cost
    from .kernelmodel import kernel_check

    lines: list = []
    ok = True
    fixtures, drifty_kernel = _kernel_fixtures()
    clean = _kernel_clean_fixtures()
    register_kernel_cost(drift_contract(drifty_kernel))
    try:
        for rule, (fn, args) in sorted(fixtures.items()):
            report = kernel_check(fn, *args, select=(rule,), probe=False)
            fired = any(f.rule == rule for f in report.findings)
            ok &= fired
            lines.append(f"[kernel selfcheck] {rule} fixture: {'detected' if fired else 'MISSED'}")
            cfn, cargs = clean[rule]
            twin = kernel_check(cfn, *cargs, probe=False)
            quiet = not twin.findings
            ok &= quiet
            lines.append(
                f"[kernel selfcheck] {rule} clean twin: "
                + ("zero findings" if quiet else "DIRTY: " + ", ".join(f.rule for f in twin.findings))
            )
    finally:
        unregister_kernel_cost(drifty_kernel)
    ref_ok, ref_lines = _kernel_reference()
    ok &= ref_ok
    lines.extend(ref_lines)
    return ok, lines
