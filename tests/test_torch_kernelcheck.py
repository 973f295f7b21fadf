"""The port's kernel analyzer (accelerate_tpu_torch.analysis: kernelmodel,
kernel_rules, selfcheck; kernels.launch and the K8 fixture kernels): launch
sites recorded on meta tensors, the TPU1001-1006 rules on their seeded
defects with their clean twins (the port's K6/K7), the counted cost against
hand-computed numbers, the AST registration gate and the CLI, mirroring
tests/test_kernelcheck.py; and the same fixtures through the JAX package's
analyzer, which must fire the same rule IDs with the same shared numbers."""

import os
import subprocess
import sys

import jax
import pytest
import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.analysis import kernel_check, run_kernel_selfcheck, scan_paths
from accelerate_tpu_torch.analysis.kernelmodel import counted_cost, smem_occupancy_bytes, tile_visits
from accelerate_tpu_torch.analysis.perfmodel import count_flops
from accelerate_tpu_torch.analysis.report import exit_code, render_sarif
from accelerate_tpu_torch.analysis.selfcheck import _kernel_clean_fixtures, _kernel_fixtures, drift_contract
from accelerate_tpu_torch.kernels import fixtures
from accelerate_tpu_torch.kernels.contracts import register_kernel_cost, unregister_kernel_cost
from accelerate_tpu_torch.kernels.reference import block_accumulate, block_matmul_softmax, block_matmul_softmax_plain

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDS_CARD = "needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)"

# K6 at the selfcheck's decode-logits shape, hand-computed (kernels/reference.py):
# 2·B·D·N + 14·B·N FLOPs (the reference's); the logits pass's grid (2 row blocks, 1 split,
# 1 tile: D = 128 is four f32 stages of 32 rows, the least a split streams) and tiles (8×128 x,
# 128×128 w, 8×128 out, f32); its dynamic shared memory four ring stages (32 w rows of
# 128 × 4 bytes + 16 of padding, 8 x rows of 128 + 16 bytes), the logits tile 8 × 132 f32,
# 8 rows × 4 warps of reductions and a 16-byte flag; the contract's bytes w once per 8 rows,
# x once per 128-column tile, the logits written, reread and rewritten, the tile maxima and sums.
B, D, N = 16, 128, 128
REF_FLOPS = 2 * B * D * N + 14 * B * N  # 552_960
REF_HBM = 2 * (8 * D + D * N + 8 * N) * 4  # 147_456
REF_SMEM = 4 * (32 * 528 + 8 * 144) + 8 * 132 * 4 + 8 * 4 * 4 + 16  # 76_560
DECLARED_HBM = (B // 8) * D * N * 4 + B * D * 4 + 3 * B * N * 4 + 2 * B * 4 * 2  # 164_096
RULES = ("TPU1001", "TPU1002", "TPU1003", "TPU1004", "TPU1005", "TPU1006")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _softmax_step(x, w):
    return block_matmul_softmax(x, w)


def _rules(report):
    return [f.rule for f in report.findings]


def _check(fn, *args, rule):
    return kernel_check(fn, *args, select=(rule,), probe=False)


@pytest.fixture
def drift_registered():
    """TPU1006's fixture contract, the reference's: 3 x 2 FLOPs an element
    (6x the count), the bytes exact."""
    register_kernel_cost(drift_contract("tile_scale"))
    yield
    unregister_kernel_cost("tile_scale")


# --------------------------------------------------------------------- #
# extraction + the counted cost (hand-computed pins)
# --------------------------------------------------------------------- #


def test_extraction_and_counted_cost_exact():
    report = kernel_check(_softmax_step, _meta(B, D), _meta(D, N), probe=False)
    assert report.findings == [] and report.generation == "h100" and report.smem_capacity_bytes == 232_448
    assert len(report.sites) == 1
    site = report.sites[0]
    assert site.kernel_name == "block_matmul_softmax" and site.spec is not None
    assert site.grid == (2, 1, 1) and site.threads == 128 and site.count == 1
    assert [t.tile for t in site.in_tiles] == [(8, D), (D, 128)]
    assert [t.tile for t in site.out_tiles] == [(8, 128)]
    assert site.io_aliases == ()
    assert site.path == __file__ and site.line == _softmax_step.__code__.co_firstlineno + 1
    assert counted_cost(site) == (REF_FLOPS, REF_HBM)
    assert smem_occupancy_bytes(site) == REF_SMEM
    # the declaration: the FLOPs exact, the shared memory exact, the bytes within tolerance
    assert site.spec.flops(*site.operands) == REF_FLOPS
    assert site.spec.smem_bytes(*site.operands) == REF_SMEM
    assert site.spec.hbm_bytes(*site.operands) == DECLARED_HBM
    assert abs(DECLARED_HBM - REF_HBM) / REF_HBM < site.spec.tolerance


@pytest.mark.parametrize("b,d,n", [(16, 128, 128), (8, 2048, 32000), (64, 512, 1000)])
def test_k6_flop_recount_exact_at_three_shapes(b, d, n):
    report = kernel_check(_softmax_step, _meta(b, d), _meta(d, n, dtype=torch.bfloat16), probe=False)
    (site,) = report.sites
    assert counted_cost(site)[0] == 2 * b * d * n + 14 * b * n == site.spec.flops(*site.operands)
    assert not report.findings  # the bytes stay within tolerance at every shape


def test_extraction_aliases_and_clean_alias_twin():
    report = kernel_check(block_accumulate, _meta(B, N), _meta(B, N), probe=False)
    assert report.findings == []
    (site,) = report.sites
    assert site.io_aliases == ((0, 0),) and site.grid == (2,) and site.location == ""  # traced the wrapper itself
    assert counted_cost(site) == (B * N, 3 * B * N * 4) and smem_occupancy_bytes(site) == 0


def test_grid_stride_walk_covers_once_at_the_block_cap():
    """K7 at [4096, 4096] f32: 16,384 tiles of 1,024 elements (256 threads
    x one 16-byte vector), one block a tile: the grid holds the whole call,
    with no cap and no stride; every tile once. (16,384 blocks are past
    MAX_ENUMERATED_GRID, so the analyzer's coverage rules skip the site and
    the walk is checked here.)"""
    report = kernel_check(block_accumulate, _meta(4096, 4096), _meta(4096, 4096), probe=False)
    (site,) = report.sites
    assert site.grid == (16384,) and report.findings == []
    assert counted_cost(site) == (4096 * 4096, 3 * 4096 * 4096 * 4)
    visited = [t for _, ts in tile_visits(site.in_tiles[0], site) for t in ts]
    assert sorted(visited) == [(t,) for t in range(16_384)]


# K6's launch sites on meta, hand-computed (kernels/reference.py::_softmax_plan, 16-bit stages
# of 64 contraction rows, splits only while each keeps >= 4 stages and the grid is under
# 132 blocks): (B, D, N) -> grid (row blocks, splits, tiles), split rows, counted and declared
# bytes. Counted: x (8, split rows) and w (split rows, 128) bf16 a block, out (8, 128) f32 a
# tile, with splits a (1, 8, 128) f32 partial written a block and the other splits' read by
# the last. Declared: w once per 8 rows, x once per tile, partials (2 splits - 1) B N 4,
# logits 3 B N 4, tile maxima and sums 2 B tiles 4 (1 + ceil(N / 1024)).
K6_SITES = [
    ((16, 128, 128), (2, 1, 1), 128,
     2 * (8 * 128 * 2 + 128 * 128 * 2 + 8 * 128 * 4),  # 77,824
     2 * 128 * 128 * 2 + 16 * 128 * 2 + 3 * 16 * 128 * 4 + 2 * 16 * 1 * 4 * 2),  # 94,464
    ((8, 2048, 32000), (1, 1, 250), 2048,  # 250 tiles: a block an SM already, no split
     250 * (8 * 2048 * 2 + 2048 * 128 * 2 + 8 * 128 * 4),  # 140,288,000
     2048 * 32000 * 2 + 250 * 8 * 2048 * 2 + 3 * 8 * 32000 * 4 + 2 * 8 * 250 * 4 * 33),  # 142,864,000
    ((64, 512, 1000), (8, 2, 8), 256,
     128 * (8 * 256 * 2 + 256 * 128 * 2 + 8 * 128 * 4) + 64 * 8 * 128 * 4 * 2,  # 9,961,472
     8 * 512 * 1000 * 2 + 8 * 64 * 512 * 2 + 3 * 64 * 1000 * 4 * 2 + 2 * 64 * 8 * 4 * 2),  # 10,260,480
    # N * 2 = 3,000 bytes, not a multiple of 16 (the ring's 8-byte copies); D = 300 is 5 stages, one split
    ((16, 300, 1500), (2, 1, 12), 320,
     24 * (8 * 320 * 2 + 320 * 128 * 2 + 8 * 128 * 4),  # 2,187,264
     2 * 300 * 1500 * 2 + 12 * 16 * 300 * 2 + 3 * 16 * 1500 * 4 + 2 * 16 * 12 * 4 * 3),  # 2,207,808
]


@pytest.mark.parametrize("shape,grid,split_rows,counted_hbm,declared_hbm", K6_SITES)
def test_k6_launch_site_hand_computed(shape, grid, split_rows, counted_hbm, declared_hbm):
    b, d, n = shape
    report = kernel_check(_softmax_step, _meta(b, d, dtype=torch.bfloat16), _meta(d, n, dtype=torch.bfloat16),
                          probe=False)
    (site,) = report.sites
    assert report.findings == []
    assert site.grid == grid and site.threads == 128
    splits = grid[1]
    assert [(t.name, t.tile) for t in site.in_tiles] == [("x", (8, split_rows)), ("w", (split_rows, 128))] + (
        [("partials", (1, 8, 128))] if splits > 1 else [])
    assert [(t.name, t.tile) for t in site.out_tiles] == [("out", (8, 128))] + (
        [("partials", (1, 8, 128))] if splits > 1 else [])
    # the ring (4 stages of 64 w rows of 256 + 16 bytes and 8 x rows of 128 + 16), tile, reductions, flag
    smem = 4 * (64 * 272 + 8 * 144) + 8 * 132 * 4 + 8 * 4 * 4 + 16
    assert smem_occupancy_bytes(site) == site.spec.smem_bytes(*site.operands) == smem == 78_608
    assert counted_cost(site) == (2 * b * d * n + 14 * b * n, counted_hbm)
    assert site.spec.hbm_bytes(*site.operands) == declared_hbm
    # out is written once a tile (by the joining block, declared at the last split)
    writers = {}
    for block, visited in tile_visits(site.out_tiles[0], site):
        for idx in visited:
            writers[idx] = writers.get(idx, 0) + 1
    assert len(writers) == grid[0] * grid[2] and set(writers.values()) == {1}


@pytest.mark.parametrize("shape,dtype,grid", [
    ((4096, 4096), torch.bfloat16, (8192,)),  # 2,048 bf16 a tile (256 threads x 8)
    ((8, 1001), torch.bfloat16, (4,)),  # 8,008 elements: 3 whole tiles, a partial one with the scalar tail
    ((64, 4096), torch.float32, (256,)),  # 1,024 f32 a tile
])
def test_k7_launch_site_hand_computed(shape, dtype, grid):
    report = kernel_check(block_accumulate, _meta(*shape, dtype=dtype), _meta(*shape, dtype=dtype), probe=False)
    (site,) = report.sites
    assert report.findings == [] and site.grid == grid and site.threads == 256
    item = 2 if dtype == torch.bfloat16 else 4
    tile = 256 * 16 // item
    assert [t.tile for t in site.in_tiles] == [(tile,), (tile,)] and site.io_aliases == ((0, 0),)
    visited = [t for _, ts in tile_visits(site.in_tiles[0], site) for t in ts]
    assert sorted(visited) == [(t,) for t in range(grid[0])]  # every tile once, a block each
    assert counted_cost(site)[1] == 3 * grid[0] * tile * item and smem_occupancy_bytes(site) == 0


def test_interpret_probe_runs_the_plain_versions():
    report = kernel_check(_softmax_step, _meta(B, D), _meta(D, N), device="cpu")
    assert report.interpret_probe == "ran on cpu: outputs finite"
    assert kernel_check(lambda x: x + 1, _meta(4), device="cpu").interpret_probe == "skipped (no kernel launches)"


def test_probe_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_check(_softmax_step, _meta(B, D), _meta(D, N))
    assert kernel_check(_softmax_step, _meta(B, D), _meta(D, N), probe=False).findings == []


def test_meta_tensors_are_refused_outside_kernel_check():
    x = _meta(8, 128)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fixtures.tile_copy(x, tile=(8, 128), grid=(1,), in_map=lambda i: (0, 0), out_map=lambda i: (0, 0))


# --------------------------------------------------------------------- #
# the six rules on their seeded defects, each clean twin silent
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("rule", RULES)
def test_rule_fires_on_its_fixture_and_its_twin_is_clean(rule, drift_registered):
    fixture_set, _ = _kernel_fixtures()
    fn, args = fixture_set[rule]
    report = _check(fn, *args, rule=rule)
    assert report.findings and set(_rules(report)) == {rule}
    assert all(f.is_error == (rule in ("TPU1001", "TPU1003", "TPU1005")) for f in report.findings)
    cfn, cargs = _kernel_clean_fixtures()[rule]
    assert kernel_check(cfn, *cargs, probe=False).findings == []


def test_tpu1001_prices_the_overflow():
    fn, args = _kernel_fixtures()[0]["TPU1001"]
    (site,) = kernel_check(fn, *args, probe=False).sites
    assert smem_occupancy_bytes(site) == 2 * 2 * 512 * 512 * 4  # in + out tiles, two stages each: 4 MiB
    (finding,) = _check(fn, *args, rule="TPU1001").findings
    assert "18.0x over" in finding.message and "232,448" in finding.message


def test_capacity_without_a_card_is_the_h100_row(monkeypatch):
    from accelerate_tpu_torch.analysis.costmodel import device_generation, smem_bytes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_generation() is None
    assert smem_bytes() == smem_bytes("h100") == 232_448
    with pytest.raises(ValueError, match="no shared-memory row for 'h200'"):
        smem_bytes("h200")
    fn, args = _kernel_fixtures()[0]["TPU1001"]
    report = kernel_check(fn, *args, probe=False)
    assert (report.generation, report.smem_capacity_bytes) == ("h100", 232_448)


def test_tpu1002_prices_the_waste():
    fn, args = _kernel_fixtures()[0]["TPU1002"]
    findings = _check(fn, *args, rule="TPU1002").findings
    assert len(findings) == 2  # the in tile and the out tile
    assert all("22%" in f.message and "(8, 128)" in f.message for f in findings)


def test_tpu1003_fires_for_the_gap_and_the_race():
    """On the card two blocks writing one tile is a race wherever they sit
    in the grid, so the pinned map fires twice where the reference (whose
    consecutive revisits are legal) fires once."""
    fn, args = _kernel_fixtures()[0]["TPU1003"]
    gap, race = _check(fn, *args, rule="TPU1003").findings
    assert "leaves 1 of 2 output tile(s) unwritten" in gap.message and "(1, 0)" in gap.message
    assert "tile (0, 0) is written by blocks [(0,), (1,)]" in race.message


def test_tpu1004_disagreement_at_block_1():
    fn, args = _kernel_fixtures()[0]["TPU1004"]
    (finding,) = _check(fn, *args, rule="TPU1004").findings
    assert "disagree at block 1 (reads tile (0, 0), writes tile (1, 0))" in finding.message


def test_tpu1006_only_the_flops_drift(drift_registered):
    fn, args = _kernel_fixtures()[0]["TPU1006"]
    (finding,) = _check(fn, *args, rule="TPU1006").findings
    # the reference's declaration, 3 x 2 FLOPs an element: 6x the one multiply counted
    assert "declared FLOPs 1.229e+04 vs counted 2048" in finding.message and "500% drift" in finding.message


def test_kernel_selfcheck_green():
    ok, lines = run_kernel_selfcheck()
    assert ok, "\n".join(lines)
    assert sum("detected" in line for line in lines) == 6
    assert sum("zero findings" in line for line in lines) == 6
    assert any("cost reference" in line and "exact" in line for line in lines)


# --------------------------------------------------------------------- #
# the ops kernels (K1-K5): recorded on meta, unregistered as in the reference
# --------------------------------------------------------------------- #


def test_decode_step_lists_the_paged_kernel():
    from accelerate_tpu_torch import LlamaConfig, create_llama_model
    from accelerate_tpu_torch.ops.paged_attention import paged_decode_attention
    from accelerate_tpu_torch.ops.paged_kv import PagedKVCache

    def k4_call(q, kp, vp, table, cur):
        return paged_decode_attention(q, kp, vp, table, cur)

    i32 = torch.int32
    report = kernel_check(k4_call, _meta(8, 32, 64), _meta(33, 16, 4, 64), _meta(33, 16, 4, 64),
                          _meta(8, 128, dtype=i32), _meta(8, dtype=i32), probe=False)
    (site,) = report.sites  # (row x kv head, split): about two blocks for each of the card's 132 SMs
    assert site.kernel_name == "paged_decode_attention" and site.grid == (8 * 4, 9) and site.spec is None
    assert _rules(report) == ["TPU1005"]

    cfg = LlamaConfig.tiny()
    model = create_llama_model(cfg, device="cpu")

    def decode_step(params, ids, pool, table, index):
        cache = PagedKVCache(pool, pool.clone(), table, index)
        return model.apply_fn(params, ids, decode=True, cache=cache)[0]

    pool = _meta(cfg.num_hidden_layers, 9, 4, cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads)
    report = kernel_check(decode_step, model.params, _meta(2, 1, dtype=i32), pool, _meta(2, 32, dtype=i32),
                          _meta(2, dtype=i32), probe=False)
    (site,) = report.sites  # one site a layer, from one line: merged with its count
    assert site.kernel_name == "paged_decode_attention" and site.count == cfg.num_hidden_layers
    assert site.path.endswith(os.path.join("models", "llama.py"))


def test_training_step_lists_the_flash_kernels():
    from accelerate_tpu_torch.ops.flash_attention import flash_attention

    def step(q, k, v):
        q.requires_grad_(True)
        out = flash_attention(q, k, v, causal=True)
        out.float().sum().backward()
        return out

    report = kernel_check(step, _meta(2, 128, 4, 64), _meta(2, 128, 2, 64), _meta(2, 128, 2, 64), probe=False)
    assert [(s.kernel_name, s.grid) for s in report.sites] == [
        ("flash_attention_fwd", (8, 2)), ("flash_attention_dq", (8, 2)), ("flash_attention_dkv", (4, 2))]
    assert _rules(report) == ["TPU1005"] * 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_training_step_lists_the_hopper_forward(dtype):
    """In bf16 and fp16 K1 is the Hopper kernel: at D 64, 192 query rows
    and 512 threads (a producer and three consumer warpgroups) a block; so
    are K2 (the same split of query rows) and K3 (128 key rows, a producer
    and two consumer warpgroups: 384 threads)."""
    from accelerate_tpu_torch.ops.flash_attention import flash_attention

    def step(q, k, v):
        q.requires_grad_(True)
        out = flash_attention(q, k, v, causal=True)
        out.float().sum().backward()
        return out

    report = kernel_check(step, _meta(2, 128, 4, 64, dtype=dtype), _meta(2, 128, 2, 64, dtype=dtype),
                          _meta(2, 128, 2, 64, dtype=dtype), probe=False)
    assert [(s.kernel_name, s.grid, s.threads) for s in report.sites] == [
        ("flash_attention_fwd", (8, 1), 512), ("flash_attention_dq", (8, 1), 512),
        ("flash_attention_dkv", (4, 1), 384)]
    assert _rules(report) == ["TPU1005"] * 3


def test_int4_projection_lists_the_int4_kernel():
    from accelerate_tpu_torch.ops.qdense import QuantDense

    layer = QuantDense(256, 384, method="int4", group_size=64)

    def project(x, qdata, qscale):
        return torch.func.functional_call(layer, {"qdata": qdata, "qscale": qscale}, (x,))

    report = kernel_check(project, _meta(8, 256, dtype=torch.bfloat16), layer.qdata, layer.qscale, probe=False)
    (site,) = report.sites  # decode: 16-column tiles, one group of 64 a split, one warp a block
    assert site.kernel_name == "int4_matmul" and site.grid == (24, 4) and site.threads == 32
    assert _rules(report) == ["TPU1005"]
    assert counted_cost(site)[0] > 2 * 8 * 256 * 384  # the two nibble products, the zero point and the scale


# --------------------------------------------------------------------- #
# the K8 wrappers off the card, the FLOP model, reports
# --------------------------------------------------------------------- #


def test_fixture_wrappers_take_plain_versions_on_cpu():
    gen = torch.Generator().manual_seed(0)
    x, a, d = torch.randn(3, 16, 128, generator=gen).unbind(0)
    before = (fixtures.launches_copy, fixtures.launches_add, fixtures.launches_scale)
    fixture_set, _ = _kernel_fixtures()
    assert torch.equal(fixture_set["TPU1003"][0](x), x)  # the intended copy, whatever the maps say
    assert torch.equal(fixture_set["TPU1002"][0](x[:, :100].contiguous()), x[:, :100])
    assert torch.equal(fixture_set["TPU1006"][0](x), x * 2)
    want = a + d
    got = fixture_set["TPU1004"][0](a, d)
    assert got is a and torch.equal(a, want)  # aliased: written in place, from the unmodified a
    assert (fixtures.launches_copy, fixtures.launches_add, fixtures.launches_scale) == before


@pytest.mark.parametrize("rule", ["TPU1001", "TPU1002", "TPU1003", "TPU1004", "TPU1005", "TPU1006"])
def test_tile_origins_pack_into_the_launch_parameters(rule):
    """Each fixture's table of tile origins, packed for the kernel's
    parameters, unpacks to ``site.tile_origins()``: the card reads the maps
    the analyzer judged."""
    fn, args = _kernel_fixtures()[0][rule]
    (site,) = kernel_check(fn, *args, probe=False).sites
    from accelerate_tpu_torch.kernels.launch import LaunchSite

    launch = LaunchSite(site.kernel_name, site.grid, site.threads, ins=tuple(site.in_tiles),
                        outs=tuple(site.out_tiles))
    table = launch.tile_origins()
    packed = fixtures.pack_origins(launch)
    assert len(packed) == table.numel() <= fixtures.MAX_BLOCKS * 3 * 2
    assert torch.equal(torch.tensor(list(packed), dtype=torch.int32).view(table.shape), table)


def test_tile_origins_above_capacity_raise():
    from accelerate_tpu_torch.kernels.launch import LaunchSite, TileSpec

    def site(blocks):
        spec = TileSpec("x", (8, 128), (8 * blocks, 128), torch.float32, lambda i: (i, 0))
        return LaunchSite("tile_scale", (blocks,), fixtures.THREADS, ins=(spec,), outs=(spec,))

    assert len(fixtures.pack_origins(site(fixtures.MAX_BLOCKS))) == fixtures.MAX_BLOCKS * 2 * 2
    with pytest.raises(ValueError, match=f"at most MAX_BLOCKS = {fixtures.MAX_BLOCKS}"):
        fixtures.pack_origins(site(fixtures.MAX_BLOCKS + 1))


def test_tile_origins_are_the_declared_maps():
    fixture_set, _ = _kernel_fixtures()
    fn, args = fixture_set["TPU1004"]
    (site,) = kernel_check(fn, *args, probe=False).sites
    from accelerate_tpu_torch.kernels.launch import LaunchSite

    launch = LaunchSite(site.kernel_name, site.grid, site.threads, ins=tuple(site.in_tiles),
                        outs=tuple(site.out_tiles))
    # block i: a at tile (0, 0), d and out at tile (i, 0); origins in elements
    assert launch.tile_origins().tolist() == [[[0, 0], [0, 0], [0, 0]], [[0, 0], [8, 0], [8, 0]]]


def test_flop_model_weights():
    x = _meta(16, 128)
    assert count_flops(lambda t: t @ _meta(128, 64), x) == 2 * 16 * 128 * 64
    assert count_flops(torch.exp, x) == 10 * 16 * 128
    assert count_flops(lambda t: t.sum(dim=-1), x) == 16 * 128
    assert count_flops(lambda t: t.view(-1).float().clone(), x) == 0
    assert count_flops(lambda t: t + t, x) == 16 * 128
    assert count_flops(block_matmul_softmax_plain, x, _meta(128, 256)) == 2 * 16 * 128 * 256 + 14 * 16 * 256


def test_reports_and_exit_codes(drift_registered):
    fn, args = _kernel_fixtures()[0]["TPU1006"]
    report = kernel_check(fn, *args, probe=False)
    assert sorted(_rules(report)) == ["TPU1006"]  # registered now: no TPU1005
    assert exit_code(report.findings) == 0 and exit_code(report.findings, strict=True) == 1
    data = report.as_dict()
    assert data["sites"][0]["counted_flops"] == 2048 and data["sites"][0]["registered"]
    assert '"ruleId": "TPU1006"' in render_sarif(report.findings)
    assert "declared 0.01 MFLOP" in report.render_text()


def test_inline_suppression_silences_a_traced_finding(tmp_path):
    from accelerate_tpu_torch.commands.kernelcheck import load_step

    p = tmp_path / "step.py"
    p.write_text(_FIXTURE_STEP_SRC.replace("tile_copy(x,", "tile_copy(x,  # tpu-lint: disable=TPU1005\n  "))
    _, fn = load_step(f"{p}::step")
    assert kernel_check(fn, _meta(16, 128), probe=False).findings == []
    p.write_text(_FIXTURE_STEP_SRC)
    _, fn = load_step(f"{p}::step")
    assert _rules(kernel_check(fn, _meta(16, 128), probe=False)) == ["TPU1005"]


def test_accelerator_kernel_check_returns_a_report():
    report = Accelerator(cpu=True).kernel_check(_softmax_step, _meta(B, D), _meta(D, N))
    assert report.ok and report.findings == [] and report.interpret_probe == "ran on cpu: outputs finite"
    fn, args = _kernel_fixtures()[0]["TPU1005"]
    assert not Accelerator(cpu=True).kernel_check(fn, *args).ok


# --------------------------------------------------------------------- #
# the AST registration gate + CLI surfaces
# --------------------------------------------------------------------- #

_UNREGISTERED_SRC = """\
from accelerate_tpu_torch.kernels.build import load

def step(x, out):
    lib = load("mystery")
    return lib.mystery_kernel(x.data_ptr(), out.data_ptr())
"""

_FIXTURE_STEP_SRC = """\
from accelerate_tpu_torch.kernels.fixtures import tile_copy

def step(x):
    return tile_copy(x, tile=(8, 128), grid=(2,), in_map=lambda i: (i, 0), out_map=lambda i: (i, 0))
"""

_TRACED_SRC = """\
import torch
from accelerate_tpu_torch.kernels.reference import block_matmul_softmax

def decode_step(x, w):
    return block_matmul_softmax(x, w)

def decode_step_sample_args():
    return torch.empty(16, 128, device="meta"), torch.empty(128, 128, device="meta")
"""


def test_scan_paths_fires_and_respects_suppression(tmp_path):
    p = tmp_path / "unregistered.py"
    p.write_text(_UNREGISTERED_SRC)
    findings = scan_paths([str(p)])
    assert [f.rule for f in findings] == ["TPU1005"] and findings[0].line == 5
    assert "mystery_kernel" in findings[0].message
    p.write_text(_UNREGISTERED_SRC.replace("out.data_ptr())", "out.data_ptr())  # tpu-lint: disable=TPU1005"))
    assert scan_paths([str(p)]) == []
    registered = tmp_path / "registered.py"
    registered.write_text(_UNREGISTERED_SRC.replace("mystery_kernel", "block_matmul_softmax"))
    assert scan_paths([str(registered)]) == []


def test_scan_paths_over_the_port():
    """kernels/ (K6, K7 registered; the K8 fixtures suppressed) is clean;
    ops/ holds the eight unregistered launches (K1-K3 in f32 and in 16
    bits, K4, K5), as the reference's ops kernels carry no contract."""
    pkg = os.path.join(REPO, "accelerate_tpu_torch")
    assert scan_paths([os.path.join(pkg, "kernels")]) == []
    found = scan_paths([os.path.join(pkg, "ops")])
    assert sorted(f.message.split("`")[1] for f in found) == [
        "flash_attention_dkv", "flash_attention_dq", "flash_attention_fwd", "flash_dkv_sm90", "flash_dq_sm90",
        "flash_fwd_sm90", "int4_matmul", "paged_decode_attention"]


def _run_cli(*args, cwd=REPO):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.kernelcheck", *args],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=240)


def test_cli_selfcheck():
    result = _run_cli("--selfcheck")
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.count("detected") == 6 and result.stdout.count("zero findings") == 6
    assert "cost reference" in result.stdout and "exact" in result.stdout


def test_cli_paths_mode_unregistered_exits_nonzero(tmp_path):
    p = tmp_path / "unregistered.py"
    p.write_text(_UNREGISTERED_SRC)
    result = _run_cli(str(p))
    assert result.returncode == 1, result.stdout + result.stderr
    assert "TPU1005" in result.stdout


def test_cli_changed_without_git_falls_back(tmp_path):
    p = tmp_path / "unregistered.py"
    p.write_text(_UNREGISTERED_SRC)
    result = _run_cli("--changed", str(p), cwd=str(tmp_path))
    assert result.returncode == 1
    assert "needs a git work tree" in result.stderr and "TPU1005" in result.stdout


def test_cli_traced_target_clean(tmp_path):
    p = tmp_path / "step.py"
    p.write_text(_TRACED_SRC)
    result = _run_cli(f"{p}::decode_step", "--device", "cpu")
    assert result.returncode == 0, result.stdout + result.stderr
    assert "findings: none" in result.stdout and "[registered]" in result.stdout
    assert "ran on cpu: outputs finite" in result.stdout


# --------------------------------------------------------------------- #
# the same fixtures through the JAX package's analyzer
# --------------------------------------------------------------------- #


def _jax_extract(call):
    """``call()``, a run of the JAX analyzer. Its one known failure under
    newer jax, ``int()`` of a ``Blocked`` block dimension in its extractor,
    skips the test and names the reason; anything else is raised."""
    try:
        return call()
    except TypeError as e:
        if "'Blocked'" not in str(e):
            raise
        pytest.skip(f"jax {jax.__version__} cannot run the JAX kernel extractor: {e}")


def _jax_report(rule, mesh):
    """The JAX analyzer's report on its own fixture for ``rule``, or a skip
    naming why the installed jax cannot run its extractor."""
    from accelerate_tpu.analysis.kernelmodel import kernel_check as jax_kernel_check
    from accelerate_tpu.analysis.selfcheck import _kernel_fixtures as jax_fixtures
    from accelerate_tpu.kernels.contracts import KernelCostSpec as JaxSpec
    from accelerate_tpu.kernels.contracts import register_kernel_cost as jax_register
    from accelerate_tpu.kernels.contracts import unregister_kernel_cost as jax_unregister

    fixture_set, drifty = jax_fixtures(mesh)
    fn, args, kwargs = fixture_set[rule]
    jax_register(JaxSpec(
        name=drifty.__name__,
        flops=lambda x: float(3 * 2 * x.shape[0] * x.shape[1]),
        hbm_bytes=lambda x: float(2 * x.shape[0] * x.shape[1] * 4),
        vmem_peak_bytes=lambda x: float(2 * 2 * 8 * x.shape[1] * 4),
    ))
    try:
        return _jax_extract(lambda: jax_kernel_check(fn, *args, mesh=mesh, generation="cpu", select=(rule,),
                                                     probe=False, **kwargs))
    finally:
        jax_unregister(drifty.__name__)


@pytest.mark.parametrize("rule", RULES)
def test_same_rule_fires_in_both_packages(rule, mesh8, drift_registered):
    jax_report = _jax_report(rule, mesh8)
    fn, args = _kernel_fixtures()[0][rule]
    port_report = _check(fn, *args, rule=rule)
    assert set(_rules(jax_report)) == set(_rules(port_report)) == {rule}
    jax_msgs, port_msgs = [f.message for f in jax_report.findings], [f.message for f in port_report.findings]
    if rule == "TPU1002":
        assert all("22%" in m for m in jax_msgs + port_msgs)
    elif rule == "TPU1003":  # the gap in both; the race only on the card
        assert len(jax_msgs) == 1 and len(port_msgs) == 2
        assert "1 of 2 output block(s) unwritten" in jax_msgs[0] and "1 of 2 output tile(s) unwritten" in port_msgs[0]
    elif rule == "TPU1004":
        assert "grid step 1" in jax_msgs[0] and "block 1" in port_msgs[0]
    elif rule == "TPU1006":
        assert all("declared FLOPs 1.229e+04" in m and "count 2048" in m for m in jax_msgs)
        assert all("declared FLOPs 1.229e+04" in m and "counted 2048" in m for m in port_msgs)


def test_k6_count_agrees_across_packages(mesh8):
    import jax.numpy as jnp
    from accelerate_tpu.analysis.kernelmodel import counted_cost as jax_counted_cost
    from accelerate_tpu.analysis.kernelmodel import kernel_check as jax_kernel_check
    from accelerate_tpu.kernels.reference import block_matmul_softmax as jax_softmax

    sds = (jax.ShapeDtypeStruct((B, D), jnp.float32), jax.ShapeDtypeStruct((D, N), jnp.float32))
    jax_report = _jax_extract(lambda: jax_kernel_check(lambda x, w: jax_softmax(x, w), *sds, mesh=mesh8,
                                                       generation="cpu", probe=False))
    (port_site,) = kernel_check(_softmax_step, _meta(B, D), _meta(D, N), probe=False).sites
    assert jax_counted_cost(jax_report.sites[0])[0] == counted_cost(port_site)[0] == REF_FLOPS


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #


@pytest.mark.cuda
def test_cuda_fixture_kernels_follow_the_declared_maps():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    fixture_set, _ = _kernel_fixtures()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(16, 128, generator=gen, device="cuda")
    assert torch.equal(fixture_set["TPU1005"][0](x), x) and torch.equal(fixture_set["TPU1006"][0](x), x * 2)
    with pytest.raises(RuntimeError, match="refused"):
        fixture_set["TPU1001"][0](torch.zeros(1024, 512, device="cuda"))
    out = torch.full_like(x, float("nan"))
    fixture_set["TPU1003"][0](x, out=out)
    torch.cuda.synchronize()
    assert bool(out[8:].isnan().all())
    assert bool(((out[:8] == x[:8]) | (out[:8] == x[8:])).all())
