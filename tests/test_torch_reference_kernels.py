"""The port's contract-bearing reference kernels (accelerate_tpu_torch.kernels)
against the JAX package's: the plain versions against block_matmul_softmax /
block_accumulate in Pallas interpret mode on the same numpy inputs, the
registered cost contracts against the reference's FLOPs, and the registry's
own rules."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu.kernels.reference as jax_reference
from accelerate_tpu.kernels.contracts import KERNEL_REGISTRY as JAX_REGISTRY
from accelerate_tpu_torch.kernels import contracts, reference

torch.set_num_threads(2)

NEEDS_CARD = "needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)"


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,d,n", [(8, 128, 256), (16, 64, 100), (8, 32, 1500)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-6)])
def test_block_matmul_softmax_plain_matches_pallas_interpret(b, d, n, dtype, tol):
    x, w = _inputs((b, d), 0), _inputs((d, n), 1) * 0.2
    want = np.asarray(jax_reference.block_matmul_softmax(jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)))
    tx, tw = (torch.tensor(a).to(getattr(torch, dtype)) for a in (x, w))
    got = reference.block_matmul_softmax(tx, tw)  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(got, reference.block_matmul_softmax_plain(tx, tw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_accumulate_plain_matches_pallas_interpret_in_place(dtype):
    acc, delta = _inputs((16, 96), 2), _inputs((16, 96), 3)
    want = jax_reference.block_accumulate(jnp.asarray(acc).astype(dtype), jnp.asarray(delta).astype(dtype))
    tacc, tdelta = (torch.tensor(a).to(getattr(torch, dtype)) for a in (acc, delta))
    out = reference.block_accumulate(tacc, tdelta)
    assert out is tacc  # in place, as the reference's aliased output
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=1e-6, rtol=0)


def test_rows_and_shapes_are_checked_as_in_the_reference():
    with pytest.raises(ValueError):
        jax_reference.block_matmul_softmax(jnp.zeros((6, 8)), jnp.zeros((8, 8)))
    with pytest.raises(ValueError, match="not divisible by block_rows 8"):
        reference.block_matmul_softmax(torch.zeros(6, 8), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="not divisible by block_rows 8"):
        reference.block_accumulate(torch.zeros(12, 8), torch.zeros(12, 8))
    with pytest.raises(ValueError, match=r"x \[B, D\] and w \[D, N\]"):
        reference.block_matmul_softmax(torch.zeros(8, 8), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="one shape"):
        reference.block_accumulate(torch.zeros(8, 8), torch.zeros(8, 4))
    before = (reference.launches_matmul_softmax, reference.launches_accumulate)
    with pytest.raises(ValueError, match="cuda or cpu"):
        reference.block_matmul_softmax(torch.zeros(8, 8, device="meta"), torch.zeros(8, 8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        reference.block_accumulate(torch.zeros(8, 8, device="meta"), torch.zeros(8, 8, device="meta"))
    reference.block_accumulate(torch.zeros(8, 8), torch.ones(8, 8))
    assert (reference.launches_matmul_softmax, reference.launches_accumulate) == before  # the CPU launches nothing


@pytest.mark.parametrize("b,d,n", [(8, 128, 256), (8, 2048, 32000), (64, 512, 1000)])
def test_registered_flops_equal_the_reference_contracts(b, d, n):
    x, w = torch.empty(b, d, device="meta"), torch.empty(d, n, device="meta", dtype=torch.bfloat16)

    class Aval:  # shapes only: the reference's cost functions read .shape and .dtype
        def __init__(self, shape, dtype):
            self.shape, self.dtype = shape, dtype

    jx, jw = Aval((b, d), np.float32), Aval((d, n), np.float32)
    soft, acc = contracts.KERNEL_REGISTRY["block_matmul_softmax"], contracts.KERNEL_REGISTRY["block_accumulate"]
    assert soft.flops(x, w) == JAX_REGISTRY["block_matmul_softmax_kernel"].flops(jx, jw) == 2.0 * b * d * n + 14.0 * b * n
    a = torch.empty(b, n, device="meta", dtype=torch.bfloat16)
    assert acc.flops(a, a) == JAX_REGISTRY["block_accumulate_kernel"].flops(Aval((b, n), np.float32), None) == b * n
    assert acc.hbm_bytes(a, a) == 3 * b * n * 2 and acc.smem_bytes(a, a) == 0
    # w is read once for every 8 rows; everything else is small beside it
    w_bytes = (b // 8) * d * n * 2
    assert w_bytes < soft.hbm_bytes(x, w) < w_bytes + 4 * b * n * 4 + 2 * (n // 128 + 1) * b * d * 4
    # dynamic shared memory, within a block's 232,448 bytes: four ring stages of 64 w rows (256 bytes + 16 of
    # padding) and the 8 x 64 block of x (128 + 16), the logits tile 8 x 132 f32, reductions 8 x 4 f32, a flag
    assert soft.smem_bytes(x, w) == 4 * (64 * 272 + 8 * 144) + 8 * 132 * 4 + 8 * 4 * 4 + 16 == 78_608 <= 232_448
    assert soft.interval([(-3, 3), (-1, 1)]) == (0.0, 1.0) and acc.interval([(-1, 2), (0, 5)]) == (-1, 7)


def test_selfcheck_shape_declares_the_reference_flops():
    x, w = torch.empty(8, 128), torch.empty(128, 256)
    assert contracts.registered_spec("block_matmul_softmax").flops(x, w) == 552_960


def test_registry_rules():
    spec = contracts.KernelCostSpec("probe", lambda *a: 1.0, lambda *a: 2.0, lambda *a: 3.0)
    try:
        assert contracts.register_kernel_cost(spec) is spec and contracts.registered_spec("probe") is spec
        assert contracts.registered_spec(None) is None and contracts.registered_spec("missing") is None

        @contracts.kernel_cost(flops=lambda x: 7.0, hbm_bytes=lambda x: 8.0, smem_bytes=lambda x: 9.0, name="probe")
        def wrapper(x):
            return x

        assert wrapper(3) == 3 and contracts.registered_spec("probe").flops(None) == 7.0  # latest wins
        assert contracts.registered_spec("probe").tolerance == 0.25
    finally:
        contracts.unregister_kernel_cost("probe")
    assert contracts.registered_spec("probe") is None
    contracts.reset_unknown_op_warnings()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        contracts.warn_unknown_op("perfmodel", "custom_call", "FLOPs")
        contracts.warn_unknown_op("perfmodel", "custom_call", "FLOPs")  # once per analysis x operation
        contracts.warn_unknown_op("numerics", "custom_call", "interval")
    assert [w.category for w in seen] == [contracts.UnknownOpWarning] * 2
    assert "custom_call" in str(seen[0].message) and "ZERO" in str(seen[0].message)
    contracts.reset_unknown_op_warnings()


@pytest.mark.parametrize("shape,dtype,vec", [
    ((2048, 32000), torch.bfloat16, 16),  # the decode-logits shape: 16-byte copies
    ((300, 1500), torch.bfloat16, 8),  # rows of 600 and 3,000 bytes
    ((300, 1500), torch.float32, 16),
    ((64, 1001), torch.bfloat16, 2),  # odd rows: 2-byte copies
    ((5, 7), torch.float32, 4),
])
def test_k6_copy_width_follows_the_rows(shape, dtype, vec):
    """The width of the logits ring's copies: the largest of 16, 8, 4, 2
    bytes that divides a row of x and of w (and their addresses)."""
    d, n = shape
    x, w = torch.zeros(8, d, dtype=dtype), torch.zeros(d, n, dtype=dtype)
    assert reference._softmax_copy_bytes(x, w) == vec
    assert reference._softmax_copy_bytes(x[:, 1:], w) == min(vec, 2 if dtype == torch.bfloat16 else 4)


@pytest.mark.parametrize("b,d,n,dtype,plan", [
    (8, 2048, 32000, torch.bfloat16, (1, 1, 250, 2048)),  # 250 tiles: a block an SM already, no split
    (8, 2048, 32000, torch.float32, (1, 1, 250, 2048)),
    (64, 2048, 32000, torch.bfloat16, (8, 1, 250, 2048)),
    (8, 2048, 1000, torch.bfloat16, (1, 8, 8, 256)),  # 8 tiles: 8 splits of 4 stages, the least a split takes
    (64, 512, 1000, torch.bfloat16, (8, 2, 8, 256)),  # 64 blocks: two splits of the 8 stages
    (16, 300, 1500, torch.bfloat16, (2, 1, 12, 320)),  # 5 stages: one split
])
def test_k6_split_plan(b, d, n, dtype, plan):
    x, w = torch.empty(b, d, dtype=dtype, device="meta"), torch.empty(d, n, dtype=dtype, device="meta")
    assert reference._softmax_plan(x, w) == plan


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,n", [(16, 300, 1500), (8, 2048, 32000), (8, 64, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_block_matmul_softmax_bit_equal_once_a_call(b, d, n, dtype):
    """Two calls on the same inputs are bit-equal (the splits are summed in
    split order), ragged rows run in the kernel, one counted launch a call."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    x = torch.tensor(_inputs((b, d), 8)).cuda().to(dtype)
    w = torch.tensor(_inputs((d, n), 9) * d**-0.5).cuda().to(dtype)
    before = reference.launches_matmul_softmax
    first, second = reference.block_matmul_softmax(x, w), reference.block_matmul_softmax(x, w)
    torch.cuda.synchronize()
    assert reference.launches_matmul_softmax == before + 2
    assert torch.equal(first, second)
    want = reference.block_matmul_softmax_plain(x, w)
    limit = 1e-4 * (want.abs() + want.pow(2).mean().sqrt())
    assert bool(((first - want).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 4096), (8, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_block_accumulate_bit_equal_once_a_call(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    acc = torch.tensor(_inputs(shape, 10)).cuda().to(dtype)
    delta = torch.tensor(_inputs(shape, 11)).cuda().to(dtype)
    first, second, want = acc.clone(), acc.clone(), acc.clone().add_(delta)
    before = reference.launches_accumulate
    reference.block_accumulate(first, delta)
    reference.block_accumulate(second, delta)
    torch.cuda.synchronize()
    assert reference.launches_accumulate == before + 2
    assert torch.equal(first, want) and torch.equal(second, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_reference_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    x = torch.tensor(_inputs((16, 300), 4)).cuda().to(dtype)
    w = torch.tensor(_inputs((300, 1500), 5) * 0.2).cuda().to(dtype)
    before = (reference.launches_matmul_softmax, reference.launches_accumulate)
    got = reference.block_matmul_softmax(x, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), reference.block_matmul_softmax_plain(x, w).cpu().numpy(), atol=1e-6)
    acc, delta = torch.tensor(_inputs((8, 1001), 6)).cuda().to(dtype), torch.tensor(_inputs((8, 1001), 7)).cuda().to(dtype)
    want = reference.block_accumulate_plain(acc.clone(), delta)
    assert reference.block_accumulate(acc, delta) is acc
    torch.cuda.synchronize()
    assert torch.equal(acc, want)
    assert (reference.launches_matmul_softmax, reference.launches_accumulate) == (before[0] + 1, before[1] + 1)
