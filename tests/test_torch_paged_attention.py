"""The port's paged decode attention (accelerate_tpu_torch.ops.paged_attention)
against the JAX package's Pallas kernel in interpret mode: MHA/GQA, ragged
frontiers, trash-sink pad entries, sliding-window bands, zero frontiers and
bf16. Inputs are made with numpy from a seed and handed to both. The CUDA
kernel itself is held against the plain version on the card only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops.pallas_paged_attention import paged_decode_attention as jax_paged_decode_attention
from accelerate_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)


def _setup(seed, b, h, hkv, d, bs, mb, max_cur):
    """f32 numpy inputs: each row gets distinct random non-trash blocks for
    its live region, later entries point at the trash sink (0)."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    cur = rng.integers(0, max_cur + 1, size=b).astype(np.int32)
    tbl = np.zeros((b, mb), np.int32)
    avail = rng.permutation(np.arange(1, nb))
    used = 0
    for i in range(b):
        n = cur[i] // bs + 1
        tbl[i, :n] = avail[used : used + n]
        used += n
    return q, kp, vp, tbl, cur


def _both(q, kp, vp, tbl, cur, window=None, jdtype=jnp.float32, tdtype=torch.float32):
    want = jax_paged_decode_attention(
        jnp.asarray(q, jdtype), jnp.asarray(kp, jdtype), jnp.asarray(vp, jdtype),
        jnp.asarray(tbl), jnp.asarray(cur), sliding_window=window, interpret=True,
    )
    got = pa.paged_decode_attention_plain(
        torch.tensor(q).to(tdtype), torch.tensor(kp).to(tdtype), torch.tensor(vp).to(tdtype),
        torch.tensor(tbl), torch.tensor(cur), sliding_window=window,
    )
    return got, np.asarray(want.astype(jnp.float32))


CASES = [
    # b, h, hkv, d, bs, mb, window
    pytest.param(3, 4, 4, 32, 8, 4, None, id="mha"),
    pytest.param(3, 4, 2, 32, 8, 4, None, id="gqa"),
    pytest.param(2, 4, 2, 32, 8, 4, 5, id="gqa-window"),
    pytest.param(4, 2, 1, 16, 4, 8, None, id="many-pages"),
    pytest.param(2, 4, 2, 32, 8, 4, 100, id="window-wider-than-history"),
    pytest.param(2, 4, 2, 96, 8, 4, None, id="gqa-d96"),
    pytest.param(2, 2, 1, 256, 4, 4, 9, id="mqa-d256-window"),
]


@pytest.mark.parametrize("b,h,hkv,d,bs,mb,window", CASES)
def test_plain_matches_jax_kernel(b, h, hkv, d, bs, mb, window):
    q, kp, vp, tbl, cur = _setup(1, b, h, hkv, d, bs, mb, max_cur=mb * bs - 1)
    got, want = _both(q, kp, vp, tbl, cur, window)
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_zero_frontier_rows():
    """cur=0 (a fresh or inactive slot): only position 0 attends, never a
    NaN from an empty softmax."""
    q, kp, vp, tbl, _ = _setup(2, 2, 2, 2, 16, 4, 2, max_cur=0)
    cur = np.zeros((2,), np.int32)
    got, want = _both(q, kp, vp, tbl, cur)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_dead_row_gives_zero():
    """A row whose window holds no table page (frontier far past the
    table) has l = 0: the floor at 1 makes its output 0, as in the kernel."""
    q, kp, vp, tbl, _ = _setup(3, 1, 2, 2, 16, 4, 2, max_cur=7)
    cur = np.asarray([100], np.int32)
    got, want = _both(q, kp, vp, tbl, cur, window=4)
    np.testing.assert_array_equal(got.numpy(), np.zeros_like(want))
    np.testing.assert_array_equal(want, np.zeros_like(want))


def test_bf16_inputs():
    q, kp, vp, tbl, cur = _setup(3, 2, 4, 2, 32, 8, 3, max_cur=23)
    got, want = _both(q, kp, vp, tbl, cur, jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_window_excludes_old_pages_exactly():
    """Window 4 at cur=10 keeps positions 7..10 only: the plain version and
    the JAX kernel both equal a dense softmax over exactly those keys."""
    b, h, hkv, d, bs, mb = 1, 2, 2, 16, 4, 3
    q, kp, vp, tbl, _ = _setup(4, b, h, hkv, d, bs, mb, max_cur=11)
    tbl[0] = [1, 2, 3]
    cur = np.asarray([10], np.int32)
    got, want = _both(q, kp, vp, tbl, cur, window=4)
    k_all = kp[tbl].reshape(1, mb * bs, hkv, d)[0, 7:11]  # [4, hkv, d]
    v_all = vp[tbl].reshape(1, mb * bs, hkv, d)[0, 7:11]
    s = np.einsum("hd,khd->hk", q[0].astype(np.float64), k_all) / np.sqrt(d)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dense = np.einsum("hk,khd->hd", p, v_all)[None]
    np.testing.assert_allclose(got.numpy(), dense, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(want, dense, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [8, 16, 24, 96, 256, 272])
def test_wrapper_takes_every_head_dim_the_kernel_does(d):
    """The kernel takes every head dim that is a multiple of 16 from 16 to
    256 (the Pallas kernel takes any): the wrapper's checks pass those on
    to the device check (these tensors are on the CPU) and refuse the rest
    by their head dim."""
    taken = d % 16 == 0 and 16 <= d <= 256
    assert pa.head_dim_ok(d) is taken
    q, kp, vp, tbl, cur = (torch.tensor(x) for x in _setup(3, 2, 4, 2, d, 8, 4, max_cur=31))
    with pytest.raises(ValueError, match="cuda or cpu" if taken else "head_dim"):
        pa._check(q, kp, vp, tbl, cur, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
def test_cuda_kernel_matches_plain(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode (chip_smoke.py runs it on the H100)")
    q, kp, vp, tbl, cur = _setup(5, 4, 8, 2, 64, 16, 8, max_cur=127)
    args = [torch.tensor(x).cuda() for x in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [torch.tensor(tbl).cuda(), torch.tensor(cur).cuda()]
    for window in (None, 20):
        before = pa.launches
        got = pa.paged_decode_attention(*args, sliding_window=window)
        torch.cuda.synchronize()
        assert pa.launches == before + 1
        want = pa.paged_decode_attention_plain(*args, sliding_window=window)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 96, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
def test_cuda_kernel_matches_plain_at_other_head_dims(dtype, atol, d):
    """Head dims other than the serving slice's 64 and 128, which the kernel
    reads at run time as it does those: held to the plain version as D 64
    is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode (chip_smoke.py runs it on the H100)")
    q, kp, vp, tbl, cur = _setup(6, 3, 8, 2, d, 16, 8, max_cur=127)
    args = [torch.tensor(x).cuda().to(dtype) for x in (q, kp, vp)] + [torch.tensor(tbl).cuda(), torch.tensor(cur).cuda()]
    before = pa.launches
    got = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_decode_attention_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=atol)


def test_split_plan_fills_the_card_at_the_serving_shapes():
    """TinyLlama's decode (8 rows, 32/4 heads, a 128-page table of 16 keys):
    about two blocks for each of the H100's 132 SMs, and every one of them
    with keys to attend to when the rows hold 100 to 464 keys, as a serving
    tick's do (the kernel cuts each row's live keys into the splits)."""
    num_splits, grid = pa._split_plan(8, 32, 4, 16, 128)
    assert grid == (8 * 4, num_splits) and grid[0] * grid[1] >= 2 * 132
    live = np.random.default_rng(0).integers(100, 465, size=8)
    live_blocks = 4 * int(sum(min(num_splits, n) for n in live))
    assert live_blocks >= 2 * 132, (num_splits, live, live_blocks)


@pytest.mark.parametrize(
    "b,h,hkv,bs,mb", [(8, 32, 4, 16, 128), (3, 8, 1, 4, 128), (2, 64, 2, 8, 64), (64, 32, 8, 16, 128)]
)
def test_split_count_depends_on_shapes_only(b, h, hkv, bs, mb):
    """The split count (and the grid) comes from the shapes, never from
    ``cur``: rows at 0 and rows far past the table launch the same grid, so
    the wrapper never reads ``cur`` back from the card. A GQA group over 16
    heads takes more blocks; a split is never planned shorter than 32 keys
    of a full table."""
    q, kp, vp, tbl, _ = (torch.tensor(x) for x in _setup(7, b, h, hkv, 16, bs, mb, max_cur=0))
    grids = {pa._site(q, kp, vp, tbl, torch.full((b,), c, dtype=torch.int32), None, None).grid
             for c in (0, mb * bs - 1, 10 * mb * bs)}
    num_splits, grid = pa._split_plan(b, h, hkv, bs, mb)
    assert grids == {grid}
    assert grid == (b * hkv * -(-(h // hkv) // 16), num_splits) and 32 * num_splits <= max(32, mb * bs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
def test_cuda_kernel_joins_many_splits_bit_exactly(dtype, atol):
    """Rows cut into many splits (a 1,024-key table, 32 splits): the
    one launch joins them and agrees with the plain version, and two calls
    on the same inputs are bit-equal (the last block to finish joins the
    splits in split order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode (chip_smoke.py runs it on the H100)")
    q, kp, vp, tbl, cur = _setup(8, 4, 8, 2, 64, 16, 64, max_cur=1023)
    assert pa._split_plan(4, 8, 2, 16, 64)[0] > 1
    args = [torch.tensor(x).cuda().to(dtype) for x in (q, kp, vp)]
    args += [torch.tensor(tbl).cuda(), torch.tensor(cur).cuda()]
    for window in (None, 300):
        before = pa.launches
        got = pa.paged_decode_attention(*args, sliding_window=window)
        again = pa.paged_decode_attention(*args, sliding_window=window)
        torch.cuda.synchronize()
        assert pa.launches == before + 2
        assert torch.equal(got, again)
        want = pa.paged_decode_attention_plain(*args, sliding_window=window)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=atol)
