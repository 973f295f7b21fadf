"""The port's flash attention (accelerate_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_pallas_attention.py runs it: forward on that file's cases plus
Sq > Sk under causal (fully masked rows), the gradients through
FlashAttention (its plain forward and backward on the CPU), the band, and
the argument errors. f32 on the CPU; inputs made with numpy from a seed.
The CUDA kernels themselves run only on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops.pallas_attention import pallas_flash_attention
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(2)


def _qkv(seed, b, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32) for shape in ((b, sq, h, d), (b, sk, h_kv, d), (b, sk, h_kv, d))
    )


def _jax(q, k, v, causal, window=None, block=64):
    return pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=block, block_k=block,
        interpret=True, window=window,
    )


CASES = [
    # b, sq, sk, h, h_kv, d, causal: tests/test_pallas_attention.py's CASES, then Sq > Sk
    pytest.param(2, 128, 128, 2, 2, 32, False, id="mha-noncausal"),
    pytest.param(2, 128, 128, 2, 2, 32, True, id="mha-causal"),
    pytest.param(1, 128, 128, 4, 2, 32, True, id="gqa-causal"),
    pytest.param(1, 100, 100, 2, 1, 32, True, id="odd-seq-padded"),
    pytest.param(1, 64, 192, 2, 2, 32, True, id="decode-sq-lt-sk"),
    pytest.param(1, 96, 40, 2, 1, 32, True, id="sq-gt-sk-dead-rows"),
]


@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,causal", CASES)
def test_plain_forward_matches_pallas(b, sq, sk, h, h_kv, d, causal):
    q, k, v = _qkv(0, b, sq, sk, h, h_kv, d)
    want = np.asarray(_jax(q, k, v, causal))
    out, lse = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal)
    assert out.shape == (b, sq, h, d) and lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    # the wrapper takes the plain version on CPU tensors, and launches nothing
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    got = fa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=1e-6, rtol=1e-6)  # threaded BLAS may reorder sums
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before


def test_dead_rows_give_zero_and_minus_inf_lse():
    """Sq > Sk under causal: the first Sq - Sk queries see no key."""
    q, k, v = _qkv(1, 1, 96, 40, 2, 1, 32)
    out, lse = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True)
    assert torch.all(out[:, :56] == 0) and torch.all(lse[:, :, :56] == -torch.inf)
    assert torch.isfinite(lse[:, :, 56:]).all()


def _grads_torch(q, k, v, causal, window=None):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (fa.flash_attention(*ts, causal=causal, window=window) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def _grads_jax(q, k, v, causal, window=None, block=64):
    def loss(q, k, v):
        return (_jax(q, k, v, causal, window, block) ** 2).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize(
    "b,sq,sk,h,h_kv,d,causal",
    [
        pytest.param(1, 128, 128, 2, 2, 32, True, id="mha-causal"),
        pytest.param(1, 128, 128, 4, 2, 32, True, id="gqa-causal"),
        pytest.param(1, 100, 100, 2, 2, 32, False, id="odd-seq-noncausal"),
    ],
)
def test_gradients_match_pallas(b, sq, sk, h, h_kv, d, causal):
    q, k, v = _qkv(2, b, sq, sk, h, h_kv, d)
    got = _grads_torch(q, k, v, causal)
    want = _grads_jax(q, k, v, causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=2e-3, err_msg=f"d{name} mismatch")


def test_sq_gt_sk_gradients_match_pallas():
    q, k, v = _qkv(3, 1, 96, 40, 2, 1, 32)
    for g, w in zip(_grads_torch(q, k, v, True), _grads_jax(q, k, v, True)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize(
    "b,sq,sk,h,h_kv,d,window",
    [
        pytest.param(2, 128, 128, 2, 2, 32, 40, id="mha-band"),
        pytest.param(1, 128, 128, 4, 2, 32, 64, id="gqa-band-blockmult"),
        pytest.param(1, 100, 100, 2, 2, 32, 17, id="odd-seq-odd-band"),
        pytest.param(1, 128, 128, 2, 2, 32, 500, id="band-wider-than-seq"),
        pytest.param(1, 128, 128, 2, 2, 32, 1, id="self-only-band"),
        pytest.param(1, 32, 128, 2, 2, 32, 40, id="band-sq-lt-sk"),
    ],
)
def test_banded_forward_matches_pallas(b, sq, sk, h, h_kv, d, window):
    q, k, v = _qkv(4, b, sq, sk, h, h_kv, d)
    want = np.asarray(_jax(q, k, v, True, window, block=32))
    out, _ = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)


def test_banded_gradients_match_pallas():
    q, k, v = _qkv(5, 1, 128, 128, 4, 2, 32)
    got = _grads_torch(q, k, v, True, window=40)
    want = _grads_jax(q, k, v, True, window=40, block=32)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=2e-3, err_msg=f"d{name} mismatch")


def test_plain_matches_einsum_path_in_bf16():
    """bf16 inputs: the plain flash version keeps the kernels' rounding
    points (P in bf16 before P v), so it stays within bf16 rounding of the
    einsum path."""
    q, k, v = (torch.tensor(x).to(torch.bfloat16) for x in _qkv(6, 1, 80, 80, 4, 2, 64))
    got, _ = fa.flash_attention_plain(q, k, v, causal=True)
    want = dot_product_attention(q, k, v, causal=True, use_flash=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize(
    "kw,match",
    [
        pytest.param({"causal": False, "window": 8}, "causal", id="window-without-causal"),
        pytest.param({"causal": True, "window": 0}, ">= 1", id="window-zero"),
    ],
)
def test_argument_errors_match_jax(kw, match):
    q, k, v = _qkv(7, 1, 64, 64, 2, 2, 32)
    with pytest.raises(ValueError, match=match):
        _jax(q, k, v, kw["causal"], kw["window"])
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)


def test_cpu_flash_with_window_refuses_like_jax():
    """The JAX package's off-TPU flash path has no band, and refuses it."""
    q = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="banded flash"):
        dot_product_attention(q, q, q, causal=True, use_flash=True, window=4)


def test_kernel_wrappers_check_their_inputs():
    """Shapes and types the kernels do not take raise before any launch,
    whatever the device (the checks come first)."""
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_cuda(q, q, q)
    with pytest.raises(TypeError, match="one dtype"):
        fa._check_cuda(q, q.double(), q)
    with pytest.raises(ValueError, match="last dim"):
        fa._check_cuda(torch.zeros(1, 8, 2, 64).transpose(1, 3), q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_forward_launch_config(dtype, d):
    """K1's launch at the training shape and at ragged ones: bf16 and fp16
    the Hopper kernel (a producer warpgroup and a consumer warpgroup for
    each 64 query rows: three at D 64, two at D 128), f32 the 64-row kernel;
    shared memory within a block's 232,448 bytes, and for the Hopper kernel
    room for Q and two stages of 128-key K and V tiles."""
    launch = fa.fwd_launch(dtype, 8, 32, 2048, d)
    if dtype == torch.float32:
        library, entry, rows, threads = "flash_attention", "flash_attention_fwd", 64, 128
    else:
        library, entry = "flash_fwd_sm90", "flash_fwd_sm90"
        rows, threads = (192, 512) if d == 64 else (128, 384)
        assert launch.smem_bytes >= (rows + 2 * 2 * 128) * d * 2
    assert (launch.library, launch.entry, launch.grid, launch.threads) == (
        library, entry, (256, -(-2048 // rows)), threads)
    for sq in (1, rows - 1, rows, rows + 1, 300):
        assert fa.fwd_launch(dtype, 2, 3, sq, d).grid == (6, -(-sq // rows))
    assert 0 < launch.smem_bytes <= 232_448
    assert fa.fwd_launch(dtype, 1, 1, 1, d).smem_bytes == launch.smem_bytes  # fixed by dtype and D alone


def test_forward_wrapper_refuses_strides_tma_cannot_read(monkeypatch):
    """A q view whose head stride is not a multiple of 16 bytes, or a
    broadcast (stride-0) k, raises ValueError in the wrapper before any
    kernel is built or launched."""
    from accelerate_tpu_torch.kernels import build

    def no_build(name):
        raise AssertionError(f"{name} built before the strides were checked")

    monkeypatch.setattr(build, "load", no_build)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 2, 76, dtype=torch.bfloat16)[..., :64]  # head stride 152 bytes
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd_kernel(q, k, k, True, 0.125, None)
    broadcast = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16).expand(1, 8, 2, 64)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_fwd_kernel(k, broadcast, broadcast, True, 0.125, None)
    before = fa.launches_fwd
    q32 = torch.zeros(1, 8, 2, 66)[..., :64]  # head stride 264 bytes
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd_kernel(q32, k.float(), k.float(), True, 0.125, None)
    assert fa.launches_fwd == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 3e-2), (torch.float16, 1e-2)])
def test_cuda_hopper_forward_matches_plain(dtype, atol, d):
    """The Hopper K1 against its plain version: ragged S, Sq < Sk, Sq > Sk
    (dead rows), non-causal and a band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)")
    for seed, (sq, sk, causal, window) in enumerate(((200, 200, True, None), (100, 300, False, None),
                                                     (300, 100, True, None), (200, 200, True, 16))):
        q, k, v = (torch.tensor(x).cuda().to(dtype) for x in _qkv(seed, 2, sq, sk, 8, 2, d))
        out, lse = fa.flash_fwd_kernel(q, k, v, causal, d**-0.5, window)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, d**-0.5, window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.float().cpu().numpy(), want_out.float().cpu().numpy(), atol=atol, rtol=atol)
        np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 1e-2)])
def test_cuda_kernels_match_plain(dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)")
    q, k, v = (torch.tensor(x).cuda().to(dtype) for x in _qkv(8, 2, 200, 200, 8, 2, 64))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0)).cuda().to(dtype)
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_fwd_kernel(q, k, v, True, 0.125, None)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, True, 0.125)
    delta = fa._delta(out, do)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, True, 0.125, None)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, True, 0.125, None)
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    want_dq = fa.flash_attention_plain_dq(q, k, v, do, lse, delta, True, 0.125)
    want_dk, want_dv = fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, True, 0.125)
    for got, want in ((out, want_out), (lse, want_lse), (dq, want_dq), (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_cuda_failing_loader_raises(monkeypatch):
    """On a CUDA tensor a kernel that cannot be built raises: no plain
    fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)")
    from accelerate_tpu_torch.kernels import build

    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load", broken)
    q = torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    before = fa.launches_fwd
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa.flash_attention(q, q, q, causal=True)
    assert fa.launches_fwd == before
