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


# The families' head dims: Phi-3-mini's 96 (run at the built width 128) and
# Gemma's 256, the plain versions against the Pallas kernel in interpret
# mode (its blocks keep the head dim whole), causal and banded, GQA/MQA.
WIDE_CASES = [
    pytest.param(1, 100, 100, 4, 4, 96, None, id="d96-mha-causal"),
    pytest.param(1, 128, 128, 4, 4, 96, 40, id="d96-mha-band"),
    pytest.param(1, 100, 100, 4, 1, 256, None, id="d256-mqa-causal"),
    pytest.param(1, 128, 128, 4, 2, 256, 17, id="d256-gqa-band"),
]


@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,window", WIDE_CASES)
def test_wide_head_dim_forward_matches_pallas(b, sq, sk, h, h_kv, d, window):
    q, k, v = _qkv(14, b, sq, sk, h, h_kv, d)
    want = np.asarray(_jax(q, k, v, True, window, block=32))
    out, lse = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True, window=window)
    assert out.shape == (b, sq, h, d) and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,window", WIDE_CASES)
def test_wide_head_dim_gradients_match_pallas(b, sq, sk, h, h_kv, d, window):
    q, k, v = _qkv(15, b, sq, sk, h, h_kv, d)
    got = _grads_torch(q, k, v, True, window=window)
    want = _grads_jax(q, k, v, True, window=window, block=32)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=2e-3, err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("window", [None, 33], ids=["causal", "band"])
def test_bf16_wide_head_dim_plain_forward_matches_pallas(d, window):
    """bf16 at the families' head dims, held as the D 64 and 128 cases are
    (below): 2e-2 of |ref| + RMS(ref), FLASH_TOL's bf16 output tolerance."""
    q, k, v = _qkv(16, 1, 160, 160, 4, 1, d)
    want = np.asarray(pallas_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
                                             window=window, interpret=True).astype(jnp.float32))
    got, _ = fa.flash_attention_plain(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)), causal=True,
                                      window=window)
    gap = np.abs(got.float().numpy() - want)
    assert (gap <= 2e-2 * (np.abs(want) + np.sqrt((want**2).mean()))).all(), gap.max()


@pytest.mark.parametrize("d", [96, 256])
def test_auto_dispatch_takes_the_families_head_dims(monkeypatch, d):
    """On the card a long sequence at D 96 or 256 now goes to the flash
    kernels (here their plain versions), and gives the einsum path's answer."""
    attention, calls = _spy_dispatch(monkeypatch)
    q, k, v = (torch.tensor(x) for x in _qkv(17, 1, 32, 32, 4, 2, d))
    got = attention.dot_product_attention(q, k, v, causal=True)
    assert calls == [d]
    want = attention.dot_product_attention(q, k, v, causal=True, use_flash=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


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
    q = torch.zeros(1, 8, 2, 40)
    with pytest.raises(ValueError, match="head_dim 36"):
        fa._check_cuda(*(torch.zeros(1, 8, 2, 36),) * 3)
    with pytest.raises(TypeError, match="one dtype"):
        fa._check_cuda(q, q.double(), q)
    with pytest.raises(ValueError, match="last dim"):
        fa._check_cuda(torch.zeros(1, 8, 2, 64).transpose(1, 3), q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plain_forward_takes_the_kernels_key_tile(dtype):
    """block_k=None is K1's own key tile for the dtype and D (128 for the
    16-bit Hopper kernel, 64 for f32): the oracle rounds P where K1 does."""
    q, k, v = (torch.tensor(x).to(dtype) for x in _qkv(9, 1, 300, 300, 4, 2, 64))
    keys = fa.fwd_launch(dtype, 1, 4, 300, 64).keys
    assert keys == (64 if dtype == torch.float32 else 128)
    default = fa.flash_attention_plain(q, k, v, causal=True)
    own = fa.flash_attention_plain(q, k, v, causal=True, block_k=keys)
    assert torch.equal(default[0], own[0]) and torch.equal(default[1], own[1])


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,h_kv,d,causal", CASES[1:])
def test_plain_forward_matches_pallas_at_either_tile(block, b, sq, sk, h, h_kv, d, causal):
    """In f32 the key tile only orders the online softmax's sums: the plain
    forward at 64 and at 128 keys matches the Pallas kernel at the same
    block within 2e-5."""
    q, k, v = _qkv(10, b, sq, sk, h, h_kv, d)
    want = np.asarray(_jax(q, k, v, causal, block=block))
    out, _ = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal, block_k=block)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)


# bf16: the port's plain forward rounds P every 128 keys (K1's tile), the
# Pallas kernel every block_k = min(512, pow2 >= Sk) keys, each against its
# own running max. Measured gap on these cases: at most 1.95e-3 absolute,
# 0.0055 of |ref| + RMS(ref); held to 2e-2 of it, the bf16 output tolerance
# chip_smoke.py holds K1 to (FLASH_TOL).
@pytest.mark.parametrize(
    "b,s,h,h_kv,d,causal",
    [
        pytest.param(1, 300, 4, 2, 64, True, id="gqa-causal-d64"),
        pytest.param(1, 256, 4, 1, 64, False, id="mqa-noncausal-d64"),
        pytest.param(2, 200, 4, 2, 128, True, id="gqa-causal-d128"),
    ],
)
def test_bf16_plain_forward_matches_pallas(b, s, h, h_kv, d, causal):
    q, k, v = _qkv(11, b, s, s, h, h_kv, d)
    want = np.asarray(pallas_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
                                             interpret=True).astype(jnp.float32))
    got, _ = fa.flash_attention_plain(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    gap = np.abs(got.float().numpy() - want)
    assert (gap <= 2e-2 * (np.abs(want) + np.sqrt((want**2).mean()))).all(), gap.max()


def test_flash_head_dim_predicate():
    """One test of the head dims K1-K3 take, shared by the wrappers and the
    dispatch: every multiple of 8 from 16 to 256 (Stable Diffusion's 40
    among them), each run at the built width (64, 128 or 256) that holds
    it."""
    taken = [d for d in range(0, 290, 4) if fa.flash_head_dim_ok(d)]
    assert taken == list(range(16, 257, 8))
    assert [fa.kernel_width(d) for d in (16, 40, 64, 72, 96, 128, 136, 208, 256)] == [64] * 3 + [128] * 3 + [256] * 3
    for d in (8, 36, 264):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            fa._check_cuda(*(torch.zeros(1, 8, 2, d),) * 3)
    for d in (16, 40, 96, 256):
        fa._check_cuda(*(torch.zeros(1, 8, 2, d),) * 3)


def _spy_dispatch(monkeypatch):
    """dot_product_attention as if on the card (runs_on_card true), with
    FLASH_MIN_SEQ at 16 and flash_attention replaced by a recorder that
    computes the plain version."""
    from accelerate_tpu_torch.ops import attention

    calls = []

    def spy(q, k, v, **kw):
        calls.append(q.shape[-1])
        return fa.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(attention, "runs_on_card", lambda t: True)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 16)
    monkeypatch.setattr(attention, "flash_attention", spy)
    return attention, calls


@pytest.mark.parametrize("d", [8, 36, 272])
def test_auto_dispatch_keeps_other_head_dims_on_einsum(monkeypatch, d):
    """On the card, use_flash=None sends a long sequence to the flash
    kernels only at a head dim they take; any other stays on the einsum
    path (and gives its answer). D 64 goes to flash, for contrast."""
    attention, calls = _spy_dispatch(monkeypatch)
    q, k, v = (torch.tensor(x) for x in _qkv(12, 1, 32, 32, 4, 2, d))
    got = attention.dot_product_attention(q, k, v, causal=True)
    assert calls == []
    want = attention.dot_product_attention(q, k, v, causal=True, use_flash=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    q64, k64, v64 = (torch.tensor(x) for x in _qkv(12, 1, 32, 32, 4, 2, 64))
    attention.dot_product_attention(q64, k64, v64, causal=True)
    assert calls == [64]


@pytest.mark.parametrize("d", [8, 36, 272])
def test_explicit_flash_with_other_head_dim_raises_on_the_card(monkeypatch, d):
    """use_flash=True on the card at a head dim the kernels do not take
    raises, naming it: no fallback to the einsum path."""
    attention, calls = _spy_dispatch(monkeypatch)
    q, k, v = (torch.tensor(x) for x in _qkv(13, 1, 32, 32, 4, 2, d))
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        attention.dot_product_attention(q, k, v, causal=True, use_flash=True)
    assert calls == []


@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_backward_launch_config(dtype, d):
    """K2 and K3's launches, bwd_launch against the grid and threads
    kernel_check records on meta tensors: bf16 and fp16 the Hopper kernels
    (K2 three consumer warpgroups at D 64, two at D 96 and 128 and one at D
    256; K3 two, on 64 key rows each, or at D 256 on the same 64 rows, each
    beside a producer warpgroup), f32 the 64-row kernels (32 rows at D 256,
    K3 two blocks a key tile); shared memory within a block's 232,448
    bytes."""
    from accelerate_tpu_torch.analysis import kernel_check

    b, s, h, hkv = 2, 300, 8, 2
    dq = fa.bwd_launch("dq", dtype, b, h, hkv, s, s, d)
    dkv = fa.bwd_launch("dkv", dtype, b, h, hkv, s, s, d)
    w, halves = fa.kernel_width(d), 1
    if dtype == torch.float32:
        assert (dq.library, dq.entry, dkv.entry) == ("flash_attention", "flash_attention_dq", "flash_attention_dkv")
        q_rows = k_rows = 32 if w == 256 else 64
        dq_threads = dkv_threads = 2 * q_rows
        halves = 2 if w == 256 else 1
    else:
        assert (dq.library, dq.entry, dkv.entry) == ("flash_bwd_sm90", "flash_dq_sm90", "flash_dkv_sm90")
        q_rows, dq_threads = {64: (192, 512), 128: (128, 384), 256: (64, 256)}[w]
        k_rows, dkv_threads = (64 if w == 256 else 128), 384
        assert dkv.smem_bytes >= (2 * k_rows + 2 * 2 * 64) * w * 2 and dq.smem_bytes >= (2 * q_rows + 2 * 2 * 64) * w * 2
    assert (dq.grid, dq.threads) == ((b * h, -(-s // q_rows)), dq_threads)
    assert (dkv.grid, dkv.threads) == ((b * hkv * halves, -(-s // k_rows)), dkv_threads)
    assert 0 < dq.smem_bytes <= 232_448 and 0 < dkv.smem_bytes <= 232_448
    with pytest.raises(ValueError, match="kind"):
        fa.bwd_launch("fwd", dtype, b, h, hkv, s, s, d)

    def step(q, k, v):
        q.requires_grad_(True)
        out = fa.flash_attention(q, k, v, causal=True)
        out.float().sum().backward()
        return out

    meta = [torch.empty(shape, dtype=dtype, device="meta") for shape in ((b, s, h, d), (b, s, hkv, d))]
    sites = {site.kernel_name: (site.grid, site.threads)
             for site in kernel_check(step, meta[0], meta[1], meta[1], probe=False).sites}
    assert sites["flash_attention_dq"] == (dq.grid, dq.threads)
    assert sites["flash_attention_dkv"] == (dkv.grid, dkv.threads)


@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_forward_launch_config(dtype, d):
    """K1's launch at the training shape and at ragged ones: bf16 and fp16
    the Hopper kernel (a producer warpgroup and a consumer warpgroup for
    each 64 query rows: three at D 64, two at D 96, 128 and 256), f32 the
    64-row kernel (32 rows at D 256); shared memory within a block's 232,448
    bytes, and for the Hopper kernel room for Q and two stages of K and V
    tiles of 128 keys (64 at D 256)."""
    launch = fa.fwd_launch(dtype, 8, 32, 2048, d)
    w = fa.kernel_width(d)
    if dtype == torch.float32:
        library, entry = "flash_attention", "flash_attention_fwd"
        rows = 32 if w == 256 else 64
        threads, keys = 2 * rows, rows
    else:
        library, entry = "flash_fwd_sm90", "flash_fwd_sm90"
        rows, threads = (192, 512) if w == 64 else (128, 384)
        keys = 64 if w == 256 else 128
        assert launch.smem_bytes >= (rows + 2 * 2 * keys) * w * 2
    assert launch.keys == keys
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
@pytest.mark.parametrize("d", [64, 96, 128, 256])
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
@pytest.mark.parametrize("d", [64, 96, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 1e-2)])
def test_cuda_kernels_match_plain(dtype, atol, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)")
    q, k, v = (torch.tensor(x).cuda().to(dtype) for x in _qkv(8, 2, 200, 200, 8, 2, d))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0)).cuda().to(dtype)
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    scale = d**-0.5
    out, lse = fa.flash_fwd_kernel(q, k, v, True, scale, None)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, True, scale)
    delta = fa._delta(out, do)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, True, scale, None)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, True, scale, None)
    torch.cuda.synchronize()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    want_dq = fa.flash_attention_plain_dq(q, k, v, do, lse, delta, True, scale)
    want_dk, want_dv = fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, True, scale)
    for got, want in ((out, want_out), (lse, want_lse), (dq, want_dq), (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_hopper_backward_matches_plain(dtype, d):
    """The Hopper K2 and K3 against their plain versions, per element within
    chip_smoke.py's FLASH_TOL (t (|ref| + RMS(ref)) + 2e-5 RMS(dO)): GQA 4
    and 8, ragged S, Sq < Sk, Sq > Sk (dead rows, lse -inf), non-causal and
    a band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode (chip_smoke.py runs them on the H100)")
    tol = {torch.bfloat16: {"dq": 5e-2, "dk": 2e-2, "dv": 3e-2}, torch.float16: {"dq": 1e-2, "dk": 5e-3, "dv": 5e-3}}
    cases = ((200, 200, 8, 2, True, None), (100, 300, 8, 1, False, None), (300, 100, 8, 1, True, None),
             (200, 200, 8, 2, True, 16))
    for seed, (sq, sk, h, h_kv, causal, window) in enumerate(cases):
        q, k, v = (torch.tensor(x).cuda().to(dtype) for x in _qkv(20 + seed, 2, sq, sk, h, h_kv, d))
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed)).cuda().to(dtype)
        out, lse = fa.flash_fwd_kernel(q, k, v, causal, d**-0.5, window)
        delta = fa._delta(out, do)
        before = (fa.launches_dq, fa.launches_dkv)
        got = {"dq": fa.flash_dq_kernel(q, k, v, do, lse, delta, causal, d**-0.5, window)}
        got["dk"], got["dv"] = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal, d**-0.5, window)
        torch.cuda.synchronize()
        assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
        want = {"dq": fa.flash_attention_plain_dq(q, k, v, do, lse, delta, causal, d**-0.5, window)}
        want["dk"], want["dv"] = fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, causal, d**-0.5, window)
        floor = 2e-5 * do.float().pow(2).mean().sqrt()
        for name in ("dq", "dk", "dv"):
            err = (got[name] - want[name]).abs()
            limit = tol[dtype][name] * (want[name].abs() + want[name].pow(2).mean().sqrt()) + floor
            assert bool((err <= limit).all()), (name, sq, sk, causal, window, float((err / limit).max()))


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
