"""The port's einsum attention against the JAX package's ``_xla_attention``:
the policy's ``softmax_dtype``, the boolean mask, dropout, and what the
flash dispatch refuses. Inputs are made with numpy from a seed and given
to both packages; the port runs on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from accelerate_tpu.ops.attention import _xla_attention
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.ops.attention import dot_product_attention
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

# One bf16 ulp at outputs in [0.5, 1): the port takes the JAX package's
# rounding points (logits cast to bf16, max, exp, sum, divide each rounded
# in bf16), so it agrees to within this; an f32 softmax rounded once to
# bf16 differs by about 4 ulps (0.0156) on these inputs.
BF16_ATOL = 2.0**-8


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _inputs(seed, kv_heads, masked, s=24, heads=4, d=16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, s, heads, d)) * 2).astype(np.float32)
    k = (rng.standard_normal((2, s, kv_heads, d)) * 2).astype(np.float32)
    v = rng.standard_normal((2, s, kv_heads, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((2, 1, 1, s)) > 0.3
        mask[1] = False  # a fully masked batch row
    return q, k, v, mask


def _jax(q, k, v, mask, causal, softmax_dtype, dtype=jnp.bfloat16):
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    out = _xla_attention(jq, jk, jv, jm, causal, q.shape[-1] ** -0.5, 0.0, None, softmax_dtype)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, mask, causal, dtype=torch.bfloat16):
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    masks = {} if mask is None else {"mask": torch.from_numpy(mask)}
    return dot_product_attention(tq, tk, tv, causal=causal, **masks).float().numpy()


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True), (True, True)],
                         ids=["causal", "masked", "causal+masked"])
def test_bf16_softmax_dtype_follows_the_policy_as_jax_does(kv_heads, causal, masked):
    """Under MixedPrecisionPolicy(softmax_dtype="bfloat16") the einsum path
    computes its softmax in bf16 with the JAX package's rounding points:
    within one bf16 ulp of ``_xla_attention`` in bf16. The f32 softmax the
    port ran whatever the policy said misses that by more."""
    q, k, v, mask = _inputs(0, kv_heads, masked)
    want = _jax(q, k, v, mask, causal, "bfloat16")
    Accelerator(cpu=True, mixed_precision="bf16", kwargs_handlers=[MixedPrecisionPolicy(softmax_dtype="bfloat16")])
    got = _port(q, k, v, mask, causal)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    AcceleratorState._shared_state["dtype_policy"].softmax_dtype = None  # the f32 softmax, on the same inputs
    f32_softmax = _port(q, k, v, mask, causal)
    assert np.abs(f32_softmax - want).max() > BF16_ATOL
    np.testing.assert_allclose(f32_softmax, _jax(q, k, v, mask, causal, None), rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_f32_mask_matches_jax_and_a_fully_masked_row_is_uniform(kv_heads):
    q, k, v, mask = _inputs(1, kv_heads, masked=True)
    got = _port(q, k, v, mask, causal=False, dtype=torch.float32)
    np.testing.assert_allclose(got, _jax(q, k, v, mask, False, None, jnp.float32), rtol=0, atol=1e-5)
    # batch row 1 masks every key: the dtype's minimum, not -inf, so uniform weights (the mean of v), not NaN
    v_full = np.repeat(v, 4 // kv_heads, axis=2)
    np.testing.assert_allclose(got[1], np.broadcast_to(v_full[1].mean(0), got[1].shape), rtol=0, atol=1e-5)


def test_dropout_keeps_at_the_rate_scales_and_repeats_with_the_seed():
    """Uniform weights (q = 0) over 64 keys and v the identity: every output
    element is one weight, 1/64 kept or 0 dropped, times 1/(1 - rate)."""
    rate, s = 0.25, 64
    q = torch.zeros(2, s, 4, s)
    v = torch.eye(s).expand(2, s, s)[:, :, None, :].expand(2, s, 4, s).contiguous()

    def run(seed):
        return dot_product_attention(q, q, v, dropout_rate=rate, dropout_rng=torch.Generator().manual_seed(seed))

    out = run(0)
    kept = out != 0
    n = kept.numel()
    assert abs(kept.float().mean().item() - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)  # binomial error
    torch.testing.assert_close(out[kept], torch.full((int(kept.sum()),), 1 / s / (1 - rate)))
    assert torch.equal(run(0), out) and not torch.equal(run(1), out)
    # a rate with no generator, or a generator at rate 0, drops nothing
    torch.testing.assert_close(dot_product_attention(q, q, v, dropout_rate=rate), torch.full_like(out, 1 / s))
    torch.testing.assert_close(dot_product_attention(q, q, v, dropout_rng=torch.Generator()),
                               torch.full_like(out, 1 / s))


def test_flash_refuses_a_mask_or_dropout_and_the_auto_path_keeps_them_off_it(monkeypatch):
    q = torch.randn(1, 8, 2, 64, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(1, 1, 1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="mask=None"):
        dot_product_attention(q, q, q, mask=mask, use_flash=True)
    with pytest.raises(ValueError, match="dropout"):
        dot_product_attention(q, q, q, dropout_rate=0.1, dropout_rng=torch.Generator(), use_flash=True)
    # on the card at flash lengths the automatic dispatch would take the kernels; not with a mask or dropout
    from accelerate_tpu_torch.ops import attention

    monkeypatch.setattr(attention, "runs_on_card", lambda t: True)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 4)
    taken = []
    monkeypatch.setattr(attention, "flash_attention", lambda *a, **kw: taken.append(1))
    dot_product_attention(q, q, q, mask=mask)
    dot_product_attention(q, q, q, dropout_rate=0.1, dropout_rng=torch.Generator())
    assert taken == []
    dot_product_attention(q, q, q)
    assert taken == [1] and fa.flash_head_dim_ok(64)
