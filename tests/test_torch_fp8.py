"""fp8 mixed precision of the port (accelerate_tpu_torch.ops.fp8 and the
fp8 half of utils/quantization.py) against the JAX package's: the codes
and inverse scales of ``fp8_quantize`` bit for bit, ``_fp8_matmul``'s
forward and both gradients, the Dense pattern rule, the policy switch,
``scale_from_history``, ``FP8Dense``'s histories, a tiny Llama under the
delayed recipe (scanned and unrolled, remat on and off) and BERT-tiny under
the dynamic one, and the qkv-bias refusal.

fp8 training is chaotic across packages: an e4m3 code has 3 mantissa bits,
so an f32 rounding difference anywhere upstream (the two packages sum in
different orders) flips a code now and then, and Adam turns a gradient's
sign flip into a whole-``lr`` step. The multi-step parity tests therefore
teacher-force: every step starts both packages from the same weights and
histories (the JAX run's, carried across), with SGD (stateless), and hold
that step's loss, new histories and new weights. In f32 compute (the fp8
policy with its compute dtype set to f32 in both packages, the same code
paths) that is tight; in the real policy's bf16 compute the two packages
already differ by a few bf16 ulps before any fp8 product
(test_torch_train.py, test_torch_bert.py), so those cases are held to bf16
tolerances. The JAX side runs on the suite's 8-device CPU mesh (a batch of
8 sequences)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import BertConfig as JaxBertConfig
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import bert_classification_loss as jax_bert_loss
from accelerate_tpu.models import create_bert_model as jax_create_bert_model
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.models.llama import causal_lm_loss_state as jax_causal_lm_loss_state
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu.utils.dataclasses import Fp8RecipeKwargs as JaxFp8RecipeKwargs
from accelerate_tpu.utils.quantization import fp8_quantize as jax_fp8_quantize
from accelerate_tpu_torch import (
    Accelerator,
    BertConfig,
    Fp8RecipeKwargs,
    LlamaConfig,
    MixedPrecisionPolicy,
    bert_classification_loss,
    bert_params_from_jax,
    causal_lm_loss_state,
    create_bert_model,
    create_llama_model,
    llama_params_from_jax,
)
from accelerate_tpu_torch.modeling import flatten
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.quantization import FP8_E4M3_MAX, FP8_E5M2_MAX, fp8_dot, fp8_quantize

torch.set_num_threads(2)

SEQ, BATCH, STEPS, HIST, SGD_LR = 16, 8, 5, 8, 0.5
JAX_FP8 = {torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.float8_e5m2: jnp.float8_e5m2}


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _both(x: np.ndarray, dtype):
    """The same values in both packages, in ``dtype`` ("f32" | "bf16")."""
    j = jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (2^-7 relative, at least)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fp8_dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_quantize_codes_and_inverse_scale_bit_equal(dtype, fp8_dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 80)).astype(np.float32) * 7.0
    x[3, 5] = 0.0
    x[7, :4] = 1e-6  # deep in e4m3's subnormals after scaling
    jx, tx = _both(x, dtype)
    jcodes, jinv = jax_fp8_quantize(jx, JAX_FP8[fp8_dtype])
    codes, inv = fp8_quantize(tx, fp8_dtype)
    assert codes.dtype == fp8_dtype and inv.dtype == torch.float32 and inv.ndim == 0
    np.testing.assert_array_equal(codes.view(torch.uint8).numpy(), np.asarray(jcodes).view(np.uint8))
    assert np.float32(inv.item()) == np.asarray(jinv)  # bit for bit
    assert FP8_E4M3_MAX == 448.0 and FP8_E5M2_MAX == 57344.0


def test_fp8_quantize_all_zero_tensor():
    """amax is floored at 1e-12: zero codes and a finite inverse scale, as in JAX."""
    codes, inv = fp8_quantize(torch.zeros(4, 4))
    jcodes, jinv = jax_fp8_quantize(jnp.zeros((4, 4)))
    assert not codes.float().any() and np.float32(inv.item()) == np.asarray(jinv)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_matmul_forward_and_gradients_match_jax(dtype):
    """``x [B, S, K] @ w``: the port's ``w`` is the JAX ``rhs`` transposed.
    Forward, dlhs and drhs within 1e-5 of the output's RMS in f32 (the
    codes are equal; only the f32 sums' order differs) and one bf16 ulp in
    bf16; and the fp8 product stays near the exact one (the JAX tests'
    bars: 5% forward, 10% gradients)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 8, 64)).astype(np.float32)
    b = rng.normal(size=(64, 32)).astype(np.float32)
    g = rng.normal(size=(2, 8, 32)).astype(np.float32)
    ja, ta = _both(a, dtype)
    jb, tb = _both(b, dtype)
    jg, tg = _both(g, dtype)
    jy, vjp = jax.vjp(jfp8._fp8_matmul, ja, jb)
    jda, jdb = vjp(jg)
    ta.requires_grad_(True)
    tw = tb.t().contiguous().requires_grad_(True)
    y = fp8.fp8_matmul(ta, tw)
    y.backward(tg)
    assert y.dtype == ta.dtype and ta.grad.dtype == ta.dtype and tw.grad.dtype == tw.dtype
    for got, want in ((y, jy), (ta.grad, jda), (tw.grad.t(), jdb)):
        got, want = _np(got), np.asarray(want.astype(jnp.float32))
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.sqrt((want**2).mean()))
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    exact = a @ b
    assert np.abs(_np(y) - exact).max() / np.abs(exact).max() < 0.05
    for got, want in ((ta.grad, g @ b.T), (tw.grad.t(), a.reshape(-1, 64).T @ g.reshape(-1, 32))):
        assert np.abs(_np(got) - want).max() / np.abs(want).max() < 0.1


def test_fp8_dot_is_the_matmul_in_the_reference_layout():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(8, 32)).astype(np.float32), rng.normal(size=(32, 16)).astype(np.float32)
    got = fp8_dot(torch.from_numpy(a), torch.from_numpy(b))
    from accelerate_tpu.utils.quantization import fp8_dot as jax_fp8_dot

    want = jax_fp8_dot(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


def test_fp8_dot_general_pattern_rule():
    """The Dense contraction goes through fp8; a batched one is the exact
    product, as in the JAX function."""
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 3, 5)).astype(np.float32), rng.normal(size=(5, 7)).astype(np.float32)
    dn = (((2,), (0,)), ((), ()))
    got = fp8.fp8_dot_general(torch.from_numpy(a), torch.from_numpy(b), dn)
    want = jfp8.fp8_dot_general(jnp.asarray(a), jnp.asarray(b), dn)
    assert got.shape == (2, 3, 7)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
    c, d = rng.normal(size=(2, 5, 3)).astype(np.float32), rng.normal(size=(2, 3, 4)).astype(np.float32)
    dn_b = (((2,), (1,)), ((0,), (0,)))
    got = fp8.fp8_dot_general(torch.from_numpy(c), torch.from_numpy(d), dn_b)
    np.testing.assert_allclose(_np(got), np.asarray(jax.lax.dot_general(c, d, dn_b)), rtol=1e-6)
    # a contraction over the rhs's last dim and a free lhs dim in front
    dn_t = (((2,), (1,)), ((), ()))
    e = rng.normal(size=(4, 5)).astype(np.float32)
    np.testing.assert_allclose(_np(fp8.fp8_dot_general(torch.from_numpy(a), torch.from_numpy(e), dn_t)),
                               np.asarray(jax.lax.dot_general(a, e, dn_t)), rtol=1e-6)


def test_fp8_policy_enabled_via_mixed_precision():
    """``mixed_precision="fp8"``: bf16 compute with ``fp8=True`` (the
    refusal it met before is gone), the dynamic recipe unless a handler
    says otherwise, and the zoo's dense layer takes the fp8 product under
    it and ``F.linear`` otherwise."""
    assert not fp8.fp8_enabled() and fp8.fp8_recipe() is None
    policy = MixedPrecisionPolicy.from_mixed_precision("fp8")
    assert (policy.compute_dtype, policy.fp8) == ("bfloat16", True)
    assert MixedPrecisionPolicy(fp8=True).fp8
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    assert fp8.fp8_enabled()
    layer = fp8.PolicyLinear(32, 16)
    x = torch.randn(4, 32)
    want = fp8.fp8_matmul(x, layer.weight) + layer.bias
    torch.testing.assert_close(layer(x), want, rtol=0, atol=0)  # the policy's product: fp8
    assert fp8.fp8_recipe().delayed_scaling is False
    assert acc.state.dtype_policy.fp8_recipe == Fp8RecipeKwargs(delayed_scaling=False)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    Accelerator(cpu=True, mixed_precision="bf16")
    torch.testing.assert_close(layer(x), torch.nn.functional.linear(x, layer.weight, layer.bias), rtol=0, atol=0)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    Accelerator(cpu=True, mixed_precision="fp8", kwargs_handlers=[Fp8RecipeKwargs(amax_history_len=4, margin=1)])
    assert fp8.fp8_recipe() == Fp8RecipeKwargs(amax_history_len=4, margin=1)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    with pytest.raises(ValueError, match="fp8"):
        Accelerator(cpu=True, mixed_precision="bf16", kwargs_handlers=[MixedPrecisionPolicy(fp8=True)])
    with pytest.raises(ValueError, match="amax_compute_algo"):
        Fp8RecipeKwargs(amax_compute_algo="mean")
    with pytest.raises(ValueError, match="amax_history_len"):
        Fp8RecipeKwargs(amax_history_len=0)


def test_scale_from_history_recipe():
    hist = np.asarray([2.0, 8.0, 4.0], np.float32)
    for kw in ({}, {"algo": "most_recent"}, {"margin": 1}, {"margin": 2, "algo": "most_recent"}):
        got = fp8.scale_from_history(torch.from_numpy(hist), **kw)
        assert got.dtype == torch.float32
        assert got.item() == float(jfp8.scale_from_history(jnp.asarray(hist), **kw))
    assert fp8.scale_from_history(torch.from_numpy(hist)).item() == pytest.approx(fp8.E4M3_MAX / 8.0)
    for algo in ("max", "most_recent"):  # an unwarmed history: the neutral scale
        assert fp8.scale_from_history(torch.zeros(4), algo=algo).item() == 1.0
        assert float(jfp8.scale_from_history(jnp.zeros(4), algo=algo)) == 1.0


def test_fp8_dense_histories_after_k_calls_equal_jax():
    """Three calls of FP8Dense (weights and histories carried across; flax's
    init already ran one forward, so the histories start with one entry),
    the input doubling each time: outputs within 1e-5 of their RMS,
    histories bit-equal, newest first; nothing written to the port's
    buffers."""
    layer = jfp8.FP8Dense(32, amax_history_len=4)
    x = np.asarray(jax.random.normal(jax.random.key(0), (8, 16), jnp.float32))
    variables = layer.init(jax.random.key(1), jnp.asarray(x))
    port = fp8.FP8Dense(16, 32, amax_history_len=4)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["kernel"]).T.copy()))
    history = {k: torch.from_numpy(np.array(v)) for k, v in variables["fp8"].items()}
    for k in range(3):
        xk = x * 2.0**k
        jy, mutated = layer.apply(variables, jnp.asarray(xk), mutable=["fp8"])
        variables = {**variables, **mutated}
        y, history = port(torch.from_numpy(xk), history)
        want = np.asarray(jy)
        np.testing.assert_allclose(_np(y), want, rtol=0, atol=1e-5 * np.sqrt((want**2).mean()))
        for name in ("amax_history_x", "amax_history_k"):
            np.testing.assert_array_equal(history[name].numpy(), np.asarray(mutated["fp8"][name]))
        if k == 0:  # in range (later calls clip: their scales come from the smaller inputs before)
            exact = x @ port.weight.detach().numpy().T
            assert np.linalg.norm(_np(y) - exact) / np.linalg.norm(exact) < 0.06
    assert history["amax_history_x"][0].item() == pytest.approx(4 * np.abs(x).max(), rel=1e-6)
    assert not port.amax_history_x.any() and not port.amax_history_k.any()


# ---------------------------------------------------------------------- #
# the delayed recipe on a tiny Llama, teacher-forced against JAX
# ---------------------------------------------------------------------- #


def _token_batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=(BATCH, SEQ)).astype(np.int32) for _ in range(STEPS)]


def _set_compute(acc, compute: str):
    """The fp8 policy with its compute dtype set to f32 ("f32"), or as it
    is (bf16): done on the live policy, the same in both packages."""
    if compute == "f32":
        acc.state.dtype_policy.compute_dtype = "float32"


@functools.cache
def _jax_delayed_run(scan: bool, remat: bool, compute: str):
    """The JAX step's trajectory: each step's weights and fp8 state before
    it (numpy), its loss, and the weights and state after the last."""
    acc = JaxAccelerator(mixed_precision="fp8", kwargs_handlers=[JaxFp8RecipeKwargs(amax_history_len=HIST)])
    _set_compute(acc, compute)
    model = jax_create_llama_model(JaxLlamaConfig.tiny(scan_layers=scan, remat=remat), seed=3, seq_len=SEQ)
    model = acc.prepare_model(model)
    acc.prepare_optimizer(optax.sgd(SGD_LR))
    step = acc.build_train_step(lambda p, s, b: jax_causal_lm_loss_state(p, s, b, model.apply_fn), has_state=True)
    snaps, losses = [], []
    for ids in _token_batches():
        snaps.append((jax.tree.map(np.asarray, model.params), jax.tree.map(np.asarray, model.state)))
        losses.append(float(step(jax.device_put({"input_ids": jnp.asarray(ids)}, batch_sharding(acc.mesh)))))
    snaps.append((jax.tree.map(np.asarray, model.params), jax.tree.map(np.asarray, model.state)))
    return snaps, losses


def _port_delayed(scan: bool, remat: bool, compute: str):
    acc = Accelerator(cpu=True, mixed_precision="fp8", kwargs_handlers=[Fp8RecipeKwargs(amax_history_len=HIST)])
    _set_compute(acc, compute)
    cfg = LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny(scan_layers=scan, remat=remat)))
    model = create_llama_model(cfg, device="cpu")
    opt = torch.optim.SGD(model.module.parameters(), lr=SGD_LR)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step(lambda p, s, b: causal_lm_loss_state(p, s, b, model.apply_fn), has_state=True)
    return cfg, model, step


def _update_err(got: dict, want: dict, before: dict) -> float:
    """||port update - JAX update|| / ||JAX update|| over the weights (the
    amax histories left out): a code flip moves a few elements of one
    step's update, so the update as a whole is the stable measure."""
    num = den = 0.0
    for name, w in want.items():
        if "amax_history" not in name:
            num += float(((got[name] - w) ** 2).sum())
            den += float(((w - before[name]) ** 2).sum())
    return (num / den) ** 0.5


# (loss abs, history rel, update rel). f32 compute is the fp8 paths alone:
# measured 9.5e-7, 1.4e-7 and 1.7e-4 over the four layouts. bf16 compute
# adds the packages' bf16 differences, which fp8's codes amplify: measured
# 0.011, 0.066 and 0.16 (scanned, remat)
DELAYED_TOL = {"f32": (1e-4, 1e-5, 1e-3), "bf16": (2e-2, 0.1, 0.25)}


@pytest.mark.parametrize(
    "scan,remat,compute",
    [(True, True, "f32"), (True, False, "f32"), (False, True, "f32"), (False, False, "f32"), (True, True, "bf16")],
    ids=["scanned-remat-f32", "scanned-f32", "unrolled-remat-f32", "unrolled-f32", "scanned-remat-bf16"],
)
def test_delayed_llama_matches_jax_step_by_step(scan, remat, compute):
    """Five steps of ``build_train_step(has_state=True)`` with
    ``causal_lm_loss_state``, each from the JAX run's weights and
    histories: the loss, the new histories (one new entry a step, remat
    or not) and the weights' update against the JAX step's. Both layouts
    and remat on and off in f32 compute; the bf16 policy on one."""
    snaps, want_losses = _jax_delayed_run(scan, remat, compute)
    cfg, model, step = _port_delayed(scan, remat, compute)
    assert model.state is not None and set(model.state) == {"fp8"}
    loss_tol, hist_rel, update_rel = DELAYED_TOL[compute]
    for i, ids in enumerate(_token_batches()):
        params, state = snaps[i]
        model.load_state_dict(llama_params_from_jax(params, cfg, state))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loss = float(step({"input_ids": torch.from_numpy(ids)}))
        assert abs(loss - want_losses[i]) <= loss_tol, (i, loss, want_losses[i])
        want = llama_params_from_jax(snaps[i + 1][0], cfg, snaps[i + 1][1])
        got = model.state_dict()
        for name, w in want.items():
            if "amax_history" in name:
                g = got[name].numpy()
                assert np.count_nonzero(g) == min(np.count_nonzero(before[name].numpy()) + 1, HIST), (name, g)
                np.testing.assert_allclose(g, w.numpy(), rtol=hist_rel, atol=0, err_msg=f"step {i} {name}")
        assert _update_err(got, want, before) <= update_rel, i


def test_remat_rolls_the_histories_once_and_quantizes_with_the_forward_scales():
    """The trap of remat: torch.utils.checkpoint runs a layer's forward
    again in the backward. Three free-running steps with remat give the
    losses, weights and histories of the run without it, bit for bit, and
    each history holds three new entries; every projection's product runs
    four times a step with remat (forward, recompute, dlhs, drhs), three
    without."""
    runs = {}
    calls = {"n": 0}
    real = fp8.fp8_mm_plain

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    fp8.fp8_mm_plain = counting
    try:
        for remat in (True, False):
            for cls in (AcceleratorState, GradientState, PartialState):
                cls._reset_state()
            cfg, model, step = _port_delayed(True, remat, "f32")
            snaps, _ = _jax_delayed_run(True, True, "f32")
            model.load_state_dict(llama_params_from_jax(snaps[0][0], cfg, snaps[0][1]))
            entries = {k: int(torch.count_nonzero(v)) for k, v in model.state_dict().items() if "amax" in k}
            calls["n"] = 0
            losses = [float(step({"input_ids": torch.from_numpy(ids)})) for ids in _token_batches()[:3]]
            runs[remat] = (losses, {k: v.clone() for k, v in model.state_dict().items()}, calls["n"])
    finally:
        fp8.fp8_mm_plain = real
    assert runs[True][0] == runs[False][0]
    for name, t in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][name], t, rtol=0, atol=0, msg=name)
        if "amax_history" in name:  # flax's init ran one forward: the carried histories start with an entry
            assert int(torch.count_nonzero(t)) == entries[name] + 3, name
    n_proj = 7 * cfg.num_hidden_layers
    assert runs[True][2] == 4 * n_proj * 3 and runs[False][2] == 3 * n_proj * 3


def test_delayed_recipe_refuses_a_qkv_bias():
    Accelerator(cpu=True, mixed_precision="fp8", kwargs_handlers=[Fp8RecipeKwargs()])
    with pytest.raises(NotImplementedError, match="FP8Dense .delayed scaling. has no bias"):
        create_llama_model(LlamaConfig.tiny(qkv_bias=True), device="cpu")
    with pytest.raises(NotImplementedError, match="FP8Dense .delayed scaling. has no bias"):
        jax_acc = JaxAccelerator(mixed_precision="fp8", kwargs_handlers=[JaxFp8RecipeKwargs()])
        assert jax_acc
        jax_create_llama_model(JaxLlamaConfig.tiny(qkv_bias=True), seq_len=SEQ)
    # the dynamic recipe keeps the bias: a PolicyLinear
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    Accelerator(cpu=True, mixed_precision="fp8")
    model = create_llama_model(LlamaConfig.tiny(qkv_bias=True), device="cpu")
    assert isinstance(model.module.layers[0].attn.q_proj, fp8.PolicyLinear) and model.state is None


# ---------------------------------------------------------------------- #
# BERT-tiny under the dynamic recipe
# ---------------------------------------------------------------------- #


def _bert_batches(n=3, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((batch, SEQ), bool)
        mask[::3, 12:] = False
        out.append({"input_ids": rng.integers(0, 1024, (batch, SEQ)).astype(np.int32), "attention_mask": mask,
                    "labels": rng.integers(0, 2, (batch,)).astype(np.int32)})
    return out


# (loss abs, update rel): measured 2.4e-7 and 7.6e-7 in f32 compute, 0.012
# and 0.053 in bf16 (the bf16 loss bar is test_torch_train.py's)
BERT_TOL = {"f32": (1e-5, 1e-4), "bf16": (2e-2, 0.1)}


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_fp8_bert_tiny_matches_jax_step_by_step(compute):
    """The JAX fp8 BERT-tiny (2 layers) and the port's, every step from the
    JAX run's weights (SGD): losses and new weights. All six dense layers
    of each encoder layer take the fp8 product in both; the pooler and the
    classifier do not."""
    jcfg = JaxBertConfig.tiny(num_hidden_layers=2)
    jacc = JaxAccelerator(mixed_precision="fp8")
    _set_compute(jacc, compute)
    jmodel = jacc.prepare_model(jax_create_bert_model(jcfg, seed=1, seq_len=SEQ))
    jacc.prepare_optimizer(optax.sgd(0.1))
    jstep = jacc.build_train_step(lambda p, b: jax_bert_loss(p, b, jmodel.apply_fn))
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    _set_compute(acc, compute)
    model = create_bert_model(cfg, device="cpu")
    model, _ = acc.prepare(model, torch.optim.SGD(model.module.parameters(), lr=0.1))
    step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
    kinds = {type(m).__name__ for n, m in model.module.named_modules() if n.endswith(("query", "intermediate"))}
    assert kinds == {"PolicyLinear"} and type(model.module.classifier).__name__ == "Linear"
    loss_tol, update_rel = BERT_TOL[compute]
    launches = fp8.launches
    for batch in _bert_batches():
        model.load_state_dict(bert_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        want = float(jstep(jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                          batch_sharding(jacc.mesh))))
        got = float(step({k: torch.from_numpy(v) for k, v in batch.items()}))
        assert abs(got - want) <= loss_tol, (got, want)
        want_params = bert_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg)
        assert _update_err(model.state_dict(), want_params, before) <= update_rel
    assert fp8.launches == launches  # CPU tensors: the plain version, no launch counted


def test_fp8_bert_loss_tracks_bf16():
    """The JAX package's bar for fp8 (tests/test_fp8.py::
    test_fp8_loss_parity_vs_bf16): twelve AdamW steps of BERT-tiny on one
    batch in fp8 fall to under half the first loss and stay within 0.1 of
    the bf16 run's losses."""
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(0, 64, size=(16, 16)).astype(np.int64)),
             "attention_mask": torch.ones(16, 16, dtype=torch.bool),
             "labels": torch.from_numpy(rng.integers(0, 2, size=(16,)).astype(np.int64))}
    runs = {}
    for mp in ("bf16", "fp8"):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        acc = Accelerator(cpu=True, mixed_precision=mp)
        model = create_bert_model(BertConfig.tiny(), seq_len=16, seed=0, device="cpu")
        model, _ = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=5e-4))
        step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
        runs[mp] = [float(step(batch)) for _ in range(12)]
    assert runs["fp8"][-1] < 0.5 * runs["fp8"][0], runs
    assert max(abs(a - b) for a, b in zip(runs["bf16"], runs["fp8"])) < 0.1, runs


# ---------------------------------------------------------------------- #
# the wrapper's device rule (its twin on the card: test_torch_fp8_cuda.py)
# ---------------------------------------------------------------------- #


def test_fp8_mm_runs_its_plain_version_only_on_the_cpu():
    a8, _ = fp8_quantize(torch.randn(16, 32))
    b8, _ = fp8_quantize(torch.randn(32, 16))
    before = fp8.launches
    out = fp8.fp8_mm(a8, b8, torch.tensor(0.5), torch.float32)
    torch.testing.assert_close(out, (a8.float() @ b8.float()) * 0.5, rtol=0, atol=0)
    out = fp8.fp8_mm(a8, b8, torch.tensor(0.5), torch.bfloat16, divide=True)
    torch.testing.assert_close(out, ((a8.float() @ b8.float()) / 0.5).bfloat16(), rtol=0, atol=0)
    assert fp8.launches == before
    meta = fp8.fp8_mm(a8.to("meta"), b8.to("meta"), torch.tensor(0.5, device="meta"), torch.float32)
    assert meta.shape == (16, 16) and meta.device.type == "meta"
