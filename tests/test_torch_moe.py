"""The port's MoE (accelerate_tpu_torch.ops.moe) and its two families
(models/mixtral.py, models/qwen3_moe.py) against the JAX package's.

Routing: ``top_k_routing`` at several (T, E, k, capacity) settings, with
``norm_topk`` on and off, exact ties (the first index wins) and overflow
(choices dropped in round-then-token order): ``dispatch`` equal,
``combine`` and the aux loss within 1e-6. ``moe_ffn`` and ``MoEBlock`` in
f32 within 1e-5, their gradients against ``jax.grad`` within 1e-4. The
families at their ``tiny()`` configs on the same weights (carried by
``mixtral_params_from_jax``, the norms moved off their identity init):
logits in f32 and in bf16 compute, the per-layer aux losses,
``mixtral_lm_loss`` with its aux term, one AdamW step through
``build_train_step`` against the JAX Accelerator's. Inputs are made with
numpy from a seed; everything runs on the CPU."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu.models as jm
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.ops import moe as jmoe
from accelerate_tpu.parallel.mesh import batch_sharding
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import mixtral_params_from_jax
from accelerate_tpu_torch.ops import moe
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

ROUTE_ATOL = 1e-6
F32_ATOL = 1e-5
GRAD_ATOL = 1e-4
LOSS_RTOL = PARAM_ATOL = 1e-4
SEQ, BATCH, LR, WD = 16, 8, 1e-3, 0.01

# family -> (config class, create function, loss)
FAMILIES = {
    "mixtral": ("MixtralConfig", "create_mixtral_model", "mixtral_lm_loss"),
    "qwen3_moe": ("Qwen3MoeConfig", "create_qwen3_moe_model", "qwen3_moe_lm_loss"),
}


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _logits(t, e, seed):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32) * 2


def _route_both(logits, k, capacity, norm_topk):
    want = jmoe.top_k_routing(jnp.asarray(logits), k, capacity, norm_topk=norm_topk)
    got = moe.top_k_routing(torch.tensor(logits), k, capacity, norm_topk=norm_topk)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_routing_equal(want, got):
    (wd, wc, wa), (gd, gc, ga) = want, got
    assert gd.dtype == np.bool_ and gd.shape == wd.shape
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_allclose(gc, wc, atol=ROUTE_ATOL, rtol=0)
    np.testing.assert_allclose(ga, wa, atol=ROUTE_ATOL, rtol=0)


# (T, E, k, capacity): roomy, overflowing, every expert selected, many small experts
ROUTE_CASES = [(16, 4, 2, 10), (32, 8, 3, 4), (12, 4, 4, 12), (40, 16, 8, 12), (7, 5, 2, 1)]


@pytest.mark.parametrize("norm_topk", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("t,e,k,capacity", ROUTE_CASES)
def test_top_k_routing_matches_jax(t, e, k, capacity, norm_topk):
    want, got = _route_both(_logits(t, e, seed=t + e), k, capacity, norm_topk)
    _assert_routing_equal(want, got)


@pytest.mark.parametrize("norm_topk", [True, False], ids=["norm", "raw"])
def test_exact_ties_take_the_first_index(norm_topk):
    """Rows with equal logits: each round takes the lowest remaining index."""
    logits = np.zeros((6, 4), np.float32)
    logits[1] = [1.0, 3.0, 3.0, 0.0]
    logits[2] = [2.0, 2.0, 2.0, 2.0]
    logits[3, 2:] = 5.0
    want, got = _route_both(logits, 3, 6, norm_topk)
    _assert_routing_equal(want, got)
    r = moe.route(torch.tensor(logits), 3, 6, norm_topk)
    assert r.choice[:, 0].tolist() == [0, 1, 2]
    assert r.choice[:, 1].tolist() == [1, 2, 0]
    assert r.choice[:, 3].tolist() == [2, 3, 0]


def test_overflow_drops_in_round_then_token_order():
    """Every token prefers expert 0, then expert 1: round 0 fills expert 0
    with tokens 0-1 and drops the rest; round 1 gives expert 1 to tokens 0-1
    only. Dropped choices add no weight, a token whose choices all dropped
    gets none, and its experts still leave the remaining set."""
    logits = np.tile(np.array([[4.0, 3.0, 0.0, -1.0]], np.float32), (5, 1))
    want, got = _route_both(logits, 2, 2, True)
    _assert_routing_equal(want, got)
    r = moe.route(torch.tensor(logits), 2, 2)
    assert r.keep.tolist() == [[True, True, False, False, False], [True, True, False, False, False]]
    assert r.choice[1].tolist() == [1] * 5  # expert 0 left the remaining set even where it dropped
    dispatch, combine, _ = (g for g in got)
    assert dispatch[2:].sum() == 0 and combine[2:].sum() == 0
    np.testing.assert_allclose(combine[:2].sum(axis=(1, 2)), 1.0, atol=1e-6)


def test_default_capacity_fits_balanced_topk():
    """With the GShard capacity convention (factor * k * T / E), perfectly
    balanced top-2 routing drops no token at the default factor (the JAX
    package's test, on the port)."""
    t, e, k = 32, 4, 2
    logits = np.full((t, e), -10.0, np.float32)
    for i in range(t):
        logits[i, i % e] = 10.0
        logits[i, (i + 1) % e] = 9.0
    capacity = max(1, int(1.25 * k * t / e))
    dispatch, combine, _ = moe.top_k_routing(torch.tensor(logits), k, capacity)
    assert (dispatch.sum(dim=(1, 2)) == k).all(), "balanced top-2 routing dropped tokens at default capacity"
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0, atol=1e-5)


def _ffn_inputs(t=24, d=16, e=4, ff=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((t, d)).astype(np.float32),
        "router_kernel": rng.standard_normal((d, e)).astype(np.float32),
        "wi": (rng.standard_normal((e, d, ff)) * 0.3).astype(np.float32),
        "wo": (rng.standard_normal((e, ff, d)) * 0.3).astype(np.float32),
        "wi_gate": (rng.standard_normal((e, d, ff)) * 0.3).astype(np.float32),
        "cot": rng.standard_normal((t, d)).astype(np.float32),
    }


# (k, capacity factor, SwiGLU experts, norm_topk): the default, an overflowing one, gelu experts, raw weights
FFN_CASES = [(2, 1.25, True, True), (2, 0.5, True, True), (3, 1.0, False, True), (2, 1.25, True, False)]


@pytest.mark.parametrize("k,factor,swiglu,norm_topk", FFN_CASES)
def test_moe_ffn_and_gradients_match_jax(k, factor, swiglu, norm_topk):
    """The routed FFN's output and aux loss (f32 within 1e-5), and the
    gradients of ``sum(out * cot) + aux`` with respect to every input
    against ``jax.grad`` (within 1e-4)."""
    a = _ffn_inputs()
    names = ["x", "router_kernel", "wi", "wo"] + (["wi_gate"] if swiglu else [])
    kw = dict(num_selected=k, capacity_factor=factor, norm_topk=norm_topk)

    def jax_obj(*args):
        out, aux = jmoe.moe_ffn(*args[:4], wi_gate=args[4] if swiglu else None, **kw)
        return jnp.sum(out * a["cot"]) + aux, (out, aux)

    grad_fn = jax.value_and_grad(jax_obj, argnums=tuple(range(len(names))), has_aux=True)
    (_, (want_out, want_aux)), want_grads = grad_fn(*(jnp.asarray(a[n]) for n in names))
    ts = [torch.tensor(a[n], requires_grad=True) for n in names]
    out, aux = moe.moe_ffn(*ts[:4], wi_gate=ts[4] if swiglu else None, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=F32_ATOL, rtol=0)
    ((out * torch.tensor(a["cot"])).sum() + aux).backward()
    for name, t_, g in zip(names, ts, want_grads):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(g), atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("norm_topk", [True, False], ids=["norm", "raw"])
def test_moe_block_matches_flax_module(norm_topk):
    """``MoEBlock`` on the flax block's initialised weights (``router/kernel``
    transposed into ``router.weight``): output, aux (returned, where flax
    sows it) and the weights' gradients."""
    b, s, d, e, ff = 2, 12, 16, 4, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    jblock = jmoe.MoEBlock(num_experts=e, intermediate_size=ff, num_selected=2, norm_topk=norm_topk)
    params = jblock.init(jax.random.key(0), jnp.asarray(x))["params"]

    def jax_obj(p):
        out, inter = jblock.apply({"params": p}, jnp.asarray(x), mutable=["intermediates"])
        aux = inter["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (want_out, want_aux)), want_grads = jax.value_and_grad(jax_obj, has_aux=True)(params)
    block = moe.MoEBlock(d, e, ff, num_selected=2, norm_topk=norm_topk)
    sd = {"router.weight": torch.tensor(np.asarray(params["router/kernel"]).T.copy())}
    for proj in ("gate_proj", "up_proj", "down_proj"):
        sd[f"experts.{proj}"] = torch.tensor(np.asarray(params[f"experts/{proj}"]))
    block.load_state_dict(sd)
    out, aux = block(torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=F32_ATOL, rtol=0)
    ((out * torch.tensor(cot)).sum() + aux).backward()
    np.testing.assert_allclose(block.router.weight.grad.numpy().T, np.asarray(want_grads["router/kernel"]),
                               atol=GRAD_ATOL, rtol=0)
    for proj in ("gate_proj", "up_proj", "down_proj"):
        np.testing.assert_allclose(getattr(block.experts, proj).grad.numpy(),
                                   np.asarray(want_grads[f"experts/{proj}"]), atol=GRAD_ATOL, rtol=0, err_msg=proj)


def test_moe_ffn_never_builds_the_dense_dispatch():
    """The index formulation holds ``[k, T]`` slot ids: at T 2048, E 128, k 8
    the forward allocates no ``[T, E, C]`` tensor (41.9 M elements)."""
    t, d, e, k = 2048, 8, 128, 8
    x = torch.randn(t, d)
    seen = []

    class Watch(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                seen.append(out.numel())
            return out

    with Watch():
        out, _ = moe.moe_ffn(x, torch.randn(d, e), torch.randn(e, d, 4), torch.randn(e, 4, d), num_selected=k,
                             wi_gate=torch.randn(e, d, 4))
    assert out.shape == (t, d) and max(seen) < t * e * 160 / 8


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------


def _jax_cfg(family):
    return getattr(jm, FAMILIES[family][0]).tiny()


def _port_cfg(family):
    return getattr(pm, FAMILIES[family][0])(**dataclasses.asdict(_jax_cfg(family)))


@functools.cache
def _jax_params(family):
    """The JAX tiny model's params as numpy, the RMSNorm scales moved off
    their identity init by seeded numpy noise."""
    jmodel = getattr(jm, FAMILIES[family][1])(_jax_cfg(family), seed=1, seq_len=SEQ)
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if str(getattr(path[-1], "key", path[-1])) == "scale":
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, jmodel.params)


def _jax_model(family, dtype=None):
    jmodel = getattr(jm, FAMILIES[family][1])(_jax_cfg(family), seed=1, seq_len=SEQ)
    jmodel.params = jax.tree.map(lambda a: jnp.asarray(a, dtype or a.dtype), _jax_params(family))
    return jmodel


def _port_model(family, dtype=torch.float32):
    cfg = _port_cfg(family)
    model = getattr(pm, FAMILIES[family][1])(cfg, device="cpu", dtype=dtype)
    params = _jax_params(family)
    if dtype != torch.float32:  # the JAX side's rounded values, widened for the loader
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    model.load_state_dict(mixtral_params_from_jax(params, cfg))
    return model


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_and_parameter_names_match_jax(family):
    """Every field and default of ``tiny()`` and the published presets, the
    parameter names the converter fills, and no dense MLP in a layer."""
    cls, jcls = getattr(pm, FAMILIES[family][0]), getattr(jm, FAMILIES[family][0])
    assert dataclasses.asdict(cls.tiny()) == dataclasses.asdict(jcls.tiny())
    assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
    presets = [n for n in vars(jcls) if not n.startswith("_") and isinstance(vars(jcls)[n], classmethod)]
    for name in presets:
        assert dataclasses.asdict(getattr(cls, name)()) == dataclasses.asdict(getattr(jcls, name)()), name
    cfg = cls.tiny()
    model = getattr(pm, FAMILIES[family][1])(cfg, device="cpu")
    assert set(model.state_dict()) == set(mixtral_params_from_jax(_jax_params(family), cfg))
    assert not any("mlp" in n for n in model.state_dict())
    assert model.module.lm_head.weight.dtype == torch.float32


def test_qwen3_30b_a3b_widths_and_expert_init_scale():
    """Qwen3-30B-A3B's published widths (per layer 623.1 M parameters, 604 M
    of them experts); the stacked experts draw at their per-expert fan-in."""
    cfg = pm.Qwen3MoeConfig.qwen3_30b_a3b()
    with torch.device("meta"):
        layer = pm.mixtral.MixtralLayer(cfg)
    experts = sum(p.numel() for n, p in layer.named_parameters() if "experts" in n)
    assert experts == 128 * 3 * 2048 * 768
    assert abs(sum(p.numel() for p in layer.parameters()) - 623.1e6) < 0.1e6
    model = pm.create_qwen3_moe_model(pm.Qwen3MoeConfig.tiny(hidden_size=256, moe_intermediate_size=512,
                                                             num_local_experts=16), device="cpu")
    ex = model.module.layers[0].moe.experts
    assert abs(ex.gate_proj.std().item() * math.sqrt(256) - 1) < 0.05
    assert abs(ex.down_proj.std().item() * math.sqrt(512) - 1) < 0.05


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_logits_and_aux_match_jax_f32(family):
    jmodel, model = _jax_model(family), _port_model(family)
    ids = _ids(2, 12)
    want, inter = jmodel.module.apply({"params": jmodel.params}, jnp.asarray(ids), mutable=["intermediates"])
    got, auxes = model(torch.tensor(ids), with_aux=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)
    want_aux = [float(inter["intermediates"][f"layer_{i}"]["moe"]["moe_aux_loss"][0]) for i in range(len(auxes))]
    np.testing.assert_allclose([a.item() for a in auxes], want_aux, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(model(torch.tensor(ids)).detach().numpy(), got.detach().numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_logits_match_jax_bf16(family):
    """A bf16 stream on the same bf16-rounded weights (the router's product
    in bf16, its softmax in f32): 4 bf16 ulps of the largest logit."""
    jmodel, model = _jax_model(family, jnp.bfloat16), _port_model(family, torch.bfloat16)
    ids = _ids(2, 12, seed=3)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids)).astype(np.float32)
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=4 * ulp, rtol=0)


@pytest.mark.parametrize("aux_coef", [None, 0.5], ids=["config-coef", "given-coef"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_lm_loss_with_aux_matches_jax(family, aux_coef):
    """The cross entropy plus aux_coef times the layers' mean aux loss;
    without ``module`` it is the plain causal-LM loss through ``apply_fn``."""
    jmodel, model = _jax_model(family), _port_model(family)
    batch = {"input_ids": _ids(2, 12, seed=4)}
    jloss = getattr(jm, FAMILIES[family][2])
    loss = getattr(pm, FAMILIES[family][2])
    tbatch = {"input_ids": torch.tensor(batch["input_ids"])}
    want = float(jloss(jmodel.params, batch, module=jmodel.module, aux_coef=aux_coef))
    got = loss(model.params, tbatch, module=model.module, aux_coef=aux_coef)
    assert got.item() == pytest.approx(want, rel=1e-6)
    plain = float(jloss(jmodel.params, batch, apply_fn=jmodel.apply_fn))
    assert loss(model.params, tbatch, apply_fn=model.apply_fn).item() == pytest.approx(plain, rel=1e-6)
    assert got.item() != pytest.approx(plain, rel=1e-6)  # the aux term is there


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_jax(family):
    """One AdamW step through ``build_train_step`` with the aux loss, f32:
    the loss, then every parameter. The JAX side runs on the suite's
    8-device CPU mesh (a batch of 8) and routes the whole batch at once, as
    the port does."""
    ids = _ids(BATCH, SEQ, seed=5)
    jacc = JaxAccelerator()
    jmodel = jacc.prepare_model(_jax_model(family))
    jacc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    jloss = getattr(jm, FAMILIES[family][2])
    jstep = jacc.build_train_step(lambda p, b: jloss(p, b, module=jmodel.module))
    want_loss = float(jstep(jax.device_put({"input_ids": jnp.asarray(ids)}, batch_sharding(jacc.mesh))))
    cfg = _port_cfg(family)
    want = mixtral_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg)

    model = _port_model(family)
    opt = torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD)
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(model, opt)
    loss_fn = getattr(pm, FAMILIES[family][2])
    step = acc.build_train_step(lambda p, b: loss_fn(p, b, module=model.module))
    loss = float(step({"input_ids": torch.tensor(ids)}))
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_ring_attention_is_refused_naming_its_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        pm.create_mixtral_model(pm.MixtralConfig.tiny(attention_impl="ring"), device="cpu")
