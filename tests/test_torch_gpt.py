"""The port's GPT decoders (models/gpt2.py, models/gptneox.py) against the
JAX package's, at ``tiny()`` configs on the same weights (carried by
``gpt2_params_from_jax`` / ``gptneox_params_from_jax``, with the LayerNorm
scales and every bias moved off their zero/one init so they bite):
forward logits in f32 and bf16 (GPT-2 tied and untied; GPT-NeoX with the
parallel and the sequential residual, rotary on a quarter and on all of
each head), ``partial_rope``, greedy ``generate``, the ServingEngine on
the dense and the paged layout token for token with the JAX engine, and
one AdamW train step (GPT-2 with remat too). Then the cache constructors
for configs without ``head_dim`` / ``num_key_value_heads`` and the new
entry points' default device. Inputs are made with numpy
from a seed; everything runs on the CPU."""

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
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models import causal_lm_loss as jax_causal_lm_loss
from accelerate_tpu.models.gptneox import partial_rope as jax_partial_rope
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import Accelerator, ServingEngine, causal_lm_loss, generate
from accelerate_tpu_torch.models import gpt2_params_from_jax, gptneox_params_from_jax
from accelerate_tpu_torch.models.gptneox import partial_rope
from accelerate_tpu_torch.ops.kv_cache import KVCache
from accelerate_tpu_torch.ops.paged_kv import PagedConfig, PagedKVCache
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

F32_ATOL = 1e-5
LOSS_RTOL = PARAM_ATOL = 1e-4
LP_ATOL = 1e-4
SEQ, BATCH, LR, WD = 16, 8, 1e-3, 0.01

# variant -> (family, config overrides)
VARIANTS = {
    "gpt2": ("gpt2", {}),
    "gpt2-untied": ("gpt2", {"tie_word_embeddings": False}),
    "neox": ("gptneox", {}),
    "neox-sequential": ("gptneox", {"use_parallel_residual": False}),
    "neox-full-rotary": ("gptneox", {"rotary_pct": 1.0}),
}
FAMILIES = {
    "gpt2": ("GPT2Config", "create_gpt2_model", gpt2_params_from_jax),
    "gptneox": ("GPTNeoXConfig", "create_gptneox_model", gptneox_params_from_jax),
}


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _jax_cfg(variant, **kw):
    family, over = VARIANTS[variant]
    return getattr(jm, FAMILIES[family][0]).tiny(**{**over, **kw})


def _port_cfg(variant, jcfg):
    return getattr(pm, FAMILIES[VARIANTS[variant][0]][0])(**dataclasses.asdict(jcfg))


@functools.cache
def _jax_params(variant):
    """The JAX tiny model's params as numpy, LayerNorm scales and every bias
    moved off their init by seeded numpy noise."""
    family = VARIANTS[variant][0]
    jmodel = getattr(jm, FAMILIES[family][1])(_jax_cfg(variant), seed=1, seq_len=SEQ)
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if str(getattr(path[-1], "key", path[-1])) in ("scale", "bias"):
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, jmodel.params)


def _jax_model(variant, dtype=None, **kw):
    family = VARIANTS[variant][0]
    jmodel = getattr(jm, FAMILIES[family][1])(_jax_cfg(variant, **kw), seed=1, seq_len=SEQ)
    jmodel.params = jax.tree.map(lambda a: jnp.asarray(a, dtype or a.dtype), _jax_params(variant))
    return jmodel


def _port_model(variant, dtype=torch.float32, **kw):
    family = VARIANTS[variant][0]
    _, create, convert = FAMILIES[family]
    cfg = _port_cfg(variant, _jax_cfg(variant, **kw))
    model = getattr(pm, create)(cfg, device="cpu", dtype=dtype)
    params = _jax_params(variant)
    if dtype != torch.float32:  # the JAX side's rounded values, widened for the loader
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    model.load_state_dict(convert(params, cfg))
    return model


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_and_parameter_names_match_jax(family):
    cls_name, create, convert = FAMILIES[family]
    cls, jcls = getattr(pm, cls_name), getattr(jm, cls_name)
    assert dataclasses.asdict(cls.tiny()) == dataclasses.asdict(jcls.tiny())
    assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
    presets = [n for n in vars(jcls) if not n.startswith("_") and isinstance(vars(jcls)[n], classmethod)]
    for name in presets:
        assert dataclasses.asdict(getattr(cls, name)()) == dataclasses.asdict(getattr(jcls, name)()), name
    variant = family if family == "gpt2" else "neox"
    cfg = cls.tiny()
    model = getattr(pm, create)(cfg, device="cpu")
    assert set(model.state_dict()) == set(convert(_jax_params(variant), cfg))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_match_jax_f32(variant):
    jmodel, model = _jax_model(variant), _port_model(variant)
    ids = _ids(2, 12)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids))
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["gpt2", "neox"])
def test_forward_logits_match_jax_bf16(variant):
    """A bf16 stream on the same bf16-rounded weights: 4 bf16 ulps of the
    largest logit."""
    jmodel, model = _jax_model(variant, jnp.bfloat16), _port_model(variant, torch.bfloat16)
    ids = _ids(2, 12, seed=3)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids)).astype(np.float32)
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, atol=4 * ulp, rtol=0)


@pytest.mark.parametrize("rotary_dims", [0, 4, 12, 16, 32])
def test_partial_rope_matches_jax(rotary_dims):
    """The first ``rotary_dims`` turned with the Llama rope, the tail as it
    was (all of it from the head dim on)."""
    rng = np.random.default_rng(rotary_dims)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 30, 31]], np.int32)
    want = np.asarray(jax_partial_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rotary_dims))
    got = partial_rope(torch.tensor(x), torch.tensor(pos), 10000.0, rotary_dims)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy()[..., rotary_dims:], x[..., rotary_dims:])


@pytest.mark.parametrize("variant", ["gpt2", "neox", "neox-sequential"])
def test_greedy_generate_matches_jax(variant):
    """Prefill through the dense cache, then single-token steps: GPT-2
    reads ``wpe`` at each step's position, GPT-NeoX rotates at it."""
    jmodel, model = _jax_model(variant), _port_model(variant)
    ids = _ids(2, 11, seed=2)
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=8))
    got = generate(model, ids, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in lengths]


def _serve(engine, prompts):
    uids = [engine.submit(p, 6) for p in prompts]
    engine.run()
    return [(engine.poll(u), engine.logprobs(u)) for u in uids]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("variant", ["gpt2", "neox"])
def test_serving_engine_matches_jax(variant, layout):
    """Three requests through two slots (chunked prefill past the largest
    bucket, a slot reused): the port's engine gives the JAX engine's tokens,
    logprobs within 1e-4, on both layouts."""
    kw = dict(num_slots=2, prompt_buckets=(4, 8), tick_block=4)
    if layout == "paged":
        kw["paged_block_size"] = 4
    prompts = _prompts(0, (3, 11, 6))
    want = _serve(JaxServingEngine(_jax_model(variant), **kw), prompts)
    got = _serve(ServingEngine(_port_model(variant), device="cpu", **kw), prompts)
    for (jt, jl), (tt, tl) in zip(want, got):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=LP_ATOL, rtol=0)


@pytest.mark.parametrize("variant,remat", [("gpt2", False), ("gpt2", True), ("neox", False), ("neox", True)])
def test_train_step_matches_jax(variant, remat):
    """One AdamW step, f32: the loss, then every parameter. The JAX side runs
    on the suite's 8-device CPU mesh (a batch of 8). The key bias shifts
    every score of a query by the same amount (but for GPT-NeoX's rotated
    dims), so its gradient is rounding noise, which Adam's normalised step
    turns into moves of up to lr: it is held to 2 lr, as BERT's and
    Qwen2's are; so is any element whose gradient is under 1e-6 (about 100
    times Adam's eps), where ``g / (|g| + eps)`` follows the rounding of
    ``g`` (GPT-NeoX's embedding has one at 4.2e-9)."""
    ids = _ids(BATCH, SEQ, seed=5)
    jacc = JaxAccelerator()
    jmodel = jacc.prepare_model(_jax_model(variant, remat=remat))
    jacc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    jstep = jacc.build_train_step(lambda p, b: jax_causal_lm_loss(p, b, jmodel.apply_fn))
    want_loss = float(jstep(jax.device_put({"input_ids": jnp.asarray(ids)}, batch_sharding(jacc.mesh))))
    cfg = _port_cfg(variant, _jax_cfg(variant, remat=remat))
    want = FAMILIES[VARIANTS[variant][0]][2](jax.tree.map(np.asarray, jmodel.params), cfg)

    model = _port_model(variant, remat=remat)
    model.module.requires_grad_(True)
    causal_lm_loss(model.params, {"input_ids": torch.tensor(ids)}, model.apply_fn).backward()
    tiny_grad = {n: p.grad.abs() < 1e-6 for n, p in model.module.named_parameters()}
    model.module.zero_grad(set_to_none=True)
    opt = torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD)
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    loss = float(step({"input_ids": torch.tensor(ids)}))
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        atol = torch.where(tiny_grad[name], 2 * LR, 2 * LR if name.endswith("k_proj.bias") else PARAM_ATOL)
        err = (got[name] - want[name]).abs()
        assert bool((err <= atol).all()), f"{name}: {float((err - atol).max())} past its tolerance"


def test_remat_recomputes_each_block_in_the_backward():
    """With ``remat`` the blocks run again in the backward (a forward
    counter), and the gradients equal the plain backward's."""
    grads, calls = {}, {}
    for remat in (False, True):
        model = _port_model("gpt2", remat=remat)
        model.module.train()
        model.module.requires_grad_(True)
        n = [0]
        model.module.layers[0].attn.register_forward_pre_hook(lambda *a: n.__setitem__(0, n[0] + 1))
        model(torch.tensor(_ids(2, 8))).sum().backward()
        calls[remat] = n[0]
        grads[remat] = {k: p.grad.clone() for k, p in model.module.named_parameters()}
    assert calls == {False: 1, True: 2}
    for k in grads[False]:
        torch.testing.assert_close(grads[True][k], grads[False][k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_caches_take_configs_without_kv_heads_or_head_dim(family):
    """GPT-2 and GPT-NeoX configs have neither ``head_dim`` nor
    ``num_key_value_heads``: both caches take MHA over hidden / heads."""
    cfg = getattr(pm, FAMILIES[family][0]).tiny()
    assert not hasattr(cfg, "head_dim") and not hasattr(cfg, "num_key_value_heads")
    dense = KVCache.empty(cfg, 3, 10, torch.float32, "cpu")
    assert dense.key.shape == (2, 3, 10, 4, 16)
    paged = PagedKVCache.empty(cfg, PagedConfig(block_size=4, num_blocks=5), 3, torch.bfloat16, "cpu")
    assert paged.key_pool.shape == (2, 5, 4, 4, 16) and paged.block_table.shape == (3, 32)


@pytest.mark.parametrize("create,cfg", [("create_gpt2_model", "GPT2Config"), ("create_gptneox_model", "GPTNeoXConfig"),
                                        ("create_mixtral_model", "MixtralConfig"),
                                        ("create_qwen3_moe_model", "Qwen3MoeConfig")])
def test_new_entry_points_default_to_cuda(monkeypatch, create, cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pm, create)(getattr(pm, cfg).tiny())
    assert getattr(pm, create)(getattr(pm, cfg).tiny(), device="cpu").device.type == "cpu"
