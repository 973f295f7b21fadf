"""The Llama-knob families of the port (accelerate_tpu_torch.models: mistral,
qwen2, qwen3, olmo2, gemma, gemma2, gemma3, phi3) against the JAX
package's, each at its ``tiny()`` config on the same weights, carried by
``llama_params_from_jax`` after perturbing the norms and biases the JAX
initialisers leave at their identity (so every knob's parameters bite):
forward logits in f32 and bf16, one AdamW train step, greedy ``generate``,
and the paged ServingEngine (token-exact where the port's engine takes the
family, the refusals otherwise). Then the knobs' own ops: ``softcap``,
``dot_product_attention(logit_softcap=...)`` and its dispatch, the dense
cache's softcap and the paged cache's refusal. f32 on the CPU unless a
test says otherwise; inputs made with numpy from a seed."""

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
from accelerate_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from accelerate_tpu.ops.attention import softcap as jax_softcap
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import Accelerator, ServingEngine, causal_lm_loss, llama_params_from_jax
from accelerate_tpu_torch.generation import generate
from accelerate_tpu_torch.ops.attention import dot_product_attention, softcap
from accelerate_tpu_torch.ops.kv_cache import KVCache, cached_attention
from accelerate_tpu_torch.ops.paged_kv import PagedConfig, PagedKVCache
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

# family -> (config class name, create function name)
FAMILIES = {
    "mistral": ("MistralConfig", "create_mistral_model"),
    "qwen2": ("Qwen2Config", "create_qwen2_model"),
    "qwen3": ("Qwen3Config", "create_qwen3_model"),
    "olmo2": ("Olmo2Config", "create_olmo2_model"),
    "gemma": ("GemmaConfig", "create_gemma_model"),
    "gemma2": ("Gemma2Config", "create_gemma2_model"),
    "gemma3": ("Gemma3Config", "create_gemma3_model"),
    "phi3": ("Phi3Config", "create_phi3_model"),
}
NAMES = list(FAMILIES)
# families whose tiny config the port's paged engine serves: all but the softcapped one
ENGINE_FAMILIES = tuple(f for f in FAMILIES if f != "gemma2")
SEQ, BATCH, LR, WD = 16, 8, 1e-3, 0.01
# f32 logits: the same arithmetic in another summation order
F32_ATOL = 1e-5
LOSS_RTOL = PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _jax_cfg(family, **kw):
    return getattr(jm, FAMILIES[family][0]).tiny(**kw)


def _port_cfg(family, jcfg):
    return getattr(pm, FAMILIES[family][0])(**dataclasses.asdict(jcfg))


@functools.cache
def _jax_params(family):
    """The JAX tiny model's params as numpy, norms and biases moved off the
    identity the initialisers give them by numpy noise (seeded)."""
    jmodel = getattr(jm, FAMILIES[family][1])(_jax_cfg(family), seed=1, seq_len=SEQ)
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("scale") or name.endswith("bias"):
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, jmodel.params)


def _jax_model(family, dtype=None):
    jmodel = getattr(jm, FAMILIES[family][1])(_jax_cfg(family), seed=1, seq_len=SEQ)
    params = _jax_params(family)
    jmodel.params = jax.tree.map(lambda a: jnp.asarray(a, dtype or a.dtype), params)
    return jmodel


def _port_model(family, dtype=torch.float32):
    cfg = _port_cfg(family, _jax_cfg(family))
    model = getattr(pm, FAMILIES[family][1])(cfg, device="cpu", dtype=dtype)
    params = _jax_params(family)
    if dtype != torch.float32:  # the JAX side's rounded values, widened for the loader
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    return model


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("family", NAMES)
def test_config_matches_jax(family):
    """Every field and default of the published preset and of ``tiny()``,
    and the parameter names the port's module holds for the JAX tree."""
    cls = getattr(pm, FAMILIES[family][0])
    jcls = getattr(jm, FAMILIES[family][0])
    assert dataclasses.asdict(cls.tiny()) == dataclasses.asdict(jcls.tiny())
    assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
    presets = [n for n in vars(jcls) if not n.startswith("_") and isinstance(vars(jcls)[n], classmethod)]
    for name in presets:
        assert dataclasses.asdict(getattr(cls, name)()) == dataclasses.asdict(getattr(jcls, name)()), name
    cfg = cls.tiny()
    model = getattr(pm, FAMILIES[family][1])(cfg, device="cpu")
    assert set(model.state_dict()) == set(llama_params_from_jax(_jax_params(family), cfg))
    assert ("lm_head.weight" in model.state_dict()) == (not cfg.tie_word_embeddings)


@pytest.mark.parametrize("family", NAMES)
def test_forward_logits_match_jax_f32(family):
    jmodel, model = _jax_model(family), _port_model(family)
    ids = _ids(2, 12)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids))
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("family", NAMES)
def test_forward_logits_match_jax_bf16(family):
    """A bf16 stream on the same bf16-rounded weights: each package rounds
    the same tensors to bf16 (projections, norms, the activation, the
    residual adds), summing in its own order; held to 4 bf16 ulps of the
    largest logit."""
    jmodel, model = _jax_model(family, jnp.bfloat16), _port_model(family, torch.bfloat16)
    ids = _ids(2, 12, seed=3)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids)).astype(np.float32)
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, atol=4 * ulp, rtol=0)


@pytest.mark.parametrize("family", NAMES)
def test_train_step_matches_jax(family):
    """One AdamW step with remat, f32: the loss, then every parameter. The
    JAX side runs on the suite's 8-device CPU mesh (a batch of 8). A key
    bias (Qwen2) shifts every score of a query by the same amount but for
    its rotation, and the lowest rope frequencies barely rotate over 16
    positions: those entries' gradients are rounding noise, which Adam's
    normalised step turns into moves of up to lr; they are held to 2 lr."""
    ids = _ids(BATCH, SEQ, seed=5)
    jacc = JaxAccelerator()
    jmodel = jacc.prepare_model(_jax_model(family))
    jacc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    jstep = jacc.build_train_step(lambda p, b: jax_causal_lm_loss(p, b, jmodel.apply_fn))
    want_loss = float(jstep(jax.device_put({"input_ids": jnp.asarray(ids)}, batch_sharding(jacc.mesh))))
    cfg = _port_cfg(family, _jax_cfg(family))
    want = llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg)

    model = _port_model(family)
    opt = torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD)
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    loss = float(step({"input_ids": torch.tensor(ids)}))
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        atol = 2 * LR if name.endswith("k_proj.bias") else PARAM_ATOL
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("family", NAMES)
def test_greedy_generate_matches_jax(family):
    """Prefill through the dense cache, then eight single-token steps: the
    cache's softcap, scale, per-layer windows and rope bases."""
    jmodel, model = _jax_model(family), _port_model(family)
    ids = _ids(2, 11, seed=2)
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=8))
    got = generate(model, ids, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in lengths]


ENGINE = dict(num_slots=2, prompt_buckets=(4, 8), paged_block_size=4, tick_block=4)
PORT_ENGINE = dict(ENGINE, device="cpu")


def _serve(engine, prompts):
    """``[(tokens, logprobs)]`` of 5 new tokens for each prompt, in order."""
    uids = [engine.submit(p, 5) for p in prompts]
    engine.run()
    return [(engine.poll(u), engine.logprobs(u)) for u in uids]


@pytest.mark.parametrize("family", NAMES)
def test_paged_serving_matches_jax_or_refuses(family):
    """The families the port's paged engine takes serve token for token as
    the JAX paged engine does (logprobs within 1e-4): the banded ones
    (Mistral, Phi-3: an 8-key band on every layer, so blocks expire behind
    the 11-token prompt's frontier; Gemma3 in its band without expiry)
    among them. Gemma2's softcap is refused by both engines."""
    model = _port_model(family)
    prompts = _prompts(0, (3, 11, 6))
    if family in ENGINE_FAMILIES:
        want = _serve(JaxServingEngine(_jax_model(family), **ENGINE), prompts)
        got = _serve(ServingEngine(model, **PORT_ENGINE), prompts)
        for (jt, jl), (tt, tl) in zip(want, got):
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        return
    if family == "gemma2":
        with pytest.raises(NotImplementedError, match="softcapping"):
            jeng = JaxServingEngine(_jax_model(family), **ENGINE)
            jeng.generate_many([prompts[0]], max_new_tokens=3)
        with pytest.raises(NotImplementedError, match="softcapping"):
            ServingEngine(model, **PORT_ENGINE)


# ---------------------------------------------------------------------------
# the knobs' ops
# ---------------------------------------------------------------------------


def _qkv(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32) * 2,
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32) * 2,
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("cap", [0.5, 5.0, 50.0])
def test_softcap_matches_jax(cap):
    x = np.random.default_rng(1).standard_normal((4, 33)).astype(np.float32) * 40
    np.testing.assert_allclose(softcap(torch.tensor(x), cap).numpy(), np.asarray(jax_softcap(jnp.asarray(x), cap)),
                               atol=1e-6, rtol=1e-6)
    assert float(softcap(torch.tensor(x), cap).abs().max()) <= cap


@pytest.mark.parametrize("window", [None, 3], ids=["causal", "band"])
@pytest.mark.parametrize("sq", [7, 5], ids=["square", "bottom-right"])
def test_softcapped_attention_matches_jax(window, sq):
    """Scores capped before the causal mask and the band, GQA, a scale
    that is not head_dim's."""
    q, k, v = _qkv(2, sq, 7, 4, 2, 16)
    kw = dict(causal=True, scale=0.3, window=window, logit_softcap=2.0)
    want = np.asarray(jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = dot_product_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    uncapped = dot_product_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True, scale=0.3,
                                     window=window)
    assert not np.allclose(uncapped.numpy(), want, atol=1e-3)  # the cap bites on these scores


def test_explicit_flash_with_a_softcap_raises_as_jax_does():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 4, 2, 2, 16))
    with pytest.raises(ValueError, match="logit_softcap"):
        dot_product_attention(q, k, v, causal=True, use_flash=True, logit_softcap=5.0)
    with pytest.raises(ValueError, match="logit_softcap"):
        jax_dot_product_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True, use_flash=True,
                                  logit_softcap=5.0)


@pytest.mark.parametrize("window", [None, 4], ids=["causal", "band"])
def test_dense_cache_softcap_matches_one_forward(window):
    """Prefill 6 rows and three single-token steps through the dense cache
    with a softcap and a scale: each step equals the capped einsum
    attention over the whole prefix (bottom-right aligned)."""
    cfg = pm.Gemma2Config.tiny(num_hidden_layers=1)
    q, k, v = _qkv(1, 9, 9, 4, 2, 16, seed=4)
    cache = KVCache.empty(cfg, 1, 16, torch.float32, "cpu")
    kw = dict(scale=0.25, sliding_window=window, logit_softcap=3.0)
    outs = [cached_attention(cache, 0, torch.tensor(q[:, :6]), torch.tensor(k[:, :6]), torch.tensor(v[:, :6]), **kw)]
    cache.advance(6)
    for t in range(6, 9):
        sl = slice(t, t + 1)
        outs.append(cached_attention(cache, 0, torch.tensor(q[:, sl]), torch.tensor(k[:, sl]), torch.tensor(v[:, sl]),
                                     **kw))
        cache.advance(1)
    got = torch.cat(outs, dim=1).numpy()
    want = np.asarray(jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                                scale=0.25, window=window, logit_softcap=3.0))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_paged_cache_refuses_a_softcap():
    cfg = pm.Gemma2Config.tiny(num_hidden_layers=1)
    cache = PagedKVCache.empty(cfg, PagedConfig(block_size=4, num_blocks=4), 1, torch.float32, "cpu")
    q, k, v = (torch.tensor(a) for a in _qkv(1, 1, 1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="softcapping"):
        cached_attention(cache, 0, q, k, v, logit_softcap=50.0)


def test_layer_kinds_follow_layer_types():
    """Gemma3's 5:1 pattern at its published depth: the band and the local
    rope on the sliding layers only; Gemma2 alternates."""
    from accelerate_tpu_torch.models.llama import _layer_kinds

    kinds = _layer_kinds(pm.Gemma3Config.gemma3_1b())
    assert len(kinds) == 26
    assert [i for i, (w, _) in enumerate(kinds) if w is None] == [5, 11, 17, 23]
    assert all(w == 512 and local for w, local in kinds if w is not None)
    assert _layer_kinds(pm.Gemma2Config.tiny()) == [(8, False), (None, False)]
    assert _layer_kinds(pm.MistralConfig.tiny()) == [(8, False), (8, False)]


def test_config_errors_match_jax():
    """layer_types needs the unrolled stack and one entry a layer;
    mlp_activation is silu or gelu_tanh (the JAX module's checks)."""
    with pytest.raises(ValueError, match="scan_layers=False"):
        pm.create_llama_model(pm.LlamaConfig.tiny(layer_types=("full_attention",) * 2), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        pm.create_llama_model(pm.LlamaConfig.tiny(layer_types=("full_attention",), scan_layers=False), device="cpu")
    with pytest.raises(ValueError, match="mlp_activation"):
        pm.create_llama_model(pm.LlamaConfig.tiny(mlp_activation="relu"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        pm.create_llama_model(pm.LlamaConfig.tiny(attention_impl="ring"), device="cpu")
