"""``quantize_llama_model`` on the Llama-knob families, against the JAX
package: each family's ``tiny()`` config, its norms and biases moved off
their identity init (so every knob bites), quantized in int4 (group 32),
int8, nf4 (group 16) and w8a8. Two sources of the port's codes: carried
from the JAX package's ``load_and_quantize_model`` by
``llama_params_from_jax``, and the port's own ``load_and_quantize_model``
on the carried float weights. Logits within 1e-4 (f32), the bound of
``test_quantized_llama_logits_match_jax``.

Qwen2 has no JAX quantized oracle as it stands: the JAX
``quantize_llama_model`` drops its q/k/v biases (ROADMAP.md Queue 3), and
the quantized JAX model cannot run. It is held to a JAX float Qwen2 whose
projection kernels are the dequantized codes (``jq.dequantize``) and whose
biases are kept; in w8a8, which quantizes the activations too, to the JAX
quantized tree with its biases put back (the JAX ``QuantDense`` takes a
bias; only the tree conversion drops it)."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu.models as jm
import accelerate_tpu.utils.quantization as jq
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import QuantizationConfig, llama_params_from_jax, load_and_quantize_model

torch.set_num_threads(2)

ATOL = 1e-4
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
METHODS = [("int4", 32), ("int8", None), ("nf4", 16), ("w8a8", None)]
_PROJ = re.compile(r"(q|k|v|o|gate|up|down)_proj")


def _configs(method, group_size):
    kw = dict(method=method, group_size=group_size, bits=8 if method in ("int8", "w8a8") else 4)
    return jq.QuantizationConfig(**kw), QuantizationConfig(**kw)


@functools.cache
def _jax_float(family):
    """The JAX tiny model, its norms and biases moved off their init by
    seeded numpy noise (params as numpy)."""
    jmodel = getattr(jm, FAMILIES[family][1])(getattr(jm, FAMILIES[family][0]).tiny(), seed=1, seq_len=16)
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if str(getattr(path[-1], "key", path[-1])) in ("scale", "bias"):
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    jmodel.params = jax.tree_util.tree_map_with_path(perturb, jmodel.params)
    return jmodel


def _port_cfg(jcfg):
    return getattr(pm, type(jcfg).__name__)(**dataclasses.asdict(jcfg))


def _port_model(jcfg, params):
    cfg = _port_cfg(jcfg)
    model = pm.create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return model


def _map_projections(tree, fn):
    """``tree`` with every projection dict ``{"kernel", ("bias")}`` replaced
    by ``fn(that dict)``."""
    if not hasattr(tree, "items"):
        return tree
    return {k: fn(v) if _PROJ.fullmatch(k) and hasattr(v, "items") else _map_projections(v, fn)
            for k, v in tree.items()}


def _qwen2_oracle(jmodel, jqcfg, method):
    """The JAX Qwen2 the quantized port is held to, and the tree of codes
    (with biases) the port carries."""
    def codes(proj):
        qt = jq.quantize(jnp.asarray(proj["kernel"]), jqcfg)
        return {"qdata": qt.data, "qscale": qt.scale, **({"bias": proj["bias"]} if "bias" in proj else {}),
                "_deq": jq.dequantize(qt, jnp.float32)}

    coded = _map_projections(jmodel.params, codes)
    carried = _map_projections(coded, lambda p: {k: v for k, v in p.items() if k != "_deq"})
    if method == "w8a8":  # the JAX quantized model, its biases put back
        jqmodel = jq.load_and_quantize_model(jmodel, jqcfg)
        return jqmodel, carried
    oracle = getattr(jm, FAMILIES["qwen2"][1])(jmodel.config, seed=1, seq_len=16)
    oracle.params = _map_projections(coded, lambda p: {"kernel": p["_deq"],
                                                       **({"bias": p["bias"]} if "bias" in p else {})})
    return oracle, carried


IDS = np.random.default_rng(0).integers(0, 256, size=(2, 12)).astype(np.int32)


@functools.cache
def _jax_side(family, method, group_size):
    """``(JAX logits, the tree of codes the port carries, its config)``."""
    jmodel = _jax_float(family)
    jqcfg, _ = _configs(method, group_size)
    if family == "qwen2":
        oracle, carried_tree = _qwen2_oracle(jmodel, jqcfg, method)
        params = carried_tree if method == "w8a8" else oracle.params
        qjcfg = dataclasses.replace(jmodel.config, quant_method=method, quant_group_size=group_size)
        return np.asarray(oracle.apply_fn(params, IDS)), carried_tree, qjcfg
    jqmodel = jq.load_and_quantize_model(jmodel, jqcfg)
    return np.asarray(jqmodel.apply_fn(jqmodel.params, IDS)), jqmodel.params, jqmodel.config


@pytest.mark.parametrize("source", ["carried", "own"])
@pytest.mark.parametrize("method,group_size", METHODS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantized_family_logits_match_jax(family, method, group_size, source):
    jmodel = _jax_float(family)
    _, qcfg = _configs(method, group_size)
    want, carried_tree, qjcfg = _jax_side(family, method, group_size)
    if source == "carried":
        model = _port_model(qjcfg, carried_tree)
    else:
        model = load_and_quantize_model(_port_model(jmodel.config, jmodel.params), qcfg)
    assert model.config.quant_method == method and model.config.quant_group_size == group_size
    got = model(torch.tensor(IDS))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
