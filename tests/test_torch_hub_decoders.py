"""The port's HF checkpoint importers (accelerate_tpu_torch.models.hub) for
the decoder families against the JAX package's (accelerate_tpu.models.hub):
the nine Llama families, Mixtral, Qwen3-MoE, GPT-2 and GPT-NeoX. Each
family's seeded HF-named checkpoint is loaded by both packages'
``load_hf_*``: the port's state dict must equal, bit for bit, the JAX
loaded params carried by ``models/convert.py``, with the same
``imported_weight_count`` (every leaf of the model imported), from one f32
file and from two bf16 shards with an index. Then a bf16 file through both
packages, the shard reader's index rules, the tied-head fallback, Phi-3's
fused split, the refusals with the JAX message text, and forward logits in
f32 within the family tests' 1e-5 (tests/test_torch_families.py,
test_torch_gpt.py)."""

import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import accelerate_tpu.models.hub as jhub
import accelerate_tpu_torch.models as pm
import accelerate_tpu_torch.models.hub as phub
from torch_hub_common import (
    SHARDS,
    assert_state_equal,
    check_family,
    configs,
    hf_state,
    jax_leaves,
    make_jax_loaded,
    port_shapes,
    refusal_messages,
    write_shards,
)

torch.set_num_threads(2)

F32_ATOL = 1e-5

LLAMA_FAMILIES = ("llama", "phi3", "gemma", "gemma2", "gemma3", "qwen2", "qwen3", "olmo2", "mistral")
# case -> (family, config overrides)
CASES = {
    **{f: (f, {}) for f in LLAMA_FAMILIES},
    "llama-unrolled": ("llama", {"scan_layers": False}),
    "mixtral": ("mixtral", {}),
    "qwen3_moe": ("qwen3_moe", {}),
    "gpt2": ("gpt2", {}),
    "gptneox": ("gptneox", {}),  # tiny's rotary_pct is 0.25: the partial re-pairing
}
_CLASS = {"llama": "LlamaConfig", "phi3": "Phi3Config", "gemma": "GemmaConfig", "gemma2": "Gemma2Config",
          "gemma3": "Gemma3Config", "qwen2": "Qwen2Config", "qwen3": "Qwen3Config", "olmo2": "Olmo2Config",
          "mistral": "MistralConfig", "mixtral": "MixtralConfig", "qwen3_moe": "Qwen3MoeConfig",
          "gpt2": "GPT2Config", "gptneox": "GPTNeoXConfig"}
# the port's names inside one llama layer -> HF's
_LLAMA_RENAMES = (("attn.", "self_attn."), ("input_norm.", "input_layernorm."),
                  ("post_attn_norm.", "post_attention_layernorm."), ("pre_ffn_norm.", "pre_feedforward_layernorm."),
                  ("post_ffn_norm.", "post_feedforward_layernorm."))


def _configs(case):
    family, kw = CASES[case]
    return (family, *configs(_CLASS[family], **kw))


def _llama_hf_name(name: str) -> str:
    if name in ("embed_tokens.weight", "final_norm.weight"):
        return {"embed_tokens.weight": "model.embed_tokens.weight", "final_norm.weight": "model.norm.weight"}[name]
    if name == "lm_head.weight":
        return name
    for ours, hf in _LLAMA_RENAMES:
        name = name.replace(ours, hf)
    return "model." + name


def hf_shapes(family: str, cfg) -> dict:
    """``{HF name: shape}`` of a checkpoint holding every parameter of the
    port's ``family`` model at ``cfg``."""
    params = port_shapes(family, cfg)
    d, out = cfg.hidden_size, {}
    if family == "gpt2":  # Conv1D weights [in, out]; q/k/v fused in c_attn
        out.update({"transformer.wte.weight": params["wte.weight"], "transformer.wpe.weight": params["wpe.weight"],
                    "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,)})
        for i in range(cfg.num_hidden_layers):
            p, ff = f"transformer.h.{i}.", params[f"layers.{i}.mlp.fc_in.weight"][0]
            out.update({p + "ln_1.weight": (d,), p + "ln_1.bias": (d,), p + "ln_2.weight": (d,), p + "ln_2.bias": (d,),
                        p + "attn.c_attn.weight": (d, 3 * d), p + "attn.c_attn.bias": (3 * d,),
                        p + "attn.c_proj.weight": (d, d), p + "attn.c_proj.bias": (d,),
                        p + "mlp.c_fc.weight": (d, ff), p + "mlp.c_fc.bias": (ff,),
                        p + "mlp.c_proj.weight": (ff, d), p + "mlp.c_proj.bias": (d,)})
        return out
    if family == "gptneox":  # q/k/v fused head-major in query_key_value
        out.update({"gpt_neox.embed_in.weight": params["embed_in.weight"],
                    "embed_out.weight": params["embed_out.weight"],
                    "gpt_neox.final_layer_norm.weight": (d,), "gpt_neox.final_layer_norm.bias": (d,)})
        for i in range(cfg.num_hidden_layers):
            p, ff = f"gpt_neox.layers.{i}.", params[f"layers.{i}.mlp.fc_in.weight"][0]
            for norm in ("input_layernorm", "post_attention_layernorm"):
                out.update({p + f"{norm}.weight": (d,), p + f"{norm}.bias": (d,)})
            out.update({p + "attention.query_key_value.weight": (3 * d, d),
                        p + "attention.query_key_value.bias": (3 * d,),
                        p + "attention.dense.weight": (d, d), p + "attention.dense.bias": (d,),
                        p + "mlp.dense_h_to_4h.weight": (ff, d), p + "mlp.dense_h_to_4h.bias": (ff,),
                        p + "mlp.dense_4h_to_h.weight": (d, ff), p + "mlp.dense_4h_to_h.bias": (d,)})
        return out
    for name, shape in params.items():
        if ".moe.router." in name:
            key = "mlp.gate" if family == "qwen3_moe" else "block_sparse_moe.gate"
            out[_llama_hf_name(name).replace("moe.router", key)] = shape
        elif ".moe.experts." in name:
            layer, proj = name.split(".moe.experts.")
            experts, a, b = shape  # flax [E, in, out]; HF's per expert [out, in]
            for e in range(experts):
                if family == "qwen3_moe":
                    hf = f"model.{layer}.mlp.experts.{e}.{proj}.weight"
                else:
                    w = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}[proj]
                    hf = f"model.{layer}.block_sparse_moe.experts.{e}.{w}.weight"
                out[hf] = (b, a)
        else:
            out[_llama_hf_name(name)] = shape
    if family == "phi3":  # fused q/k/v and gate/up, rows stacked in that order
        for i in range(cfg.num_hidden_layers):
            p = f"model.layers.{i}."
            q, k, v = (out.pop(p + f"self_attn.{n}_proj.weight") for n in "qkv")
            out[p + "self_attn.qkv_proj.weight"] = (q[0] + k[0] + v[0], q[1])
            gate, up = out.pop(p + "mlp.gate_proj.weight"), out.pop(p + "mlp.up_proj.weight")
            out[p + "mlp.gate_up_proj.weight"] = (gate[0] + up[0], gate[1])
    return out


def convert(family: str):
    if family in LLAMA_FAMILIES:
        return pm.llama_params_from_jax
    if family in ("mixtral", "qwen3_moe"):
        return pm.mixtral_params_from_jax
    return getattr(pm, f"{family}_params_from_jax")


def _build(case):
    family, jcfg, cfg = _configs(case)
    return family, jcfg, hf_shapes(family, cfg)


@pytest.fixture(scope="module")
def jax_loaded(tmp_path_factory):
    return make_jax_loaded(tmp_path_factory, _build)


@pytest.mark.parametrize("case", list(CASES))
def test_loader_matches_jax(case, jax_loaded, tmp_path):
    family, _, cfg = _configs(case)
    check_family(family, case, cfg, convert(family), jax_loaded, tmp_path)


def test_hub_entry_points_are_exported():
    names = [f"load_hf_{f}" for f in (*LLAMA_FAMILIES, "mixtral", "qwen3_moe", "gpt2", "gptneox", "bert", "t5",
                                      "vit", "whisper", "clip")]
    names += ["read_safetensors_state", "split_phi3_fused_state"]
    names += [n for n in vars(jhub) if n.startswith("convert_hf_")]
    assert len(names) == 18 + 2 + 10
    for name in names:
        assert getattr(pm, name) is getattr(phub, name), name


def test_bf16_checkpoint_loads_bf16_and_matches_jax(tmp_path):
    """A bf16 file reads as bf16 tensors (not through numpy) in the port;
    both packages load it alike into f32, and into bf16 (``dtype=``) the
    port holds the same values."""
    family, jcfg, cfg = _configs("llama")
    state = hf_state(hf_shapes(family, cfg), seed=1, dtype=ml_dtypes.bfloat16)
    path = str(tmp_path / "model.safetensors")
    save_file(state, path)
    read = phub.read_safetensors_state(path)
    assert set(read) == set(state)
    for name, value in read.items():
        assert value.dtype == torch.bfloat16
        assert np.array_equal(value.view(torch.int16).numpy(), state[name].view(np.int16)), name
    jmodel = jhub.load_hf_llama(path, jcfg)
    want = pm.llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg)
    model = phub.load_hf_llama(path, cfg, device="cpu")
    assert_state_equal(model.state_dict(), want)
    assert model.imported_weight_count == jmodel.imported_weight_count == jax_leaves(jmodel)
    half = phub.load_hf_llama(path, cfg, device="cpu", dtype=torch.bfloat16)
    for name, value in half.state_dict().items():
        assert value.dtype == (torch.float32 if name == "lm_head.weight" else torch.bfloat16), name
    assert_state_equal(half.state_dict(), want)


@pytest.mark.parametrize("layout", ["index", "partial-index", "no-index"])
def test_shard_reader_follows_the_index(layout, tmp_path):
    """With an index only the shards its ``weight_map`` names are read (a
    stray file beside them is not; an index naming one shard reads that
    one); without one, every ``*.safetensors``. Both packages read the
    same tensors, in the same order."""
    family, _, cfg = _configs("llama")
    state = hf_state(hf_shapes(family, cfg), seed=2)
    files = write_shards(state, tmp_path, split=lambda n: ".layers." in n)
    save_file({"model.norm.weight": np.zeros(3, np.float32)}, str(tmp_path / "stray.safetensors"))
    if layout == "partial-index":
        (tmp_path / "model.safetensors.index.json").write_text(
            json.dumps({"weight_map": {n: SHARDS[0] for n in files[SHARDS[0]]}}))
    elif layout == "no-index":
        (tmp_path / "model.safetensors.index.json").unlink()
    want = jhub.read_safetensors_state(str(tmp_path))
    got = phub.read_safetensors_state(str(tmp_path))
    assert list(got) == list(want)
    for name in want:
        assert np.array_equal(got[name].numpy(), want[name]), name
    expect = {"index": state, "partial-index": files[SHARDS[0]]}.get(layout)
    if expect is not None:
        assert set(got) == set(expect)
        assert got["model.norm.weight"].shape == (cfg.hidden_size,)
    else:
        assert got["model.norm.weight"].shape == (3,)  # the stray file is read last, over the shard's


@pytest.mark.parametrize("tied", [False, True], ids=["untied-config", "tied-config"])
def test_tied_head_fallback(tied, tmp_path):
    """A checkpoint without ``lm_head.weight``: an untied model takes the
    embedding table as its head; a tied model holds no head leaf, so the
    fallback leaf is skipped and not counted."""
    family, jcfg, cfg = _configs("llama")
    jcfg, cfg = (dataclasses.replace(c, tie_word_embeddings=tied) for c in (jcfg, cfg))
    state = hf_state(hf_shapes(family, cfg), seed=3)
    state.pop("lm_head.weight", None)
    path = str(tmp_path / "model.safetensors")
    save_file(state, path)
    jmodel = jhub.load_hf_llama(path, jcfg)
    model = phub.load_hf_llama(path, cfg, device="cpu")
    assert_state_equal(model.state_dict(), pm.llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    assert model.imported_weight_count == jmodel.imported_weight_count == jax_leaves(jmodel)
    if not tied:
        assert torch.equal(model.params["lm_head.weight"], model.params["embed_tokens.weight"])


def test_phi3_fused_split_matches_jax():
    _, _, cfg = _configs("phi3")
    state = hf_state(hf_shapes("phi3", cfg), seed=4)
    want = jhub.split_phi3_fused_state(state, cfg.num_attention_heads, cfg.num_key_value_heads)
    got = phub.split_phi3_fused_state({k: torch.from_numpy(v) for k, v in state.items()}, cfg.num_attention_heads,
                                      cfg.num_key_value_heads)
    assert list(got) == list(want) and not any("qkv_proj" in k or "gate_up" in k for k in got)
    for name in want:
        assert np.array_equal(got[name].numpy(), want[name]), name


REFUSALS = {
    # case -> (family, how the checkpoint is broken, a phrase of the message)
    "partial-checkpoint": ("llama", lambda s, d: s.pop("model.layers.1.self_attn.q_proj.weight"),
                           "layer 1 is missing ['attn/q_proj/kernel'] — partial checkpoint?"),
    "optional-leaf-in-some-layers": ("llama", lambda s, d: s.update(
        {"model.layers.0.self_attn.q_proj.bias": np.zeros(d, np.float32)}), "present in some layers"),
    "shape-mismatch": ("llama", lambda s, d: s.update({"model.norm.weight": np.ones(d + 1, np.float32)}),
                       "shape mismatch importing final_norm/scale"),
    "expert-missing": ("mixtral", lambda s, d: s.pop("model.layers.0.block_sparse_moe.experts.1.w3.weight"),
                       "up_proj: experts [1] missing"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_carry_the_jax_message(case, tmp_path):
    family, breaks, phrase = REFUSALS[case]
    _, jcfg, cfg = _configs(family)
    state = hf_state(hf_shapes(family, cfg), seed=5)
    breaks(state, cfg.hidden_size)
    got, want = refusal_messages(family, jcfg, cfg, state, tmp_path)
    assert got == want and phrase in got


@pytest.mark.parametrize("case", ["llama", "gptneox"])
def test_loaded_logits_match_jax_f32(case, jax_loaded):
    family, _, cfg = _configs(case)
    path, _, jmodel = jax_loaded(case)
    model = getattr(phub, f"load_hf_{family}")(path, cfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids))
    with torch.no_grad():
        got = model(torch.as_tensor(ids))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
