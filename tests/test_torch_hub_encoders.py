"""The port's HF checkpoint importers (accelerate_tpu_torch.models.hub) for
BERT, T5, ViT, Whisper and CLIP against the JAX package's
(accelerate_tpu.models.hub). Each family's seeded HF-named checkpoint is
loaded by both packages' ``load_hf_*``: the port's state dict must equal,
bit for bit, the JAX loaded params carried by ``models/convert.py``, with
the same ``imported_weight_count`` (every leaf of the model imported),
from one f32 file and from two bf16 shards with an index. Then T5's and
Whisper's forward logits in f32 within their family tests' 1e-5
(tests/test_torch_t5.py, test_torch_whisper.py), the leaves the models do
not hold (Whisper's sinusoid table), and a refusal with the JAX text."""

import re

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu_torch.models as pm
import accelerate_tpu_torch.models.hub as phub
from torch_hub_common import check_family, configs, hf_state, make_jax_loaded, port_shapes, refusal_messages

torch.set_num_threads(2)

F32_ATOL = 1e-5

_CLASS = {"bert": "BertConfig", "t5": "T5Config", "vit": "ViTConfig", "whisper": "WhisperConfig",
          "clip": "CLIPConfig"}
# case -> (family, config overrides)
CASES = {"bert": ("bert", {}), "t5": ("t5", {"tie_word_embeddings": False}), "vit": ("vit", {}),
         "whisper": ("whisper", {}), "clip": ("clip", {})}

# the port's parameter names -> HF's, substitutions applied in order
_RENAMES = {
    "bert": [(r"^encoder\.embeddings\.norm\.", "bert.embeddings.LayerNorm."),
             (r"^encoder\.embeddings\.", "bert.embeddings."),
             (r"^encoder\.layers\.(\d+)\.attention\.(query|key|value)\.", r"bert.encoder.layer.\1.attention.self.\2."),
             (r"^encoder\.layers\.(\d+)\.attention\.out\.", r"bert.encoder.layer.\1.attention.output.dense."),
             (r"^encoder\.layers\.(\d+)\.attention_norm\.", r"bert.encoder.layer.\1.attention.output.LayerNorm."),
             (r"^encoder\.layers\.(\d+)\.ffn\.intermediate\.", r"bert.encoder.layer.\1.intermediate.dense."),
             (r"^encoder\.layers\.(\d+)\.ffn\.output\.", r"bert.encoder.layer.\1.output.dense."),
             (r"^encoder\.layers\.(\d+)\.ffn_norm\.", r"bert.encoder.layer.\1.output.LayerNorm."),
             (r"^pooler\.", "bert.pooler.dense.")],
    "t5": [(r"^enc_final_norm\.", "encoder.final_layer_norm."), (r"^dec_final_norm\.", "decoder.final_layer_norm."),
           (r"^enc_layers\.(\d+)\.ln_attn\.", r"encoder.block.\1.layer.0.layer_norm."),
           (r"^enc_layers\.(\d+)\.attn\.", r"encoder.block.\1.layer.0.SelfAttention."),
           (r"^enc_layers\.(\d+)\.ln_ffn\.", r"encoder.block.\1.layer.1.layer_norm."),
           (r"^enc_layers\.(\d+)\.ffn\.", r"encoder.block.\1.layer.1.DenseReluDense."),
           (r"^dec_layers\.(\d+)\.ln_self\.", r"decoder.block.\1.layer.0.layer_norm."),
           (r"^dec_layers\.(\d+)\.self_attn\.", r"decoder.block.\1.layer.0.SelfAttention."),
           (r"^dec_layers\.(\d+)\.ln_cross\.", r"decoder.block.\1.layer.1.layer_norm."),
           (r"^dec_layers\.(\d+)\.cross_attn\.", r"decoder.block.\1.layer.1.EncDecAttention."),
           (r"^dec_layers\.(\d+)\.ln_ffn\.", r"decoder.block.\1.layer.2.layer_norm."),
           (r"^dec_layers\.(\d+)\.ffn\.", r"decoder.block.\1.layer.2.DenseReluDense."),
           (r"\.(q|k|v|o)_proj\.", r".\1."), (r"\.relative_bias$", ".relative_attention_bias.weight")],
    "vit": [(r"^cls_token$", "vit.embeddings.cls_token"), (r"^pos_embed$", "vit.embeddings.position_embeddings"),
            (r"^patch_embed\.", "vit.embeddings.patch_embeddings.projection."),
            (r"^final_norm\.", "vit.layernorm."), (r"^head\.", "classifier."),
            (r"^block_(\d+)\.norm1\.", r"vit.encoder.layer.\1.layernorm_before."),
            (r"^block_(\d+)\.norm2\.", r"vit.encoder.layer.\1.layernorm_after."),
            (r"^block_(\d+)\.attention\.(query|key|value)\.", r"vit.encoder.layer.\1.attention.attention.\2."),
            (r"^block_(\d+)\.attention\.out\.", r"vit.encoder.layer.\1.attention.output.dense."),
            (r"^block_(\d+)\.mlp\.up\.", r"vit.encoder.layer.\1.intermediate.dense."),
            (r"^block_(\d+)\.mlp\.down\.", r"vit.encoder.layer.\1.output.dense.")],
    "whisper": [(r"^conv(\d)\.", r"model.encoder.conv\1."), (r"^dec_pos$", "model.decoder.embed_positions.weight"),
                (r"^embed_tokens\.", "model.decoder.embed_tokens."),
                (r"^(enc|dec)_final_norm\.", r"model.\1.layer_norm."),
                (r"^(enc|dec)_layers\.", r"model.\1.layers."),
                (r"\.ln_self\.", ".self_attn_layer_norm."), (r"\.ln_cross\.", ".encoder_attn_layer_norm."),
                (r"\.ln_ffn\.", ".final_layer_norm."), (r"\.cross_attn\.", ".encoder_attn."),
                (r"^model\.enc\.", "model.encoder."), (r"^model\.dec\.", "model.decoder.")],
    "clip": [(r"^vision\.class_embedding$", "vision_model.embeddings.class_embedding"),
             (r"^vision\.pos_embed$", "vision_model.embeddings.position_embedding.weight"),
             (r"^vision\.patch_embed\.", "vision_model.embeddings.patch_embedding."),
             (r"^vision\.pre_norm\.", "vision_model.pre_layrnorm."),
             (r"^vision\.post_norm\.", "vision_model.post_layernorm."),
             (r"^text\.token_embed\.", "text_model.embeddings.token_embedding."),
             (r"^text\.pos_embed$", "text_model.embeddings.position_embedding.weight"),
             (r"^text\.final_norm\.", "text_model.final_layer_norm."),
             (r"^(vision|text)\.block_(\d+)\.", r"\1_model.encoder.layers.\2."),
             (r"\.ln(\d)\.", r".layer_norm\1."), (r"\.(q|k|v|out)_proj\.", r".self_attn.\1_proj."),
             (r"\.(fc\d)\.", r".mlp.\1.")],
}


def _configs(case):
    family, kw = CASES[case]
    return (family, *configs(_CLASS[family], **kw))


def hf_shapes(family: str, cfg) -> dict:
    """``{HF name: shape}`` of a checkpoint holding every parameter of the
    port's ``family`` model at ``cfg`` (the port's Linear and Conv weights
    keep torch's layout, HF's too), and for Whisper the encoder's sinusoid
    table, which HF ships and the model computes."""
    out = {}
    for name, shape in port_shapes(family, cfg).items():
        for pattern, repl in _RENAMES[family]:
            name = re.sub(pattern, repl, name)
        out[name] = shape
    if family == "whisper":
        out["model.encoder.embed_positions.weight"] = (cfg.max_source_positions, cfg.d_model)
    return out


def convert(family: str):
    fn = getattr(pm, f"{family}_params_from_jax")
    return (lambda params, cfg: fn(params)) if family in ("vit", "clip") else fn


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


def test_whisper_sinusoid_table_is_not_imported(jax_loaded):
    """HF ships the encoder's sinusoid positions; both models compute them,
    so the leaf is read and skipped: the buffer keeps the model's own."""
    family, _, cfg = _configs("whisper")
    path, state, _ = jax_loaded("whisper")
    assert "model.encoder.embed_positions.weight" in state
    model = phub.load_hf_whisper(path, cfg, device="cpu")
    fresh = pm.create_whisper_model(cfg, device="cpu")
    assert torch.equal(model.module.enc_pos, fresh.module.enc_pos)


def test_t5_relative_bias_shape_mismatch_carries_the_jax_message(tmp_path):
    family, jcfg, cfg = _configs("t5")
    state = hf_state(hf_shapes(family, cfg), seed=5)
    name = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    state[name] = state[name][:-1]
    got, want = refusal_messages(family, jcfg, cfg, state, tmp_path)
    assert got == want and "shape mismatch importing enc_layer_0/attn/relative_bias/embedding" in got


def test_t5_loaded_logits_match_jax_f32(jax_loaded):
    family, _, cfg = _configs("t5")
    path, _, jmodel = jax_loaded("t5")
    model = phub.load_hf_t5(path, cfg, device="cpu")
    rng = np.random.default_rng(0)
    src = rng.integers(2, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, src, dec, None))
    with torch.no_grad():
        got = model(torch.as_tensor(src), torch.as_tensor(dec), None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_whisper_loaded_logits_match_jax_f32(jax_loaded):
    family, _, cfg = _configs("whisper")
    path, _, jmodel = jax_loaded("whisper")
    model = phub.load_hf_whisper(path, cfg, device="cpu")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 16, cfg.num_mel_bins)).astype(np.float32)
    dec = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, feats, dec))
    with torch.no_grad():
        got = model(torch.as_tensor(feats), torch.as_tensor(dec))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
