"""The port's Whisper (models/whisper.py) against the JAX package's, at
``tiny()`` on the same weights (tests/torch_seq2seq_common.py): the
config and its refusal, ``sinusoids``, the converter's names, forward
logits in f32 at odd and even frame counts (``(frames + 1) // 2``
encoder positions), the encoder in the features' dtype under bf16
weights, the cached decode step by step, one AdamW step of
``seq2seq_lm_loss`` through ``build_train_step`` against the JAX
Accelerator's, and the port's refusal of decoder positions past the table
(where the JAX package's gather clamps). Inputs are made with numpy from a
seed; everything runs on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import seq2seq_lm_loss as jax_seq2seq_lm_loss
from accelerate_tpu.models import whisper as jwhisper
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import (
    WhisperConfig,
    create_whisper_model,
    seq2seq_lm_loss,
    whisper_params_from_jax,
)
from accelerate_tpu_torch.models.whisper import sinusoids
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from torch_seq2seq_common import MELS, decoder_ids, jax_model, jax_params, port_model, source

torch.set_num_threads(2)

F32_ATOL = 1e-5
LOSS_RTOL = PARAM_ATOL = 1e-4
BATCH, TGT, LR, WD = 8, 6, 1e-3, 0.01


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def test_config_matches_jax_and_refuses_a_cache_past_the_table():
    assert dataclasses.asdict(WhisperConfig.tiny()) == dataclasses.asdict(jwhisper.WhisperConfig.tiny())
    assert dataclasses.asdict(WhisperConfig()) == dataclasses.asdict(jwhisper.WhisperConfig())
    for cls in (WhisperConfig, jwhisper.WhisperConfig):
        with pytest.raises(ValueError, match="max_decode_len .* exceeds max_target_positions"):
            cls(max_decode_len=449)


@pytest.mark.parametrize("length,channels", [(32, 32), (1500, 1280), (7, 4)])
def test_sinusoids_equal_jax(length, channels):
    np.testing.assert_array_equal(sinusoids(length, channels), jwhisper.sinusoids(length, channels))


def test_sinusoids_refuse_odd_channels():
    with pytest.raises(ValueError, match="even"):
        sinusoids(4, 5)


def test_parameter_names_and_the_constant_positions():
    """The converter fills every parameter; the encoder positions are a
    buffer outside the state dict (the JAX tree has no such leaf), equal
    to the sinusoids; ``dec_pos`` is a parameter."""
    cfg = WhisperConfig.tiny()
    model = create_whisper_model(cfg, device="cpu")
    sd = whisper_params_from_jax(jax_params("whisper"), cfg)
    assert set(model.state_dict()) == set(sd)
    assert "enc_pos" not in sd and "dec_pos" in sd
    assert sd["conv1.weight"].shape == (cfg.d_model, cfg.num_mel_bins, 3)
    assert not any(k.endswith("k_proj.bias") for k in sd) and any(k.endswith("v_proj.bias") for k in sd)
    np.testing.assert_array_equal(model.module.enc_pos.numpy(), jwhisper.sinusoids(32, cfg.d_model))


@pytest.mark.parametrize("frames", [15, 16, 17, 63])
def test_forward_logits_match_jax_f32(frames):
    jmodel, model = jax_model("whisper"), port_model("whisper")
    feats, dec = source("whisper", frames=frames), decoder_ids()
    want = np.asarray(jmodel.apply_fn(jmodel.params, feats, dec))
    got = model(torch.as_tensor(feats), torch.as_tensor(dec))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    assert model.module.encode(torch.as_tensor(feats)).shape == (2, (frames + 1) // 2, 32)


def test_encoder_runs_in_the_features_dtype():
    """bf16 weights with f32 features: the encoder computes in f32 (its
    output is f32), the decoder in bf16, as flax's ``dtype=`` does; the
    logits within 4 bf16 ulps of the largest against the JAX model's on
    the same bf16 weights."""
    jmodel, model = jax_model("whisper", dtype=jnp.bfloat16), port_model("whisper", dtype=torch.bfloat16)
    feats, dec = source("whisper", seed=3), decoder_ids(seed=4)
    assert model.module.encode(torch.as_tensor(feats)).dtype == torch.float32
    want = np.asarray(jmodel.apply_fn(jmodel.params, feats, dec)).astype(np.float32)
    got = model(torch.as_tensor(feats), torch.as_tensor(dec)).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=4 * ulp, rtol=0)


@pytest.mark.parametrize("frames,prefill", [(15, 1), (16, 1), (16, 4)])
def test_cached_decode_matches_jax_step_by_step(frames, prefill):
    """The prefill and then one token a step, each step's logits within
    1e-5 of ``apply_fn(decode=True)``'s; the decoder position is the
    cache's write index."""
    jmodel, model = jax_model("whisper"), port_model("whisper")
    feats, dec = source("whisper", seed=2, frames=frames), decoder_ids(s=9, seed=6)
    logits, jcache = jmodel.apply_fn(jmodel.params, feats, dec[:, :prefill], decode=True, cache=None)
    got, cache = model(torch.as_tensor(feats), torch.as_tensor(dec[:, :prefill]), decode=True, cache=None)
    errs = [float(np.abs(got.numpy() - np.asarray(logits)).max())]
    for i in range(prefill, 9):
        logits, jcache = jmodel.apply_fn(jmodel.params, feats, dec[:, i:i + 1], decode=True, cache=jcache)
        got, cache = model(torch.as_tensor(feats), torch.as_tensor(dec[:, i:i + 1]), decode=True, cache=cache)
        errs.append(float(np.abs(got.numpy() - np.asarray(logits)).max()))
    assert max(errs) <= F32_ATOL, errs
    assert cache.self_kv.index == int(jcache["dec_pos"]) == 9
    assert cache.enc_out.shape == (2, (frames + 1) // 2, 32) and cache.enc_out.dtype == torch.float32


def test_decoder_positions_past_the_table_raise():
    """The JAX package's gather clamps a position past
    ``max_target_positions`` to the last row; the port raises, naming the
    limit, in both the full forward and the cached decode."""
    model = port_model("whisper")
    feats = torch.as_tensor(source("whisper"))
    with pytest.raises(ValueError, match="max_target_positions"):
        model(feats, torch.zeros((2, 33), dtype=torch.int32))
    assert model.config.max_decode_len == model.config.max_target_positions == 32
    _, cache = model(feats, torch.zeros((2, 31), dtype=torch.int32), decode=True, cache=None)
    _, cache = model(feats, torch.zeros((2, 1), dtype=torch.int32), decode=True, cache=cache)
    with pytest.raises(ValueError, match="max_target_positions"):
        model(feats, torch.zeros((2, 1), dtype=torch.int32), decode=True, cache=cache)


def test_encoder_positions_past_the_sinusoids_raise():
    model = port_model("whisper")
    with pytest.raises(ValueError, match="max_source_positions"):
        model.module.encode(torch.zeros((1, 65, MELS)))
    assert model.module.encode(torch.zeros((1, 64, MELS))).shape[1] == 32


def test_train_step_matches_jax():
    """One AdamW step of ``seq2seq_lm_loss`` over log-mel features, f32:
    the loss, then every parameter (the JAX side on the suite's 8-device
    mesh). The key projection has no bias; an element whose gradient is
    under 1e-6 follows the rounding of Adam's ``g / (|g| + eps)`` and is
    held to 2 lr."""
    rng = np.random.default_rng(9)
    batch = {"input_ids": rng.standard_normal((BATCH, 16, MELS)).astype(np.float32),
             "labels": rng.integers(0, 256, size=(BATCH, TGT)).astype(np.int32)}
    batch["labels"][:, -2:] = -100
    jacc = JaxAccelerator()
    jmodel = jacc.prepare_model(jax_model("whisper"))
    jacc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    jstep = jacc.build_train_step(lambda p, b: jax_seq2seq_lm_loss(p, b, jmodel.apply_fn))
    want_loss = float(jstep(jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                           batch_sharding(jacc.mesh))))
    model = port_model("whisper")
    want = whisper_params_from_jax(jax.tree.map(np.asarray, jmodel.params), model.config)
    model.module.requires_grad_(True)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    seq2seq_lm_loss(model.params, tbatch, model.apply_fn).backward()
    tiny_grad = {n: p.grad.abs() < 1e-6 for n, p in model.module.named_parameters()}
    model.module.zero_grad(set_to_none=True)
    acc = Accelerator(cpu=True)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD))
    step = acc.build_train_step(lambda p, b: seq2seq_lm_loss(p, b, model.apply_fn))
    assert float(step(tbatch)) == pytest.approx(want_loss, rel=LOSS_RTOL)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        atol = torch.where(tiny_grad[name], 2 * LR, PARAM_ATOL)
        err = (got[name] - want[name]).abs()
        assert bool((err <= atol).all()), f"{name}: {float((err - atol).max())} past its tolerance"
