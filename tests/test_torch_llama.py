"""The port's llama (accelerate_tpu_torch.models) against the JAX package's:
rope frequencies for every rope type, logits of the plain forward on
converted weights (scanned and unrolled param layouts, tied head, sliding
window), and cached prefill plus single-token steps through the dense
cache. f32 on the CPU; inputs made with numpy from a seed."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.models.llama import rope as jax_rope
from accelerate_tpu.models.llama import rope_frequencies as jax_rope_frequencies
from accelerate_tpu_torch.models import LlamaConfig, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.models.llama import rope, rope_frequencies

torch.set_num_threads(2)

D = 64
ROPE_CASES = [
    pytest.param(None, {}, id="default"),
    pytest.param({"rope_type": "linear", "factor": 4.0}, {}, id="linear"),
    pytest.param(
        {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
         "original_max_position_embeddings": 8192}, {}, id="llama3",
    ),
    pytest.param({"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 2048}, {}, id="yarn"),
    pytest.param(
        {"rope_type": "yarn", "factor": 8.0, "mscale": 1.0, "mscale_all_dim": 0.5, "truncate": False},
        {"max_pos": 4096}, id="yarn-mscale",
    ),
    pytest.param(
        {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 1024},
        {"seq_len": 4096}, id="dynamic",
    ),
    pytest.param(
        {"rope_type": "longrope", "short_factor": list(np.linspace(1.0, 2.0, D // 2)),
         "long_factor": list(np.linspace(1.0, 8.0, D // 2)), "original_max_position_embeddings": 4096},
        {"max_pos": 131072, "seq_len": 100}, id="longrope-short",
    ),
    pytest.param(
        {"rope_type": "longrope", "short_factor": list(np.linspace(1.0, 2.0, D // 2)),
         "long_factor": list(np.linspace(1.0, 8.0, D // 2)), "original_max_position_embeddings": 4096},
        {"max_pos": 131072, "seq_len": 8000}, id="longrope-long",
    ),
]


@pytest.mark.parametrize("scaling,kw", ROPE_CASES)
def test_rope_frequencies_match_jax(scaling, kw):
    want, want_factor = jax_rope_frequencies(D, 10000.0, scaling, **kw)
    got, got_factor = rope_frequencies(D, 10000.0, scaling, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert got_factor == pytest.approx(want_factor, abs=1e-12)


def test_rope_interleaved_pairs_match_jax():
    """The rotation pairs x[..., ::2] with x[..., 1::2] (not rotate-half)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    pos = np.stack([np.arange(5), np.arange(7, 12)]).astype(np.int32)
    scaling = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 2048}
    want = jax_rope(jax.numpy.asarray(x), jax.numpy.asarray(pos), 10000.0, scaling)
    got = rope(torch.tensor(x), torch.tensor(pos), 10000.0, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@functools.cache
def _pair_of(items):
    jcfg = JaxLlamaConfig.tiny(**dict(items))
    jmodel = jax_create_llama_model(jcfg, seed=1, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


def _pair(**kw):
    """A JAX tiny llama and the port's llama carrying its weights (built
    once per configuration)."""
    return _pair_of(tuple(sorted((k, v) for k, v in kw.items() if v is not None)))


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize(
    "kw",
    [
        pytest.param({}, id="scanned"),
        pytest.param({"scan_layers": False}, id="unrolled"),
        pytest.param({"tie_word_embeddings": True}, id="tied-head"),
        pytest.param({"sliding_window": 5}, id="window"),
    ],
)
def test_forward_logits_match_jax(kw):
    jmodel, model = _pair(**kw)
    ids = _ids(2, 12)
    want = np.asarray(jax.jit(jmodel.apply_fn)(jmodel.params, ids))
    got = model(torch.tensor(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("window", [None, 5])
def test_cached_prefill_and_steps_match_jax(window):
    """Prefill 8 tokens into a fresh cache, then three single-token steps:
    the port's dense cached_attention against the JAX decode path."""
    jmodel, model = _pair(sliding_window=window)
    ids = _ids(2, 11, seed=1)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    want, jcache = jmodel.apply_fn(jmodel.params, ids[:, :8], positions=pos[:, :8], decode=True, cache=None)
    got, cache = model(torch.tensor(ids[:, :8]), positions=torch.tensor(pos[:, :8]), decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert cache.index == 8
    for t in range(8, 11):
        want, jcache = jmodel.apply_fn(
            jmodel.params, ids[:, t : t + 1], positions=pos[:, t : t + 1], decode=True, cache=jcache
        )
        got, cache = model(
            torch.tensor(ids[:, t : t + 1]), positions=torch.tensor(pos[:, t : t + 1]), decode=True, cache=cache
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert cache.index == 11
    # the cache agrees with a plain forward over the whole sequence
    full = model(torch.tensor(ids))
    np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(), atol=1e-4, rtol=0)


def test_bf16_stream_keeps_f32_head():
    """In bf16 the stream and projections are bf16 while the LM head and
    the logits stay f32, as in the JAX module."""
    model = create_llama_model(LlamaConfig.tiny(), device="cpu", dtype=torch.bfloat16)
    assert model.dtype == torch.bfloat16
    assert model.module.lm_head.weight.dtype == torch.float32
    logits = model(torch.tensor(_ids(1, 6)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
