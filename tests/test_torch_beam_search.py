"""Beam search in the port (accelerate_tpu_torch.generation.beam_search): the
six tests of the JAX package's tests/test_beam_search.py held to the
port's own ``generate`` and forward as those are to the JAX ones (beam 1
is greedy, the chosen beam never scores below greedy, the reported score
is the teacher-forced log-probability over the length, EOS freezes a
beam, batch rows are independent, validation), then beside the JAX
package's beam search on the same weights carried by
``models/convert.py``: outputs equal and normalised scores within 1e-5
(f32), with and without EOS, batched, at several beam counts and length
penalties. Inputs are made with numpy from a seed."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import beam_search as jax_beam_search
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu_torch import LlamaConfig, create_llama_model, generate, llama_params_from_jax
from accelerate_tpu_torch.generation import beam_search

torch.set_num_threads(2)

SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxLlamaConfig.tiny()
    jmodel = jax_create_llama_model(jcfg, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.fixture(scope="module")
def tiny_llama(pair):
    return pair[1]


def _seq_logprob(model, ids, prompt_len):
    """f32 log-probability of the generated suffix under the model (teacher-forced)."""
    with torch.no_grad():
        logp = torch.log_softmax(model(torch.as_tensor(np.asarray(ids)).long()).float(), dim=-1)[0]
    return sum(float(logp[t, int(ids[0, t + 1])]) for t in range(prompt_len - 1, ids.shape[1] - 1))


def test_beam1_equals_greedy(tiny_llama):
    ids = (np.arange(2 * 6).reshape(2, 6) % 250).astype(np.int32)
    want = generate(tiny_llama, ids, max_new_tokens=5)
    got = beam_search(tiny_llama, ids, max_new_tokens=5, num_beams=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_beams_never_score_below_greedy(tiny_llama):
    ids = (np.arange(7) % 250).astype(np.int32)[None]
    greedy = generate(tiny_llama, ids, max_new_tokens=6).numpy()
    beam = beam_search(tiny_llama, ids, max_new_tokens=6, num_beams=4).numpy()
    assert _seq_logprob(tiny_llama, beam, 7) >= _seq_logprob(tiny_llama, greedy, 7) - 1e-4


def test_reported_score_matches_recomputed(tiny_llama):
    ids = np.ones((1, 5), np.int32)
    out, score = beam_search(tiny_llama, ids, max_new_tokens=4, num_beams=3, return_scores=True)
    assert score.shape == (1,) and score.dtype == torch.float32
    np.testing.assert_allclose(float(score[0]), _seq_logprob(tiny_llama, out.numpy(), 5) / 4.0, atol=1e-5)


def test_eos_freezes_beam(tiny_llama):
    ids = np.ones((1, 4), np.int32)
    free = beam_search(tiny_llama, ids, max_new_tokens=8, num_beams=3).numpy()[0]
    eos = int(free[6])  # a token the winning beam emits mid-sequence
    gen = beam_search(tiny_llama, ids, max_new_tokens=8, num_beams=3, eos_token_id=eos).numpy()[0][4:].tolist()
    assert eos in gen
    assert all(t == eos for t in gen[gen.index(eos):]), gen


def test_batched_rows_independent(tiny_llama):
    a = (np.arange(6) % 250).astype(np.int32)
    c = (np.arange(50, 56) % 250).astype(np.int32)
    both = beam_search(tiny_llama, np.stack([a, c]), max_new_tokens=4, num_beams=3).numpy()
    np.testing.assert_array_equal(both[0], beam_search(tiny_llama, a[None], max_new_tokens=4, num_beams=3)[0].numpy())
    np.testing.assert_array_equal(both[1], beam_search(tiny_llama, c[None], max_new_tokens=4, num_beams=3)[0].numpy())


def test_validation(tiny_llama):
    ids = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match="num_beams"):
        beam_search(tiny_llama, ids, num_beams=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        beam_search(tiny_llama, ids, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        beam_search(tiny_llama, ids, max_new_tokens=999)


@pytest.mark.parametrize("num_beams,length_penalty,use_eos", [(3, 1.0, False), (4, 0.6, True), (2, 1.5, True)])
def test_matches_jax_beam_search(pair, num_beams, length_penalty, use_eos):
    """Two prompts batched, 9 new tokens; with ``use_eos`` the EOS is a
    token the free-running best beam emits at its fourth step, so frozen
    beams and unequal lengths enter the normalised score."""
    jmodel, model = pair
    ids = np.random.default_rng(3).integers(1, 250, size=(2, 7)).astype(np.int32)
    kw = dict(max_new_tokens=9, num_beams=num_beams, length_penalty=length_penalty)
    if use_eos:
        kw["eos_token_id"] = int(beam_search(model, ids, **kw)[0, 7 + 3])
    want, want_score = jax_beam_search(jmodel, ids, return_scores=True, **kw)
    got, score = beam_search(model, ids, return_scores=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), atol=SCORE_ATOL, rtol=0)
