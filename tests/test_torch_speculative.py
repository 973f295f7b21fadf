"""Speculative decoding in the port (accelerate_tpu_torch.speculative and the
dense ServingEngine's ``draft_model`` mode): the JAX package's
tests/test_speculative.py and tests/test_serving_speculative.py but their
mesh-sharded cases (ROADMAP.md Queue 1 item 8), and its scheduling tests
of speculative gating, held to the port's own greedy ``generate`` as those
are to the JAX one; then the port beside the JAX package on the same
weights carried by ``models/convert.py``: ``speculative_generate``'s
tokens and stats, and the serving engine's streams, logprobs (within 1e-5,
f32) and ``spec_stats`` with a disjoint draft, with the target as its own
draft, and under ``speculative_priorities`` gating that mixes plain and
speculative ticks (the plain tick leaves the draft cache stale, in both
packages alike). Inputs are made with numpy from a seed."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.scheduling import SchedulerConfig as JaxSchedulerConfig
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.speculative import speculative_generate as jax_speculative_generate
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model, generate, llama_params_from_jax
from accelerate_tpu_torch.scheduling import SchedulerConfig
from accelerate_tpu_torch.speculative import speculative_generate

torch.set_num_threads(2)

LP_ATOL = 1e-5


def _pair(seed, **cfg_kw):
    jcfg = JaxLlamaConfig.tiny(**cfg_kw)
    jmodel = jax_create_llama_model(jcfg, seed=seed, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.fixture(scope="module")
def target_pair():
    return _pair(0)


@pytest.fixture(scope="module")
def draft_pair():
    # a different (1-layer, different-init) model: near-zero acceptance
    return _pair(1, num_hidden_layers=1)


@pytest.fixture(scope="module")
def target(target_pair):
    return target_pair[1]


@pytest.fixture(scope="module")
def draft(draft_pair):
    return draft_pair[1]


def _reference(model, prompt, n):
    return generate(model, np.asarray(prompt, np.int32).reshape(1, -1), max_new_tokens=n)[0].numpy()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in lengths]


# --------------------------------------------------------------------- #
# speculative_generate (tests/test_speculative.py)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_token_exact_with_imperfect_draft(target, draft, gamma):
    ids = (np.arange(8) % 250).astype(np.int32)[None]
    got = speculative_generate(target, draft, ids, max_new_tokens=10, gamma=gamma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[0], _reference(target, ids[0], 10))


def test_perfect_draft_accepts_everything(target):
    ids = np.ones((1, 4), np.int32)
    # 10 = 1 (prefill) + 3 steps x (gamma + 1): no final cut, so the rate is exactly 1
    got, stats = speculative_generate(target, target, ids, max_new_tokens=10, gamma=2, return_stats=True)
    np.testing.assert_array_equal(got.numpy()[0], _reference(target, ids[0], 10))
    assert stats["accept_rate"] == 1.0 and stats["target_forwards"] == 4, stats
    assert stats["tokens_per_target_forward"] > 2.0


def test_eos_stops_early(target, draft):
    ids = np.ones((1, 4), np.int32)
    full = _reference(target, ids[0], 8)
    eos = int(full[6])
    got = speculative_generate(target, draft, ids, max_new_tokens=8, gamma=2, eos_token_id=eos).numpy()[0]
    assert got[-1] == eos
    np.testing.assert_array_equal(got, full[: len(got)])


def test_validation(target, draft):
    ids = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match="batch-1"):
        speculative_generate(target, draft, np.ones((2, 4), np.int32))
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(target, draft, ids, gamma=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        speculative_generate(target, draft, ids, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        speculative_generate(target, draft, ids, max_new_tokens=140)


def test_draft_swap_keeps_tokens(target):
    """Another draft object of the same shapes gives the same tokens: the
    stream is the target's whatever the draft proposes."""
    ids = np.ones((1, 4), np.int32)
    want = _reference(target, ids[0], 4)
    for seed in (1, 2):
        d = create_llama_model(LlamaConfig.tiny(), seed=seed, device="cpu")
        np.testing.assert_array_equal(speculative_generate(target, d, ids, max_new_tokens=4, gamma=2).numpy()[0], want)


@pytest.mark.parametrize("draft_is_target", [False, True])
def test_speculative_generate_matches_jax(target_pair, draft_pair, draft_is_target):
    (jt, t), (jd, d) = target_pair, (target_pair if draft_is_target else draft_pair)
    ids = (np.arange(8) % 250).astype(np.int32)[None]
    want, want_stats = jax_speculative_generate(jt, jd, ids, max_new_tokens=11, gamma=3, return_stats=True)
    got, stats = speculative_generate(t, d, ids, max_new_tokens=11, gamma=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == want_stats


# --------------------------------------------------------------------- #
# speculative serving (tests/test_serving_speculative.py)
# --------------------------------------------------------------------- #

SPEC = dict(num_slots=2, prompt_buckets=(8, 16), tick_block=2, gamma=3)


def test_disjoint_draft_token_exact(target, draft):
    prompts = _prompts(0, (5, 9, 3, 12))
    eng = ServingEngine(target, device="cpu", draft_model=draft, **SPEC)
    for p, got in zip(prompts, eng.generate_many(prompts, max_new_tokens=6)):
        np.testing.assert_array_equal(got, _reference(target, p, 6))
    assert eng.spec_stats["emitted"] == 4 * (6 - 1), eng.spec_stats  # all but each admission's token


def test_self_draft_full_acceptance(target):
    prompts = _prompts(1, (5, 9))
    eng = ServingEngine(target, device="cpu", draft_model=target, **SPEC)
    for p, got in zip(prompts, eng.generate_many(prompts, max_new_tokens=9)):
        np.testing.assert_array_equal(got, _reference(target, p, 9))
    assert eng.spec_stats["accepted"] == eng.spec_stats["steps"] * 3, eng.spec_stats


def test_spec_streaming_logprobs_and_stop(target, draft):
    eng = ServingEngine(target, device="cpu", num_slots=1, prompt_buckets=(8,), tick_block=2, draft_model=draft,
                        gamma=2)
    prompt = np.ones((4,), np.int32)
    full = _reference(target, prompt, 8)
    gen = full[len(prompt):]
    stop = [int(gen[2]), int(gen[3])]
    first = next(i for i in range(len(gen) - 1) if [int(gen[i]), int(gen[i + 1])] == stop)
    uid = eng.submit(prompt, max_new_tokens=8, stop_sequences=[stop])
    while eng.poll(uid) is None:
        assert len(eng.partial(uid)) == len(eng.logprobs(uid))
        eng.step()
    final = eng.poll(uid)
    assert len(final) == len(prompt) + first + 2
    np.testing.assert_array_equal(final, full[: len(final)])
    assert np.all(eng.logprobs(uid) <= 0)


def test_spec_eos_and_slot_reuse(target, draft):
    """EOS retires mid-iteration (the rest of the accepted run is
    discarded) and the freed slot serves the next request token-exact."""
    prompt = np.ones((4,), np.int32)
    full = _reference(target, prompt, 8)
    eos = int(full[6])
    eng = ServingEngine(target, device="cpu", num_slots=1, prompt_buckets=(8,), tick_block=3, draft_model=draft,
                        gamma=3, eos_token_id=eos)
    second = (np.arange(5) % 200).astype(np.int32)
    u1, u2 = eng.submit(prompt, max_new_tokens=8), eng.submit(second, max_new_tokens=4)
    eng.run()
    got1 = eng.poll(u1)
    assert got1[-1] == eos and len(got1) <= len(full)
    np.testing.assert_array_equal(got1, full[: len(got1)])
    np.testing.assert_array_equal(eng.poll(u2), _reference(target, second, 4))
    assert eng.active_count == 0


def test_spec_mode_constraints(target, draft):
    """What the JAX engine refuses, with its messages."""
    with pytest.raises(NotImplementedError, match="dense-layout"):
        ServingEngine(target, device="cpu", draft_model=draft, paged_block_size=4)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        ServingEngine(target, device="cpu", draft_model=draft, temperature=0.7)
    with pytest.raises(ValueError, match="gamma must be >= 1"):
        ServingEngine(target, device="cpu", draft_model=draft, gamma=0)
    with pytest.raises(ValueError, match="exceeds the draft cache"):
        ServingEngine(target, device="cpu", draft_model=create_llama_model(
            LlamaConfig.tiny(max_position_embeddings=64), device="cpu"))
    with pytest.raises(NotImplementedError, match="preemption"):
        ServingEngine(target, device="cpu", draft_model=draft, scheduler=SchedulerConfig(enable_preemption=True))
    eng = ServingEngine(target, device="cpu", num_slots=1, prompt_buckets=(8,), draft_model=draft, max_len=32)
    with pytest.raises(ValueError, match="bucket-sized"):
        eng.submit(np.ones((20,), np.int32))
    with pytest.raises(NotImplementedError, match="prefix caching"):
        eng.register_prefix(np.ones((4,), np.int32))
    with pytest.raises(NotImplementedError, match="prefix caching"):
        eng.submit(np.ones((4,), np.int32), prefix_id=0)
    with pytest.raises(ValueError, match="gamma"):
        eng.submit(np.ones((4,), np.int32), max_new_tokens=30)  # 4 + 30 + gamma > 32


def test_gating_plain_tick_stays_exact(target, draft):
    """speculative_priorities=() routes every tick to the plain target tick."""
    prompts = _prompts(2, (5, 8))
    eng = ServingEngine(target, device="cpu", num_slots=2, prompt_buckets=(8,), tick_block=2, draft_model=draft,
                        gamma=3, scheduler=SchedulerConfig(speculative_priorities=()))
    for p, got in zip(prompts, eng.generate_many(prompts, max_new_tokens=6)):
        np.testing.assert_array_equal(got, _reference(target, p, 6))
    assert eng.spec_stats["steps"] == 0


# --------------------------------------------------------------------- #
# beside the JAX package's speculative engine
# --------------------------------------------------------------------- #


def _drive(engine, submits):
    """``submits``: ``{tick: [(prompt, max_new, priority), ...]}``, each
    submitted before that tick. ``[(tokens, logprobs)]`` in submission
    order once the engine drains."""
    uids, tick = [], 0
    while True:
        uids += [engine.submit(p, n, priority=prio) for p, n, prio in submits.get(tick, ())]
        if not (engine.queue or engine.active_count) and tick > max(submits):
            break
        engine.step()
        tick += 1
    return [(engine.poll(u), engine.logprobs(u)) for u in uids]


@pytest.mark.parametrize("case", ["disjoint", "self", "gated"])
def test_serving_streams_and_stats_match_jax(target_pair, draft_pair, case):
    """The same submissions through both packages' speculative engines:
    tokens equal, logprobs within 1e-5, ``spec_stats`` equal. ``gated``:
    ``speculative_priorities=(0,)`` with priority-1 requests decoding in
    some ticks only, so plain and speculative ticks alternate and the draft
    cache goes stale in between; every stream is still the target's greedy
    one."""
    (jt, t), (jd, d) = target_pair, (target_pair if case == "self" else draft_pair)
    ps = _prompts(3, (5, 9, 3, 12, 7))
    submits = {0: [(ps[0], 9, 0), (ps[1], 6, 0)], 2: [(ps[2], 5, 0)], 3: [(ps[3], 7, 0), (ps[4], 8, 0)]}
    jsched = psched = None
    if case == "gated":
        submits = {0: [(ps[0], 9, 0), (ps[1], 4, 1)], 3: [(ps[2], 5, 1), (ps[3], 7, 0)], 5: [(ps[4], 8, 0)]}
        jsched, psched = JaxSchedulerConfig(speculative_priorities=(0,)), SchedulerConfig(speculative_priorities=(0,))
    jeng = JaxServingEngine(jt, draft_model=jd, scheduler=jsched, **SPEC)
    eng = ServingEngine(t, device="cpu", draft_model=d, scheduler=psched, **SPEC)
    plain_ticks = []
    plain_tick = eng._decode_tick
    eng._decode_tick = lambda: (plain_ticks.append(1), plain_tick())[1]
    want, got = _drive(jeng, submits), _drive(eng, submits)
    for (jtok, jlp), (tok, lp) in zip(want, got):
        np.testing.assert_array_equal(tok, jtok)
        np.testing.assert_allclose(lp, jlp, atol=LP_ATOL, rtol=0)
    assert eng.spec_stats == jeng.spec_stats and eng.spec_stats["steps"] > 0
    for (tok, _), (p, n, _) in zip(got, [s for k in sorted(submits) for s in submits[k]]):
        np.testing.assert_array_equal(tok, _reference(t, p, n))
    assert bool(plain_ticks) == (case == "gated")
