"""The port's ServingEngine on its dense layout (``paged_block_size=None``,
the default): the dense-layout cases of the JAX package's
tests/test_serving.py held to the port's own ``generate`` as those are to
the JAX one (single request, mixed lengths through fewer slots, midstream
submits, eos, streaming and cancel, chunked prefill, prefix caching and
its validation, sampling, stop sequences, logprobs against a
full-context forward), then the port's dense engine beside the JAX
package's dense engine on the same weights carried by
``models/convert.py``: tiny Llama and tiny Gemma2 (its softcaps and its
alternating 8-key band) through chunk windows, a prefix and midstream
submits, and a decode preemption resumed by recompute. Tokens equal,
logprobs within 1e-5 (f32). Inputs are made with numpy from a seed."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.models as jm
from accelerate_tpu.scheduling import SchedulerConfig as JaxSchedulerConfig
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import ServingEngine, generate, llama_params_from_jax
from accelerate_tpu_torch.scheduling import SchedulerConfig

torch.set_num_threads(2)

LP_ATOL = 1e-5

FAMILIES = {"llama": ("LlamaConfig", "create_llama_model"), "gemma2": ("Gemma2Config", "create_gemma2_model")}


def _pair(family):
    """The JAX family's tiny model and the port's on the same weights (the
    norms moved off their identity init, so Gemma2's sandwich norms bite)."""
    cls_name, create = FAMILIES[family]
    jcfg = getattr(jm, cls_name).tiny()
    jmodel = getattr(jm, create)(jcfg, seed=2, seq_len=16)
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if str(getattr(path[-1], "key", path[-1])) == "scale":
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    jmodel.params = jax.tree_util.tree_map_with_path(perturb, jmodel.params)
    cfg = getattr(pm, cls_name)(**dataclasses.asdict(jcfg))
    model = getattr(pm, create)(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def model(llama):
    return llama[1]


def _reference(model, prompt, n):
    return generate(model, np.asarray(prompt, np.int32)[None], max_new_tokens=n)[0].numpy()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in lengths]


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


# --------------------------------------------------------------------- #
# tests/test_serving.py's dense cases, against the port's generate
# --------------------------------------------------------------------- #


def test_single_request_matches_generate(model):
    prompt = (np.arange(8) % 250).astype(np.int32)
    [got] = _engine(model, num_slots=2, prompt_buckets=(8, 16)).generate_many([prompt], max_new_tokens=6)
    np.testing.assert_array_equal(got, _reference(model, prompt, 6))


def test_mixed_lengths_and_more_requests_than_slots(model):
    prompts = _prompts(0, (3, 8, 5, 12, 2, 7, 9, 4))
    eng = _engine(model, num_slots=2, prompt_buckets=(4, 8, 16))
    for prompt, got in zip(prompts, eng.generate_many(prompts, max_new_tokens=5)):
        np.testing.assert_array_equal(got, _reference(model, prompt, 5))
    assert eng.pool_free_blocks is None and eng.metrics.kv_block_utilization is None


def test_incremental_submit_midstream(model):
    eng = _engine(model, num_slots=2, prompt_buckets=(8,))
    a = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
    eng.step()
    eng.step()
    b = eng.submit(np.arange(20, 25, dtype=np.int32), max_new_tokens=4)
    eng.run()
    np.testing.assert_array_equal(eng.poll(a), _reference(model, np.arange(1, 7), 8))
    np.testing.assert_array_equal(eng.poll(b), _reference(model, np.arange(20, 25), 4))


def test_eos_retires_slot(model):
    prompt = np.ones((4,), np.int32)
    full = _reference(model, prompt, 8)
    eos = int(full[6])  # a token generate emits
    eng = _engine(model, num_slots=1, prompt_buckets=(4,), eos_token_id=eos)
    [got] = eng.generate_many([prompt], max_new_tokens=8)
    assert len(got) <= len(full) and got[-1] == eos and eng.active_count == 0
    np.testing.assert_array_equal(got, full[: len(got)])


def test_partial_streams_and_cancel(model):
    eng = _engine(model, num_slots=2, prompt_buckets=(8,), tick_block=2)
    a = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
    b = eng.submit(np.arange(20, 25, dtype=np.int32), max_new_tokens=8)
    assert eng.partial(a).size == 0
    eng.step()
    assert 0 < eng.partial(a).size < 8 and eng.poll(a) is None
    assert eng.cancel(b).size >= 1
    eng.run()
    np.testing.assert_array_equal(eng.poll(a), _reference(model, np.arange(1, 7), 8))
    np.testing.assert_array_equal(eng.partial(a), eng.poll(a)[6:])
    assert eng.poll(b) is None
    with pytest.raises(KeyError):
        eng.partial(b)
    with pytest.raises(ValueError, match="finished"):
        eng.cancel(a)
    c = eng.submit(np.ones(3, np.int32), max_new_tokens=4)
    assert eng.cancel(c).size == 0
    with pytest.raises(KeyError):
        eng.cancel(999)


def test_validation_errors(model):
    eng = _engine(model, num_slots=1, prompt_buckets=(4,), max_len=16)
    with pytest.raises(ValueError, match="cache"):
        eng.submit(np.ones((4,), np.int32), max_new_tokens=99)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _engine(model, max_len=999)
    with pytest.raises(ValueError, match="bucket"):
        _engine(model, prompt_buckets=(8, 999))
    with pytest.raises(ValueError, match="pool_blocks requires paged_block_size"):
        _engine(model, pool_blocks=9)
    with pytest.raises(ValueError, match="empty stop sequence"):
        eng.submit(np.ones((2,), np.int32), stop_sequences=[[]])


@pytest.mark.parametrize("length,buckets", [(12, (4, 8)), (13, (8,))])
def test_long_prompt_chunked_prefill(model, length, buckets):
    """Longer than the largest bucket: end-aligned chunk windows (13 over
    8: windows [0, 8) and [5, 13), the overlap recomputed)."""
    prompt = (np.arange(length) % 250 + 1).astype(np.int32)
    [got] = _engine(model, num_slots=2, prompt_buckets=buckets).generate_many([prompt], max_new_tokens=4)
    np.testing.assert_array_equal(got, _reference(model, prompt, 4))


def test_prefix_cache_token_exact(model):
    prefix = (np.arange(6) % 250 + 3).astype(np.int32)
    eng = _engine(model, num_slots=2, prompt_buckets=(4, 8))
    pid = eng.register_prefix(prefix)
    rows = [t.clone() for t in eng._prefixes[pid]["rows"]]
    sufs = [np.asarray([9, 8, 7], np.int32), np.asarray([11, 12], np.int32),
            (np.arange(9) + 40).astype(np.int32)]  # 6 + 9 = 15 over 8: a warm window starting inside the prefix
    uids = [eng.submit(s, max_new_tokens=5, prefix_id=pid) for s in sufs]
    eng.run()
    for uid, s in zip(uids, sufs):
        np.testing.assert_array_equal(eng.poll(uid), _reference(model, np.concatenate([prefix, s]), 5))
    assert all(torch.equal(a, b) for a, b in zip(rows, eng._prefixes[pid]["rows"]))  # never written
    assert eng.metrics.prefix_hits == 3


def test_prefix_validation_and_eviction(model):
    eng = _engine(model, num_slots=1, prompt_buckets=(4,), max_len=16)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit(np.ones((2,), np.int32), prefix_id=7)
    with pytest.raises(ValueError, match="empty"):
        eng.register_prefix(np.zeros((0,), np.int32))
    pid = eng.register_prefix(np.ones((6,), np.int32))
    with pytest.raises(ValueError, match="cache"):
        eng.submit(np.ones((4,), np.int32), max_new_tokens=8, prefix_id=pid)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int32), prefix_id=pid)
    uid = eng.submit(np.asarray([3, 4], np.int32), max_new_tokens=2, prefix_id=pid)
    with pytest.raises(ValueError, match="still referenced"):
        eng.unregister_prefix(pid)
    eng.run()
    assert eng.poll(uid) is not None
    eng.unregister_prefix(pid)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.unregister_prefix(pid)


def test_sampling_deterministic_per_seed_and_in_top_k(model):
    """temperature 1 / top-k 8: equal seeds give equal streams, another
    seed another, and every sampled token lies in the top 8 of its step
    with its logprob under the full distribution."""
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(30, 38, dtype=np.int32)]

    def run(seed):
        eng = _engine(model, num_slots=2, prompt_buckets=(8,), temperature=1.0, top_k=8, seed=seed)
        uids = [eng.submit(p, 6) for p in prompts]
        eng.run()
        return [(eng.poll(u), eng.logprobs(u)) for u in uids]

    a, b, c = run(1), run(1), run(2)
    for (x, _), (y, _) in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for (x, _), (y, _) in zip(a, c))
    with torch.no_grad():
        for (tokens, lps), p in zip(a, prompts):
            logits = model(torch.tensor(tokens[None, :-1]))[0]
            for i in range(len(p), len(tokens)):
                assert int(tokens[i]) in torch.topk(logits[i - 1], 8).indices.tolist()
                lp = float(torch.log_softmax(logits[i - 1], -1)[tokens[i]])
                assert lp == pytest.approx(lps[i - len(p)], abs=LP_ATOL)


def test_top_k1_collapses_to_greedy(model):
    prompt = (np.arange(8) % 250).astype(np.int32)
    eng = _engine(model, num_slots=1, prompt_buckets=(8,), temperature=5.0, top_k=1)
    [got] = eng.generate_many([prompt], max_new_tokens=5)
    np.testing.assert_array_equal(got, _reference(model, prompt, 5))


def test_stop_sequences_end_generation(model):
    prompt = np.ones((4,), np.int32)
    full = _reference(model, prompt, 8)
    gen = full[len(prompt):]
    stop = [int(gen[3]), int(gen[4])]
    first = next(i for i in range(len(gen) - 1) if [int(gen[i]), int(gen[i + 1])] == stop)
    eng = _engine(model, num_slots=2, prompt_buckets=(4, 8))
    u_stop = eng.submit(prompt, max_new_tokens=8, stop_sequences=[stop])
    u_free = eng.submit(prompt, max_new_tokens=8)
    eng.run()
    got_stop = eng.poll(u_stop)
    np.testing.assert_array_equal(eng.poll(u_free), full)
    assert len(got_stop) == len(prompt) + first + 2 and list(got_stop[-2:]) == stop
    np.testing.assert_array_equal(got_stop, full[: len(got_stop)])


def test_logprobs_match_full_context_forward(model):
    """Greedy logprobs equal the f32 log-softmax of a full-context forward
    at each generated position, on both layouts."""
    prompt = (np.arange(6) % 250).astype(np.int32)
    for kwargs in ({}, {"paged_block_size": 4}):
        eng = _engine(model, num_slots=2, prompt_buckets=(8, 16), **kwargs)
        uid = eng.submit(prompt, max_new_tokens=5)
        eng.run()
        full, lps = eng.poll(uid), eng.logprobs(uid)
        assert lps.shape == (5,) and lps.dtype == np.float32
        with torch.no_grad():
            ref = torch.log_softmax(model(torch.tensor(full[None, :-1]))[0], -1)
        want = [float(ref[len(prompt) + i - 1, full[len(prompt) + i]]) for i in range(5)]
        np.testing.assert_allclose(lps, want, atol=LP_ATOL, rtol=0)


# --------------------------------------------------------------------- #
# beside the JAX package's dense engine
# --------------------------------------------------------------------- #


def _drive(engine, prefix, prompts, late, max_new=6):
    """Register ``prefix``; submit ``prompts`` (the last one on the
    prefix), one tick, then ``late`` midstream; run to the end.
    ``[(tokens, logprobs)]`` in submission order."""
    pid = engine.register_prefix(prefix)
    uids = [engine.submit(p, max_new) for p in prompts[:-1]] + [engine.submit(prompts[-1], max_new, prefix_id=pid)]
    engine.step()
    uids += [engine.submit(p, max_new) for p in late]
    engine.run()
    return [(engine.poll(u), engine.logprobs(u)) for u in uids]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_matches_jax_dense_engine(family, llama):
    """Three requests in two slots (a 19-token prompt through chunk
    windows, a suffix on a 10-token prefix), two more midstream: tokens
    equal, logprobs within 1e-5. Gemma2's prompts run past its 8-key band
    and its softcaps bite on every layer."""
    jmodel, model = llama if family == "llama" else _pair(family)
    prefix, prompts, late = _prompts(1, (10,))[0], _prompts(0, (3, 19, 5)), _prompts(2, (26, 6))
    kw = dict(num_slots=2, prompt_buckets=(4, 8), tick_block=4)
    want = _drive(JaxServingEngine(jmodel, **kw), prefix, prompts, late)
    got = _drive(_engine(model, **kw), prefix, prompts, late)
    for (jt, jl), (tt, tl) in zip(want, got):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=LP_ATOL, rtol=0)


def test_preempt_resume_matches_jax_dense_engine(llama):
    """A priority-0 arrival evicts the decoding priority-1 request from the
    only slot; it resumes by recompute. Both engines step alike (the
    victim requeued with the same streamed tokens), and both requests'
    tokens and logprobs equal the JAX engine's and an unpreempted control's."""
    jmodel, model = llama
    kw = dict(num_slots=1, prompt_buckets=(8,), tick_block=2)
    jeng = JaxServingEngine(jmodel, scheduler=JaxSchedulerConfig(enable_preemption=True), **kw)
    eng = _engine(model, scheduler=SchedulerConfig(enable_preemption=True), **kw)
    p_victim, p_urgent = (np.arange(6) % 250 + 1).astype(np.int32), np.asarray([3, 1, 4, 1, 5], np.int32)
    ju, u = jeng.submit(p_victim, 10, priority=1), eng.submit(p_victim, 10, priority=1)
    jeng.step(), eng.step()
    jv, v = jeng.submit(p_urgent, 4, priority=0), eng.submit(p_urgent, 4, priority=0)
    jeng.step(), eng.step()
    assert eng._locate(u)[1].preempted and eng.metrics.decode_preemptions == 1
    streamed = eng.partial(u)
    np.testing.assert_array_equal(streamed, jeng.partial(ju))
    jeng.run(), eng.run()
    assert eng.metrics.resumes == jeng.metrics.resumes == 1
    for a, b in ((ju, u), (jv, v)):
        np.testing.assert_array_equal(eng.poll(b), jeng.poll(a))
        np.testing.assert_allclose(eng.logprobs(b), jeng.logprobs(a), atol=LP_ATOL, rtol=0)
    control = _engine(model, **kw)
    c = control.submit(p_victim, 10, priority=1)
    control.run()
    np.testing.assert_array_equal(eng.poll(u), control.poll(c))
    np.testing.assert_allclose(eng.logprobs(u), control.logprobs(c), atol=LP_ATOL, rtol=0)
    assert eng.recomputed_tokens == len(p_victim) + len(streamed) - 1
