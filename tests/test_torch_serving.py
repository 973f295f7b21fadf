"""The port's paged ServingEngine (accelerate_tpu_torch.serving) against the
JAX package's paged ServingEngine on the same converted weights, greedy:
tokens exactly equal and logprobs within 1e-4, through mixed prompt
lengths with chunked prefill, more requests than slots, a tight pool,
midstream submits, eos and stop sequences, and the JAX engine running its
Pallas kernel in interpret mode. Sampled serving is checked on the port
alone (jax.random and torch.Generator draw different numbers)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.ops.paged_kv as jax_paged_kv
import accelerate_tpu.utils.quantization as jq
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch import (
    LlamaConfig,
    QuantizationConfig,
    ServingEngine,
    create_llama_model,
    llama_params_from_jax,
    load_and_quantize_model,
)
from accelerate_tpu_torch.scheduling import SchedulerConfig

torch.set_num_threads(2)

LP_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = JaxLlamaConfig.tiny()
    jmodel = jax_create_llama_model(jcfg, seed=2, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in lengths]


def _drive(engine, prompts, max_new, stops=None, late=()):
    """Submit ``prompts`` (``stops[i]`` as request i's stop sequences), one
    tick, then the ``late`` prompts midstream; run to completion. Returns
    ``[(tokens, logprobs)]`` in submission order."""
    stops = stops or [None] * len(prompts)
    uids = [engine.submit(p, max_new, stop_sequences=s) for p, s in zip(prompts, stops)]
    engine.step()
    uids += [engine.submit(p, max_new) for p in late]
    engine.run()
    return [(engine.poll(u), engine.logprobs(u)) for u in uids]


def _assert_same(jax_out, port_out, lp_atol=LP_ATOL):
    assert len(jax_out) == len(port_out)
    for (jt, jl), (tt, tl) in zip(jax_out, port_out):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=lp_atol, rtol=0)


# 2 slots for 7 requests; buckets up to 8 so the 19- and 26-token prompts
# stream through chunk windows; 9 usable blocks of 4 rows do not hold
# every pair of requests at once, so admission waits on the pool
ENGINE = dict(num_slots=2, prompt_buckets=(4, 8), paged_block_size=4, pool_blocks=10, tick_block=4)
LENGTHS = (3, 19, 5, 8, 2)
LATE = (26, 6)


def test_matches_jax_engine_mixed_lengths_tight_pool_midstream(models):
    jmodel, model = models
    prompts, late = _prompts(0, LENGTHS), _prompts(1, LATE)
    jeng = JaxServingEngine(jmodel, **ENGINE)
    want = _drive(jeng, prompts, 6, late=late)
    eng = ServingEngine(model, device="cpu", **ENGINE)
    got = _drive(eng, prompts, 6, late=late)
    _assert_same(want, got)
    assert eng.metrics.preemptions > 0  # the pool did block admission
    assert eng.pool_free_blocks == ENGINE["pool_blocks"] - 1  # every block back, trash sink excluded
    snap = eng.metrics.snapshot()
    assert snap["requests_completed"] == len(prompts) + len(late) and snap["tokens_generated"] == 6 * 7


@pytest.mark.parametrize("method,group_size", [("int4", 64), ("int8", None), ("nf4", 16), ("w8a8", None)])
def test_quantized_model_serves_as_the_jax_engine_does(method, group_size):
    """A weight-only quantized Llama is a Model like any other: the JAX
    package quantizes, its codes are carried across, and both paged engines
    serve it, chunked prefill and a tight pool included; the port's own
    load_and_quantize_model of the float weights serves the same tokens.
    Logprobs within 1e-4, but for w8a8: it rounds every projection's input
    to int8, so a last-bit difference in an activation on a rounding tie
    flips a code and stays in the KV cache (logprobs within 5e-2 then)."""
    bits = 8 if method in ("int8", "w8a8") else 4
    lp_atol = 5e-2 if method == "w8a8" else LP_ATOL
    jmodel = jax_create_llama_model(JaxLlamaConfig.tiny(hidden_size=128, intermediate_size=256), seed=2, seq_len=16)
    jqmodel = jq.load_and_quantize_model(jmodel, jq.QuantizationConfig(method=method, group_size=group_size, bits=bits))
    qcfg = LlamaConfig(**dataclasses.asdict(jqmodel.config))
    qmodel = create_llama_model(qcfg, device="cpu")
    qmodel.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jqmodel.params), qcfg))
    prompts, late = _prompts(10, (3, 19, 5)), _prompts(11, (9,))
    want = _drive(JaxServingEngine(jqmodel, **ENGINE), prompts, 6, late=late)
    eng = ServingEngine(qmodel, device="cpu", **ENGINE)
    _assert_same(want, _drive(eng, prompts, 6, late=late), lp_atol)
    assert eng.pool_free_blocks == ENGINE["pool_blocks"] - 1
    fcfg = LlamaConfig(**dataclasses.asdict(jmodel.config))
    fmodel = create_llama_model(fcfg, device="cpu")
    fmodel.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), fcfg))
    own = load_and_quantize_model(fmodel, QuantizationConfig(method=method, group_size=group_size, bits=bits))
    _assert_same(want, _drive(ServingEngine(own, device="cpu", **ENGINE), prompts, 6, late=late), lp_atol)


def test_eos_and_stop_sequences_match_jax(models):
    """eos and per-request stop sequences, chosen from the free-running
    greedy streams so that each one fires mid-generation."""
    jmodel, model = models
    prompts = _prompts(2, (4, 7, 12))
    free = ServingEngine(model, device="cpu", **ENGINE).generate_many(prompts, max_new_tokens=8)
    eos = int(free[0][len(prompts[0]) + 2])
    gen1 = free[1][len(prompts[1]) :]
    stops = [None, [gen1[3:5].tolist()], [[7, 7, 7], free[2][len(prompts[2]) + 4 : len(prompts[2]) + 5].tolist()]]
    kw = dict(ENGINE, eos_token_id=eos)
    want = _drive(JaxServingEngine(jmodel, **kw), prompts, 8, stops=stops)
    got = _drive(ServingEngine(model, device="cpu", **kw), prompts, 8, stops=stops)
    _assert_same(want, got)
    assert got[0][0][-1] == eos and len(got[0][0]) < len(prompts[0]) + 8
    assert any(len(t) < len(p) + 8 for (t, _), p in zip(got[1:], prompts[1:]))


def test_matches_jax_engine_running_its_kernel(models):
    """The JAX engine's paged tick through the Pallas kernel (interpret
    mode), the composition TPU serving runs, against the port."""
    jmodel, model = models
    prompts = _prompts(3, (3, 6, 11))
    kw = dict(num_slots=2, prompt_buckets=(8,), paged_block_size=4, tick_block=2)
    jax_paged_kv.FORCE_KERNEL_INTERPRET = True
    try:
        want = _drive(JaxServingEngine(jmodel, **kw), prompts, 3)
    finally:
        jax_paged_kv.FORCE_KERNEL_INTERPRET = False
    _assert_same(want, _drive(ServingEngine(model, device="cpu", **kw), prompts, 3))


def test_token_budget_interleaving_keeps_tokens(models):
    """A token budget streams chunk windows across ticks while decodes run;
    tokens and logprobs equal the unbudgeted engine's."""
    _, model = models
    prompts, late = _prompts(4, (19, 3, 26)), _prompts(5, (9,))
    want = _drive(ServingEngine(model, device="cpu", **ENGINE), prompts, 5, late=late)
    eng = ServingEngine(model, device="cpu", scheduler=SchedulerConfig(token_budget=10), **ENGINE)
    _assert_same(want, _drive(eng, prompts, 5, late=late))


def test_sampled_serving_reproducible_and_in_top_k(models):
    """temperature 0.8 / top-k 5: equal seeds give equal streams, and every
    sampled token lies in the top 5 of that step's logits."""
    _, model = models
    prompts = _prompts(6, (5, 11, 3))
    kw = dict(ENGINE, temperature=0.8, top_k=5, seed=7)
    runs = [_drive(ServingEngine(model, device="cpu", **kw), prompts, 6) for _ in range(2)]
    _assert_same(runs[0], runs[1])
    other = _drive(ServingEngine(model, device="cpu", **dict(kw, seed=8)), prompts, 6)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(runs[0], other))
    with torch.no_grad():
        for (tokens, lps), p in zip(runs[0], prompts):
            logits = model(torch.tensor(tokens[None, :-1]))[0]
            for i in range(len(p), len(tokens)):
                row = logits[i - 1]
                assert int(tokens[i]) in torch.topk(row, 5).indices.tolist()
                assert float(torch.log_softmax(row, -1)[tokens[i]]) == pytest.approx(lps[i - len(p)], abs=LP_ATOL)


def test_streaming_accessors_and_cancel(models):
    _, model = models
    eng = ServingEngine(model, device="cpu", **ENGINE)
    a = eng.submit(_prompts(7, (5,))[0], max_new_tokens=12)
    b = eng.submit(_prompts(8, (6,))[0], max_new_tokens=12)
    c = eng.submit(_prompts(9, (4,))[0], max_new_tokens=3)
    assert eng.partial(c).size == 0 and eng.logprobs(c).size == 0  # queued
    eng.step()
    so_far = eng.partial(a)
    assert 0 < len(so_far) == len(eng.logprobs(a)) < 12
    free = eng.pool_free_blocks
    np.testing.assert_array_equal(eng.cancel(a), so_far)
    assert eng.pool_free_blocks > free and eng.metrics.requests_cancelled == 1
    with pytest.raises(KeyError):
        eng.partial(a)
    eng.run()
    assert eng.poll(a) is None and len(eng.partial(b)) == 12 and len(eng.partial(c)) == 3
    assert eng.pool_free_blocks == ENGINE["pool_blocks"] - 1
    with pytest.raises(ValueError, match="already finished"):
        eng.cancel(b)


def test_not_ported_surface_raises(models):
    """What the engine still refuses, each naming its ROADMAP.md item: the
    dense layout, speculative serving, a softcapped model (which the dense
    layout serves), perf_check / numerics_check, the runtime services and
    the fleet's surface (tracing, KV handoff, failover)."""
    from accelerate_tpu_torch.models import Gemma2Config, create_gemma2_model

    _, model = models
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 6"):
        ServingEngine(model, device="cpu")  # dense layout
    with pytest.raises(NotImplementedError, match="item 6"):
        ServingEngine(model, device="cpu", paged_block_size=4, draft_model=model)
    with pytest.raises(NotImplementedError, match="softcapping.*item 6"):
        ServingEngine(create_gemma2_model(Gemma2Config.tiny(), device="cpu"), device="cpu", paged_block_size=4)
    for kw in (dict(telemetry_log=object()), dict(program_cache=object()), dict(auto_bucketing=True)):
        with pytest.raises(NotImplementedError, match="item 9"):
            ServingEngine(model, device="cpu", paged_block_size=4, **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        ServingEngine(model, device="cpu", paged_block_size=4, tracer=object())
    eng = ServingEngine(model, device="cpu", paged_block_size=4)
    for call, item in ((eng.export_inflight, 10), (eng.import_inflight, 10), (eng.kv_handoff_dims, 10),
                       (eng.prefill_detached, 10), (eng.submit_prefilled, 10), (eng.perf_check, 6),
                       (eng.numerics_check, 6), (lambda: eng.submit([1, 2], 2, trace=3), 10)):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 item {item}"):
            call()
    with pytest.raises(ValueError, match="pool blocks"):
        ServingEngine(model, device="cpu", paged_block_size=4, pool_blocks=3).submit([1] * 8, max_new_tokens=8)


@pytest.mark.cuda
def test_cuda_tiny_head_dim_serves_through_the_kernel():
    """LlamaConfig.tiny() (head dim 16) served by the paged engine on the
    card: every decode step's attention is the paged kernel, and the greedy
    tokens equal a no-cache loop over the model's full forward (a request's
    comparison may end only at a top-2 logit gap under 1e-4, f32 rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode (chip_smoke.py runs it on the H100)")
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = LlamaConfig.tiny()
    model = create_llama_model(cfg, seed=5, dtype=torch.float32)
    prompts = _prompts(7, (5, 19, 40))
    engine = ServingEngine(model, num_slots=2, prompt_buckets=(16, 64), paged_block_size=8, tick_block=4)
    before = pa.launches
    uids = [engine.submit(p, 8) for p in prompts]
    engine.run()
    assert pa.launches - before == cfg.num_hidden_layers * engine.decode_steps > 0
    with torch.no_grad():
        for uid, p in zip(uids, prompts):
            seq = torch.as_tensor(p, device="cuda")[None].long()
            for tok in engine.poll(uid)[len(p):].tolist():
                row = model(seq)[0, -1].float()
                top2 = torch.topk(row, 2).values
                if tok != int(row.argmax()):
                    assert float(top2[0] - top2[1]) < 1e-4
                    break
                seq = torch.cat([seq, torch.tensor([[tok]], device="cuda")], dim=1)


@pytest.mark.cuda
def test_cuda_tiny_mistral_serves_through_the_kernel_with_expiry():
    """MistralConfig.tiny() (an 8-key band, head dim 16) served by the paged
    engine on the card: every decode step's attention is the paged kernel,
    blocks behind the band return to the pool while the requests decode,
    the pool drains, and the greedy tokens equal the CPU engine's on the
    same weights (a request's comparison may end only at a top-2 logit gap
    under 1e-4 of the CPU's dense forward, f32 rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode (chip_smoke.py runs it on the H100)")
    import copy

    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models import MistralConfig, create_mistral_model
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = MistralConfig.tiny()
    cpu = create_mistral_model(cfg, seed=5, device="cpu")
    card = Model(copy.deepcopy(cpu.module).to("cuda"), cfg, name=cpu.name)
    prompts = _prompts(12, (5, 19, 40))
    kw = dict(num_slots=2, prompt_buckets=(16, 64), paged_block_size=4, tick_block=4)
    engine = ServingEngine(card, **kw)
    want = ServingEngine(cpu, device="cpu", **kw).generate_many(prompts, 24)
    before = pa.launches
    uids = [engine.submit(p, 24) for p in prompts]
    freed = False
    while engine.queue or engine.active_count:
        done, free = len(engine.done), engine.pool_free_blocks
        engine.step()
        freed |= len(engine.done) == done and engine.pool_free_blocks > free  # no retirement freed them
    assert freed and engine.pool_free_blocks == engine._pcfg.num_blocks - 1
    assert pa.launches - before == cfg.num_hidden_layers * engine.decode_steps > 0
    with torch.no_grad():
        for uid, p, w in zip(uids, prompts, want):
            got = engine.poll(uid)
            diff = np.nonzero(got != w)[0]
            if len(diff):
                row = cpu(torch.as_tensor(w[None, : diff[0]]).long())[0, -1]
                top2 = torch.topk(row, 2).values
                assert float(top2[0] - top2[1]) < 1e-4

