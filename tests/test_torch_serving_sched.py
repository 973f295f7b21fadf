"""The port's paged ServingEngine memory and scheduling (windowed block
expiry, prefix caching, decode preemption with resume by recompute, SLO
shedding) against the JAX package's paged ServingEngine on the same
weights, carried across by ``models/convert.py``. Each test mirrors its
JAX counterpart in tests/test_serving_paged.py or tests/test_scheduling.py
and drives both engines through the same submissions and ticks: tokens
equal, ``pool_free_blocks`` equal after every ``step()``, logprobs within
1e-5 (f32), shed reasons and ShedError fields equal. A resumed request is
held to an unpreempted JAX control (tokens equal, logprobs within 1e-5:
the recompute sums in another order than decode did), and a sampled
resume to the port's own unpreempted control, token for token (jax.random
and torch.Generator draw different numbers)."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.models as jm
from accelerate_tpu.scheduling import SchedulerConfig as JaxSchedulerConfig
from accelerate_tpu.scheduling import ShedError as JaxShedError
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.telemetry.serving_metrics import ServingMetrics as JaxServingMetrics
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import ServingEngine, llama_params_from_jax
from accelerate_tpu_torch.scheduling import SchedulerConfig, ShedError
from accelerate_tpu_torch.telemetry.serving_metrics import ServingMetrics
from accelerate_tpu_torch.test_utils.fault_injection import CrashPoint, SimulatedCrash

torch.set_num_threads(2)

LP_ATOL = 1e-5

# family -> (config class name, create function name)
FAMILIES = {
    "llama": ("LlamaConfig", "create_llama_model"),
    "mistral": ("MistralConfig", "create_mistral_model"),
    "phi3": ("Phi3Config", "create_phi3_model"),
    "gemma3": ("Gemma3Config", "create_gemma3_model"),
}


def _pair(family, seq_len=32, **cfg_kw):
    """The JAX family's tiny model and the port's on the same weights."""
    cls_name, create = FAMILIES[family]
    jcfg = getattr(jm, cls_name).tiny(**cfg_kw)
    jmodel = getattr(jm, create)(jcfg, seed=2, seq_len=seq_len)
    cfg = getattr(pm, cls_name)(**dataclasses.asdict(jcfg))
    model = getattr(pm, create)(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def banded():
    """{family: (jax, port)} with a 4-key band: on every layer of Mistral
    and Phi-3, on the sliding one of Gemma3's two."""
    return {f: _pair(f, sliding_window=4) for f in ("mistral", "phi3", "gemma3")}


@pytest.fixture(scope="module")
def banded8():
    """Mistral and Phi-3 with an 8-key band: a 2-block prefix lies in it."""
    return {f: _pair(f, sliding_window=8) for f in WINDOWED}


def _engines(pair, jax_sched=None, port_sched=None, **kw):
    jmodel, model = pair
    jeng = JaxServingEngine(jmodel, scheduler=jax_sched, **kw)
    eng = ServingEngine(model, device="cpu", scheduler=port_sched, **kw)
    return jeng, eng


def _step_both(jeng, eng):
    """One tick of each engine; the pools hold the same number of free
    blocks after it."""
    jn, n = jeng.step(), eng.step()
    assert n == jn
    assert eng.pool_free_blocks == jeng.pool_free_blocks
    return n


def _run_both(jeng, eng):
    """Tick both engines to the end, the pools compared after every tick;
    returns the tick count."""
    ticks = 0
    while jeng.queue or jeng.active_count or eng.queue or eng.active_count:
        _step_both(jeng, eng)
        ticks += 1
    return ticks


def _assert_same(jeng, juids, eng, uids, lp_atol=LP_ATOL):
    for ju, u in zip(juids, uids):
        np.testing.assert_array_equal(eng.poll(u), jeng.poll(ju))
        np.testing.assert_allclose(eng.logprobs(u), jeng.logprobs(ju), atol=lp_atol, rtol=0)


def _submit_both(jeng, eng, prompt, max_new, **kw):
    return jeng.submit(prompt, max_new, **kw), eng.submit(prompt, max_new, **kw)


# --------------------------------------------------------------------- #
# windowed block expiry (tests/test_serving_paged.py:245-337)
# --------------------------------------------------------------------- #

WINDOWED = ("mistral", "phi3")


@pytest.mark.parametrize("family", WINDOWED)
def test_windowed_request_pool_cost_is_window_bound(banded, family):
    """A 24-token prompt with a 4-key band fits a pool of 3 usable blocks
    (without the band it would need 8) and serves as the JAX engine does."""
    jeng, eng = _engines(banded[family], num_slots=1, prompt_buckets=(8,), paged_block_size=4, pool_blocks=4)
    prompt = (np.arange(24) % 250 + 1).astype(np.int32)
    ju, u = _submit_both(jeng, eng, prompt, 6)
    _run_both(jeng, eng)
    _assert_same(jeng, [ju], eng, [u])
    assert eng.pool_free_blocks == 3


@pytest.mark.parametrize("family", WINDOWED)
def test_window_recycles_blocks_mid_decode(banded, family):
    """Blocks behind the moving frontier return to the pool while the
    request still decodes, tick for tick as in the JAX engine."""
    jeng, eng = _engines(banded[family], num_slots=1, prompt_buckets=(8,), paged_block_size=4, tick_block=2)
    ju, u = _submit_both(jeng, eng, np.arange(1, 5, dtype=np.int32), 16)
    _step_both(jeng, eng)
    after_admit = eng.pool_free_blocks
    recovered = False
    while eng.active_count or jeng.active_count:
        _step_both(jeng, eng)
        if eng.active_count and eng.pool_free_blocks > after_admit:
            recovered = True
    assert recovered
    assert eng.pool_free_blocks == eng._pcfg.num_blocks - 1
    _assert_same(jeng, [ju], eng, [u])


@pytest.mark.parametrize("family", WINDOWED)
def test_windowed_prefix_token_exact(banded, family):
    """Below-band prefix blocks are never aliased (they start as trash);
    outputs equal the JAX engine's; unregistering drains the pool."""
    jeng, eng = _engines(banded[family], num_slots=2, prompt_buckets=(4, 8), paged_block_size=4)
    prefix = (np.arange(9) % 250 + 3).astype(np.int32)
    jpid, pid = jeng.register_prefix(prefix), eng.register_prefix(prefix)
    assert eng.pool_free_blocks == jeng.pool_free_blocks
    assert eng._prefixes[pid]["block_ids"] == jeng._prefixes[jpid]["block_ids"]
    assert jpid == pid
    pairs = [_submit_both(jeng, eng, np.asarray(s, np.int32), 4, prefix_id=pid) for s in ([5, 6], [9])]
    _run_both(jeng, eng)
    _assert_same(jeng, [a for a, _ in pairs], eng, [b for _, b in pairs])
    jeng.unregister_prefix(jpid)
    eng.unregister_prefix(pid)
    assert eng.pool_free_blocks == jeng.pool_free_blocks == eng._pcfg.num_blocks - 1


@pytest.mark.parametrize("family", WINDOWED)
def test_windowed_shared_prefix_alias_and_expiry(banded8, family):
    """Prefix blocks inside an 8-key band are aliased, then expire
    mid-decode by a refcount drop while the other slot still shares them."""
    jeng, eng = _engines(banded8[family], num_slots=2, prompt_buckets=(4, 16),
                         paged_block_size=4, tick_block=2)
    prefix = (np.arange(8) % 250 + 3).astype(np.int32)
    jpid, pid = jeng.register_prefix(prefix), eng.register_prefix(prefix)
    assert jpid == pid and len(eng._prefixes[pid]["block_ids"]) == 2
    pairs = [_submit_both(jeng, eng, np.asarray([s], np.int32), 10, prefix_id=pid) for s in (5, 9)]
    _step_both(jeng, eng)
    assert any(eng._slot_shared[s] for s in range(2))
    refs_seen = set()
    while eng.queue or eng.active_count:
        _step_both(jeng, eng)
        refs_seen.add(tuple(sorted(eng._shared_refs.values())))
        assert sorted(eng._shared_refs.values()) == sorted(jeng._shared_refs.values())
    assert len(refs_seen) > 1  # the counts dropped while the requests decoded
    _assert_same(jeng, [a for a, _ in pairs], eng, [b for _, b in pairs])
    assert all(v == 1 for v in eng._shared_refs.values())
    jeng.unregister_prefix(jpid)
    eng.unregister_prefix(pid)
    assert eng.pool_free_blocks == eng._pcfg.num_blocks - 1


@pytest.mark.parametrize("family", WINDOWED)
def test_windowed_prefix_registration_is_band_capped(banded, family):
    """A 24-token prefix under a 4-key band registers only in-band blocks."""
    jeng, eng = _engines(banded[family], num_slots=1, prompt_buckets=(8,), paged_block_size=4, pool_blocks=4)
    prefix = (np.arange(24) % 250 + 1).astype(np.int32)
    jpid, pid = jeng.register_prefix(prefix), eng.register_prefix(prefix)
    assert eng._prefixes[pid]["block_ids"] == jeng._prefixes[jpid]["block_ids"]
    assert len(eng._prefixes[pid]["block_ids"]) <= 2
    eng.unregister_prefix(pid)
    assert eng.pool_free_blocks == 3


def test_mixed_layer_kinds_serve_in_band_without_expiry(banded):
    """Gemma3's sliding + full layers: the full layer reads every position,
    so no block expires; both engines serve it in its band alike."""
    jeng, eng = _engines(banded["gemma3"], num_slots=2, prompt_buckets=(4, 8), paged_block_size=4, tick_block=2)
    assert eng._window is None and jeng._window is None
    prompts = [(np.arange(n) % 250 + 1).astype(np.int32) for n in (13, 3)]
    pairs = [_submit_both(jeng, eng, p, 10) for p in prompts]
    _step_both(jeng, eng)
    after_admit = eng.pool_free_blocks
    while eng.active_count:
        _step_both(jeng, eng)
        if eng.active_count == 2:
            assert eng.pool_free_blocks == after_admit  # nothing freed before a retirement
    _assert_same(jeng, [a for a, _ in pairs], eng, [b for _, b in pairs])
    assert eng.pool_free_blocks == eng._pcfg.num_blocks - 1


# --------------------------------------------------------------------- #
# prefix caching (tests/test_serving_paged.py:92)
# --------------------------------------------------------------------- #


def test_shared_prefix_blocks(llama):
    """Requests sharing a registered prefix alias its FULL blocks
    (refcounted); outputs (prefix included) equal the JAX engine's;
    unregister returns the shared blocks."""
    jeng, eng = _engines(llama, num_slots=2, prompt_buckets=(4, 8), paged_block_size=4)
    prefix = (np.arange(9) % 250 + 3).astype(np.int32)  # 2 full 4-blocks + 1 tail row
    jpid, pid = jeng.register_prefix(prefix), eng.register_prefix(prefix)
    held = eng.pool_free_blocks
    assert jpid == pid and held == jeng.pool_free_blocks
    pairs = [_submit_both(jeng, eng, np.asarray(s, np.int32), 4, prefix_id=pid) for s in ([5, 6], [9])]
    _run_both(jeng, eng)
    _assert_same(jeng, [a for a, _ in pairs], eng, [b for _, b in pairs])
    assert eng.poll(pairs[0][1])[: len(prefix)].tolist() == prefix.tolist()
    assert eng.pool_free_blocks == held
    eng.unregister_prefix(pid)
    assert eng.pool_free_blocks == held + 2


def test_engine_counts_prefix_use_and_pool_high_water(llama):
    """The port's engine counts its own prefix registrations, hits and
    evictions (the JAX package's fleet counts them for its engines), the
    pool's high-water mark where it allocates and the most slots a decode
    tick advanced: two requests alias a 2-block prefix and own 2 blocks
    each, so 6 blocks are in use at once and 2 slots decode together."""
    _, model = llama
    eng = ServingEngine(model, device="cpu", num_slots=2, prompt_buckets=(4, 8), paged_block_size=4, tick_block=2)
    prefix = (np.arange(9) % 250 + 3).astype(np.int32)
    pid = eng.register_prefix(prefix)
    assert eng.metrics.prefix_registrations == 1 and eng.metrics.pool_high_water_blocks == 2
    for s in ([5, 6], [9]):
        eng.submit(np.asarray(s, np.int32), 4, prefix_id=pid)
    in_use = []
    while eng.queue or eng.active_count:
        eng.step()
        in_use.append(eng._pcfg.num_blocks - 1 - eng.pool_free_blocks)
    eng.unregister_prefix(pid)
    snap = eng.metrics.snapshot()
    assert snap["prefix_hits"] == 2 and snap["prefix_tokens_reused"] == 2 * len(prefix)
    assert snap["prefix_misses"] == 0 and snap["prefix_evictions"] == 1
    assert snap["pool_high_water_blocks"] == max(in_use) == 6
    assert snap["decode_slots_high_water"] == 2


def test_prefix_validation_matches_jax(llama):
    """The refusals of register_prefix, submit(prefix_id=...),
    unregister_prefix and run()'s unsatisfiable head."""
    jeng, eng = _engines(llama, num_slots=1, prompt_buckets=(4, 8), paged_block_size=4, pool_blocks=8)
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="empty prefix"):
            e.register_prefix([])
        with pytest.raises(ValueError, match="unknown prefix_id"):
            e.submit([1, 2], 2, prefix_id=7)
        with pytest.raises(ValueError, match="unknown prefix_id"):
            e.unregister_prefix(7)
        pid = e.register_prefix((np.arange(16) % 250 + 1).astype(np.int32))  # holds 4 blocks
        uid = e.submit([3], 2, prefix_id=pid)
        with pytest.raises(ValueError, match="still referenced"):
            e.unregister_prefix(pid)
        e.cancel(uid)
        e.submit(np.ones((8,), np.int32), max_new_tokens=8)  # needs 4, only 3 ever free
        with pytest.raises(RuntimeError, match="pool blocks"):
            e.run()


def test_paste_blocks_matches_jax():
    """paste_blocks writes a row cache's blocks at write_row's ids, table
    and frontiers untouched, as the JAX function does. Entries equal to 0
    are the trash sink's: the JAX function scatters them into block 0, the
    port skips them (block 0 is only ever read masked), so block 0 is left
    out of the comparison. A row cache of fewer rows than the table fills
    the entries it covers."""
    import jax.numpy as jnp

    from accelerate_tpu.ops.paged_kv import paste_blocks as jax_paste_blocks
    from accelerate_tpu_torch.ops.kv_cache import KVCache
    from accelerate_tpu_torch.ops.paged_kv import PagedKVCache, paste_blocks

    rng = np.random.default_rng(9)
    n_layers, nb, bs, h_kv, d, mb = 2, 9, 4, 2, 8, 6
    pools = [rng.standard_normal((n_layers, nb, bs, h_kv, d)).astype(np.float32) for _ in range(2)]
    rows = [rng.standard_normal((n_layers, 1, mb * bs, h_kv, d)).astype(np.float32) for _ in range(2)]
    table, index = rng.integers(0, nb, size=(3, mb)).astype(np.int32), np.arange(3, dtype=np.int32)
    write_row = np.asarray([0, 5, 2, 0, 7, 0], np.int32)  # entries 0, 3 and 5: shared or pad
    jcache = {"key_pool": jnp.asarray(pools[0]), "value_pool": jnp.asarray(pools[1]),
              "block_table": jnp.asarray(table), "index": jnp.asarray(index)}
    want = jax_paste_blocks(jcache, {"key": jnp.asarray(rows[0]), "value": jnp.asarray(rows[1])},
                            jnp.asarray(write_row))
    cache = PagedKVCache(*(torch.tensor(a) for a in (*pools, table, index)))
    paste_blocks(cache, KVCache(torch.tensor(rows[0]), torch.tensor(rows[1])), write_row)
    for name in ("key_pool", "value_pool"):
        np.testing.assert_array_equal(getattr(cache, name)[:, 1:].numpy(), np.asarray(want[name])[:, 1:])
    for name in ("block_table", "index"):
        np.testing.assert_array_equal(getattr(cache, name).numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(cache.key_pool[:, 0].numpy(), pools[0][:, 0])

    short = PagedKVCache(*(torch.tensor(a) for a in (*pools, table, index)))
    paste_blocks(short, KVCache(torch.tensor(rows[0][:, :, :10]), torch.tensor(rows[1][:, :, :10])), write_row)
    np.testing.assert_array_equal(short.key_pool[:, 5].numpy(), np.asarray(want["key_pool"])[:, 5])  # rows 4-7
    np.testing.assert_array_equal(short.key_pool[:, 2, :2].numpy(), rows[0][:, 0, 8:10])  # rows 8, 9, then zeros
    assert not short.key_pool[:, 2, 2:].any()
    np.testing.assert_array_equal(short.key_pool[:, 7].numpy(), pools[0][:, 7])  # entry 4: past the 10 rows


# --------------------------------------------------------------------- #
# SLO shedding (tests/test_scheduling.py:147-187)
# --------------------------------------------------------------------- #

PAGED_ONE = dict(num_slots=1, prompt_buckets=(4,), paged_block_size=4)


def test_serving_scheduler_kwargs_handler():
    from accelerate_tpu.utils import ServingSchedulerKwargs as JaxKwargs

    from accelerate_tpu_torch.utils import ServingSchedulerKwargs

    kw = ServingSchedulerKwargs(token_budget=128, enable_preemption=True)
    cfg = kw.to_scheduler_config()
    assert isinstance(cfg, SchedulerConfig)
    assert cfg.token_budget == 128 and cfg.enable_preemption
    assert kw.to_kwargs() == {"token_budget": 128, "enable_preemption": True}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxKwargs(token_budget=128, enable_preemption=True)
                                                         .to_scheduler_config())


def _shed_fields(err):
    """A ShedError's fields and message, the measured wait masked (each
    engine waited its own time)."""
    def mask(text):
        return re.sub(r"queue wait [0-9.]+s", "queue wait Ws", text.split(" queue_wait_ms")[0])

    return (mask(err.reason), err.uid, err.priority, err.queue_depth, mask(str(err)))


def test_submit_depth_shed_is_structured(llama):
    jeng, eng = _engines(llama, JaxSchedulerConfig(max_queue_depth=1), SchedulerConfig(max_queue_depth=1),
                         **PAGED_ONE)
    errs = []
    for e, cls in ((jeng, JaxShedError), (eng, ShedError)):
        e.submit(np.ones(3, np.int32), max_new_tokens=2, priority=1)
        with pytest.raises(cls) as ei:
            e.submit(np.ones(3, np.int32), max_new_tokens=2, priority=1)
        errs.append(ei.value)
        assert isinstance(e.submit(np.ones(3, np.int32), max_new_tokens=2, priority=0), int)
        assert e.metrics.requests_shed == 1
    assert _shed_fields(errs[1]) == _shed_fields(errs[0])
    assert errs[1].queue_depth == 1 and "max_queue_depth" in errs[1].reason
    _run_both(jeng, eng)


def test_queue_wait_shed_surfaces_via_poll(llama):
    jeng, eng = _engines(llama, JaxSchedulerConfig(max_queue_wait_s=0.0), SchedulerConfig(max_queue_wait_s=0.0),
                         **PAGED_ONE)
    keep = _submit_both(jeng, eng, np.ones(3, np.int32), 3, priority=0)
    stale = _submit_both(jeng, eng, np.ones(4, np.int32), 3, priority=1)
    _run_both(jeng, eng)
    _assert_same(jeng, [keep[0]], eng, [keep[1]])
    errs = []
    for e, cls, uid in ((jeng, JaxShedError, stale[0]), (eng, ShedError, stale[1])):
        with pytest.raises(cls) as ei:
            e.poll(uid)
        errs.append(ei.value)
        with pytest.raises(cls):
            e.partial(uid)
        with pytest.raises(KeyError):
            e.cancel(uid)
        assert e.metrics.requests_shed == 1
    assert _shed_fields(errs[1]) == _shed_fields(errs[0])
    assert errs[1].uid == stale[1] and errs[1].queue_wait_ms >= 0.0


def test_deprioritize_action_demotes_instead_of_rejecting(llama):
    jeng, eng = _engines(llama, JaxSchedulerConfig(max_queue_depth=1, shed_action="deprioritize"),
                         SchedulerConfig(max_queue_depth=1, shed_action="deprioritize"), **PAGED_ONE)
    _submit_both(jeng, eng, np.ones(3, np.int32), 2, priority=1)
    demoted = _submit_both(jeng, eng, np.ones(3, np.int32), 2, priority=1)
    assert eng._locate(demoted[1])[1].priority == jeng._locate(demoted[0])[1].priority == 99
    _run_both(jeng, eng)
    _assert_same(jeng, [demoted[0]], eng, [demoted[1]])
    assert eng.metrics.requests_deprioritized == jeng.metrics.requests_deprioritized == 1


def test_wait_deprioritize_demotes_once(llama):
    """shed_action="deprioritize" with a wait SLO: an over-wait request is
    demoted once and still served, in the JAX engine's order."""
    cfg = dict(max_queue_wait_s=0.0, shed_action="deprioritize", deprioritize_to=5)
    jeng, eng = _engines(llama, JaxSchedulerConfig(**cfg), SchedulerConfig(**cfg), **PAGED_ONE)
    pairs = [_submit_both(jeng, eng, np.full(3, i + 1, np.int32), 2, priority=p) for i, p in enumerate((0, 1, 3))]
    _run_both(jeng, eng)
    _assert_same(jeng, [a for a, _ in pairs], eng, [b for _, b in pairs])
    assert eng.metrics.requests_deprioritized == jeng.metrics.requests_deprioritized == 2
    assert eng.metrics.requests_shed == 0


# --------------------------------------------------------------------- #
# decode preemption + resume by recompute (tests/test_scheduling.py:194-355)
# --------------------------------------------------------------------- #

PREEMPT_ONE = dict(num_slots=1, prompt_buckets=(8,), tick_block=2, paged_block_size=4)


def _preempt_engines(pair, **kw):
    return _engines(pair, JaxSchedulerConfig(enable_preemption=True), SchedulerConfig(enable_preemption=True),
                    **{**PREEMPT_ONE, **kw})


def test_preempt_resume_token_and_logprob_exact(llama):
    """A high-priority arrival evicts the decoding low-priority request;
    the victim resumes by recompute. Both engines step alike, and the
    victim's output equals an unpreempted JAX control's (tokens equal,
    logprobs within 1e-5)."""
    p_victim = (np.arange(6) % 250 + 1).astype(np.int32)
    p_urgent = np.asarray([3, 1, 4, 1, 5], np.int32)
    jeng, eng = _preempt_engines(llama)
    victim = _submit_both(jeng, eng, p_victim, 10, priority=1)
    _step_both(jeng, eng)
    streamed = eng.partial(victim[1]).copy()
    assert streamed.size >= 1
    urgent = _submit_both(jeng, eng, p_urgent, 4, priority=0)
    _step_both(jeng, eng)
    state, req = eng._locate(victim[1])
    assert state == "queued" and req.preempted
    np.testing.assert_array_equal(eng.partial(victim[1]), streamed)
    assert eng.metrics.decode_preemptions == 1
    _run_both(jeng, eng)
    assert eng.metrics.resumes == jeng.metrics.resumes == 1
    _assert_same(jeng, [urgent[0], victim[0]], eng, [urgent[1], victim[1]])
    control = JaxServingEngine(llama[0], **PREEMPT_ONE)
    c = control.submit(p_victim, max_new_tokens=10, priority=1)
    control.run()
    np.testing.assert_array_equal(eng.poll(victim[1]), control.poll(c))
    np.testing.assert_allclose(eng.logprobs(victim[1]), control.logprobs(c), atol=LP_ATOL, rtol=0)
    assert eng.recomputed_tokens == len(p_victim) + len(streamed) - 1


def test_preempt_resume_exact_under_sampling(llama):
    """Temperature sampling across a preemption: the carried generator
    makes the resumed stream the unpreempted control's, token for token."""
    _, model = llama
    p_victim = (np.arange(5) % 250 + 2).astype(np.int32)
    kwargs = dict(PREEMPT_ONE, temperature=1.0, top_k=8, seed=7)
    eng = ServingEngine(model, device="cpu", scheduler=SchedulerConfig(enable_preemption=True), **kwargs)
    victim = eng.submit(p_victim, max_new_tokens=9, priority=1)
    eng.step()
    eng.submit(np.ones(4, np.int32), max_new_tokens=3, priority=0)
    eng.run()
    assert eng.metrics.decode_preemptions == 1
    control = ServingEngine(model, device="cpu", **kwargs)
    c = control.submit(p_victim, max_new_tokens=9, priority=1)
    control.run()
    np.testing.assert_array_equal(eng.poll(victim), control.poll(c))
    np.testing.assert_allclose(eng.logprobs(victim), control.logprobs(c), atol=LP_ATOL, rtol=0)


def test_paged_pool_pressure_preempts_youngest_low_priority(llama):
    """Pool exhaustion with a more important request waiting evicts the
    low-priority decode for its blocks (a slot is free), and both finish
    as in the JAX engine."""
    p1 = (np.arange(4) % 250 + 1).astype(np.int32)
    p2 = np.asarray([8, 7, 6, 5], np.int32)
    jeng, eng = _preempt_engines(llama, num_slots=2, prompt_buckets=(4, 8), max_len=16, pool_blocks=5)
    victim = _submit_both(jeng, eng, p1, 10, priority=1)
    _step_both(jeng, eng)
    assert eng.pool_free_blocks == 0
    urgent = _submit_both(jeng, eng, p2, 4, priority=0)
    _step_both(jeng, eng)
    state, req = eng._locate(victim[1])
    assert state == "queued" and req.preempted
    _run_both(jeng, eng)
    _assert_same(jeng, [urgent[0], victim[0]], eng, [urgent[1], victim[1]])
    assert eng.pool_free_blocks == 4


def test_cancel_preempted_and_requeued_request(llama):
    """Cancelling a preempted request returns its carried tokens and
    forgets the id, as in the JAX engine."""
    jeng, eng = _preempt_engines(llama)
    victim = _submit_both(jeng, eng, np.arange(1, 7, dtype=np.int32), 10, priority=1)
    _step_both(jeng, eng)
    _submit_both(jeng, eng, np.ones(4, np.int32), 3, priority=0)
    _step_both(jeng, eng)
    assert eng._locate(victim[1])[0] == "queued"
    carried = eng.cancel(victim[1])
    np.testing.assert_array_equal(carried, jeng.cancel(victim[0]))
    assert carried.size >= 1
    _run_both(jeng, eng)
    assert eng.poll(victim[1]) is None
    with pytest.raises(KeyError):
        eng.partial(victim[1])
    with pytest.raises(KeyError):
        eng.cancel(victim[1])


def test_stop_sequence_on_resumed_request(llama):
    """A stop sequence completed after the resume fires at its position."""
    prompt = (np.arange(6) % 250 + 1).astype(np.int32)
    _, model = llama
    free = ServingEngine(model, device="cpu", **PREEMPT_ONE).generate_many([prompt], 10)[0]
    gen = free[len(prompt):]
    stop = [int(gen[6]), int(gen[7])]
    first = next(i for i in range(len(gen) - 1) if [int(gen[i]), int(gen[i + 1])] == stop)
    jeng, eng = _preempt_engines(llama)
    victim = _submit_both(jeng, eng, prompt, 10, priority=1, stop_sequences=[stop])
    _step_both(jeng, eng)
    _submit_both(jeng, eng, np.ones(4, np.int32), 3, priority=0)
    _run_both(jeng, eng)
    assert eng.metrics.decode_preemptions == 1
    got = eng.poll(victim[1])
    assert len(got) == len(prompt) + first + 2
    np.testing.assert_array_equal(got, free[: len(got)])
    _assert_same(jeng, [victim[0]], eng, [victim[1]])


def test_preempted_prefix_request_resumes_with_its_prefix(banded8):
    """A prefix-seeded request on a banded model (its 2 prefix blocks in
    the band), preempted and resumed: the resume recomputes prefix +
    suffix + generated tokens and aliases the prefix blocks still in its
    band again; every tick's pool and the outputs match the JAX engine's,
    and the prefix's refcounts return to 1."""
    jeng, eng = _preempt_engines(banded8["mistral"], num_slots=1, prompt_buckets=(4, 8))
    prefix = (np.arange(8) % 250 + 7).astype(np.int32)
    jpid, pid = jeng.register_prefix(prefix), eng.register_prefix(prefix)
    assert jpid == pid and len(eng._prefixes[pid]["block_ids"]) == 2
    victim = _submit_both(jeng, eng, np.asarray([4, 2], np.int32), 12, prefix_id=pid, priority=1)
    _step_both(jeng, eng)
    _step_both(jeng, eng)
    urgent = _submit_both(jeng, eng, np.asarray([9, 9, 9], np.int32), 3, priority=0)
    _run_both(jeng, eng)
    assert eng.metrics.resumes == jeng.metrics.resumes == 1
    _assert_same(jeng, [victim[0], urgent[0]], eng, [victim[1], urgent[1]])
    assert all(v == 1 for v in eng._shared_refs.values())
    eng.unregister_prefix(pid)
    assert eng.pool_free_blocks == eng._pcfg.num_blocks - 1


def test_serving_scheduler_kwargs_drive_the_engine(llama):
    """ServingSchedulerKwargs passed as the engine's scheduler enables
    preemption as the SchedulerConfig does."""
    from accelerate_tpu_torch.utils import ServingSchedulerKwargs

    _, model = llama
    eng = ServingEngine(model, device="cpu", scheduler=ServingSchedulerKwargs(enable_preemption=True), **PREEMPT_ONE)
    eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=10, priority=1)
    eng.step()
    eng.submit(np.ones(4, np.int32), max_new_tokens=3, priority=0)
    eng.run()
    assert eng.scheduler_config.enable_preemption and eng.metrics.decode_preemptions == 1


# --------------------------------------------------------------------- #
# metrics and crash points
# --------------------------------------------------------------------- #

HOOKS = [
    ("on_shed", (None,)), ("on_shed", (3,)), ("on_deprioritize", (None,)), ("on_preempt_decode", (3,)),
    ("on_resume", (3,)), ("on_prefix_hit", (17,)), ("on_prefix_miss", ()), ("on_prefix_register", ()),
    ("on_prefix_evict", ()),
]


def test_scheduler_and_prefix_hooks_count_as_jax_does():
    """Each hook moves the same counters under the same snapshot keys."""
    clock = iter(range(1000)).__next__
    jm_, pm_ = JaxServingMetrics(None, clock=clock), ServingMetrics(None, clock=clock)
    for name, args in HOOKS:
        getattr(jm_, name)(*args)
        getattr(pm_, name)(*args)
    keys = ("requests_shed", "requests_deprioritized", "decode_preemptions", "resumes", "prefix_hits",
            "prefix_misses", "prefix_evictions", "prefix_registrations", "prefix_tokens_reused")
    for key in keys:
        assert getattr(pm_, key) == getattr(jm_, key), key
    assert pm_.resumes == 1 and pm_.prefix_tokens_reused == 17 and pm_.requests_shed == 2


def test_engine_snapshot_keys_cover_jax(llama):
    """The port's snapshot has every key of the JAX engine's, the fleet's
    included, with the same counts."""
    jeng, eng = _engines(llama, **PAGED_ONE)
    _submit_both(jeng, eng, np.ones(3, np.int32), 4)
    _run_both(jeng, eng)
    jsnap, snap = jeng.metrics.snapshot(), eng.metrics.snapshot()
    fleet = ("failovers_in", "failovers_out", "failovers_lost", "replica_errors", "replica_timeouts",
             "replica_state")
    assert set(jsnap) <= set(snap)
    for key in ("requests_completed", "tokens_generated", "prefills", "decode_preemptions", "resumes",
                "requests_shed", "kv_block_utilization") + fleet:
        assert snap[key] == jsnap[key], key


@pytest.mark.parametrize("label", ["pre_tick", "mid_prefill", "mid_decode"])
def test_serving_crash_points_leave_the_engine_resumable(llama, label):
    """A crash at each serving point leaves the host state consistent:
    ticking on gives the clean run's tokens and drains the pool."""
    _, model = llama
    kw = dict(num_slots=2, prompt_buckets=(4, 8), paged_block_size=4, tick_block=2)
    prompts = [(np.arange(n) % 250 + 1).astype(np.int32) for n in (5, 3, 11)]
    clean = ServingEngine(model, device="cpu", **kw).generate_many(prompts, 6)
    eng = ServingEngine(model, device="cpu", **kw)
    uids = [eng.submit(p, 6) for p in prompts]
    with CrashPoint(label) as cp, pytest.raises(SimulatedCrash):
        eng.step()
    assert cp.fired
    eng.run()
    for uid, want in zip(uids, clean):
        np.testing.assert_array_equal(eng.poll(uid), want)
    assert eng.pool_free_blocks == eng._pcfg.num_blocks - 1
