"""The port's in-process serving fleet (serving_fleet.py: routing, radix
prefix reuse, disaggregated KV handoff, failover, the chaos matrix) held
against the JAX package's fleet on the same weights, carried across by
``models/convert.py``, and on the port's own no-fault runs.

Greedy tokens equal the JAX fleet's and logprobs lie within 1e-5 (f32 on
the CPU); handoff and failover bytes equal their prediction exactly and
the JAX package's for the same config and fault. Sampled streams compare
against the port's own control only: jax.random and torch.Generator draw
different numbers."""

import ast
import dataclasses
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.analysis.costmodel as jcost
import accelerate_tpu.models as jm
import accelerate_tpu.scheduling as jsched
import accelerate_tpu.serving_fleet as jfleet
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.test_utils.fault_injection import ReplicaChaos as JaxReplicaChaos
import accelerate_tpu_torch.analysis.costmodel as pcost
import accelerate_tpu_torch.scheduling as psched
import accelerate_tpu_torch.serving_fleet as pfleet
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.kernels import build, fixtures, launch, reference
from accelerate_tpu_torch.ops import flash_attention, fp8, paged_attention, qmatmul
from accelerate_tpu_torch.scheduling import SchedulerConfig, ShedError
from accelerate_tpu_torch.test_utils.fault_injection import SERVING_CRASH_POINTS, ReplicaChaos, SimulatedCrash

torch.set_num_threads(2)

LP_ATOL = 1e-5
ENGINE = dict(num_slots=2, prompt_buckets=(4, 8))
NEW = 4
PROMPTS = [(np.arange(1, 6 + i) % 250).astype(np.int32) for i in range(6)]


@pytest.fixture(scope="module")
def pair():
    """The JAX package's tiny Llama and the port's on the same weights (f32)."""
    jcfg = jm.LlamaConfig.tiny()
    jmodel = jm.create_llama_model(jcfg, seed=2, seq_len=16)
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
    return jmodel, model


@pytest.fixture(autouse=True)
def bound_live_executables_per_test():
    yield
    jax.clear_caches()


def _port_fleet(model, n=2, engine=None, trace=None, **cfg_kw):
    return pfleet.FleetRouter.from_model(model, num_replicas=n, config=pfleet.FleetConfig(**cfg_kw), trace=trace,
                                         device="cpu", **(engine or ENGINE))


def _jax_fleet(jmodel, n=2, engine=None, trace=None, **cfg_kw):
    return jfleet.FleetRouter.from_model(jmodel, num_replicas=n, config=jfleet.FleetConfig(**cfg_kw), trace=trace,
                                         **(engine or ENGINE))


def _results(fr, fuids):
    out = fr.run()
    assert sorted(out) == sorted(fuids)
    return [(np.asarray(out[f]), np.asarray(fr.logprobs(f))) for f in fuids]


def _assert_close(got, want, exact=False):
    for (toks, lps), (wtoks, wlps) in zip(got, want):
        np.testing.assert_array_equal(toks, wtoks)
        if exact:
            np.testing.assert_array_equal(lps, wlps)
        else:
            np.testing.assert_allclose(lps, wlps, atol=LP_ATOL, rtol=0)


# --------------------------------------------------------------------- #
# routing and pricing
# --------------------------------------------------------------------- #

ROUTING_CASES = {
    "least_loaded": lambda m: [m.FleetRoutingPolicy(m.RoutingConfig()).pick_replica(loads, elig)
                               for loads, elig in (([3, 1, 2], [0, 1, 2]), ([1, 1, 2], [0, 1, 2]), ([0, 9, 0], [1, 2]))],
    "round_robin": lambda m: (lambda p: [p.pick_replica([0, 0, 0], [0, 1, 2]) for _ in range(6)]
                              + [p.pick_replica([5, 0, 0], [2, 0]) for _ in range(3)])(
        m.FleetRoutingPolicy(m.RoutingConfig(policy="round_robin"))),
    "fleet_shed": lambda m: (lambda p: [p.shed_on_submit(0, 100), p.shed_on_submit(1, 3), p.shed_on_submit(1, 4),
                                        p.shed_on_submit(2, 9)])(
        m.FleetRoutingPolicy(m.RoutingConfig(max_fleet_queue_depth=4))),
    "shed_floor": lambda m: (lambda p: [p.shed_on_submit(1, 50), p.shed_on_submit(2, 50)])(
        m.FleetRoutingPolicy(m.RoutingConfig(max_fleet_queue_depth=2, shed_priority_floor=2))),
    "capacity": lambda m: [m.FleetRoutingPolicy().shed_on_capacity(n) for n in (0, 1, 3)],
    "bad_policy": lambda m: m.RoutingConfig(policy="random"),
    "bad_depth": lambda m: m.RoutingConfig(max_fleet_queue_depth=0),
    "no_eligible": lambda m: m.FleetRoutingPolicy().pick_replica([1], []),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_routing_matches_jax(case):
    """RoutingConfig's validation and FleetRoutingPolicy's decisions equal
    the JAX package's for the same loads and depths."""
    got, want = _outcome(lambda: ROUTING_CASES[case](psched)), _outcome(lambda: ROUTING_CASES[case](jsched))
    assert got[0] == want[0]
    assert got == want if got[0] == "ValueError" else repr(got[1]) == repr(want[1])


def test_fleet_config_validation(pair):
    for kw, match in ((dict(roles=("mixed", "oracle")), "roles"), (dict(handoff="sometimes"), "handoff"),
                      (dict(failover="pray"), "failover"), (dict(tick_timeout_s=0), "tick_timeout_s"),
                      (dict(quarantine_after_timeouts=0), "quarantine_after_timeouts"),
                      (dict(heal_after_ticks=0), "heal_after_ticks")):
        with pytest.raises(ValueError, match=match):
            pfleet.FleetConfig(**kw)
    with pytest.raises(ValueError, match="at least one decode-capable"):
        pfleet.FleetRouter([ServingEngine(pair[1], device="cpu", **ENGINE)], pfleet.FleetConfig(roles=("prefill",)))


PRICE_CASES = [
    # (bytes a token, prompt, generated, params, fixed bytes, KV exportable)
    (512, 10, 3, 1, 8, True),  # a one-parameter model: recompute is free, in both packages
    (512, 10, 3, 10**15, 8, True),  # a huge model: shipping the rows wins, in both
    (4096, 512, 100, 10**15, 0, False),  # not exportable: recompute
    (22528, 1024, 0, 1_100_048_384, 88, True),
    (22528, 16, 1, 1_100_048_384, 88, True),
]


@pytest.mark.parametrize("case", PRICE_CASES)
def test_pricing_matches_jax(case):
    """``price_kv_handoff`` / ``price_failover``: rows, bytes and path equal
    the JAX package's (the path where the two tables agree on the
    cheaper leg); the time is the bytes over the H100's host round trip,
    and ``prefill_compute_us`` the bound over the H100's peak."""
    bpt, prompt, generated, params, fixed, exportable = case
    got = pcost.price_failover(bpt, prompt, generated, params, fixed_bytes=fixed, kv_exportable=exportable)
    want = jcost.price_failover(bpt, prompt, generated, params, fixed_bytes=fixed, kv_exportable=exportable,
                                generation="v5e")
    assert got["rows"] == want["rows"] and got["handoff"]["bytes"] == want["handoff"]["bytes"]
    assert got["handoff"]["bytes"] == bpt * got["rows"] + fixed
    if params in (1, 10**15) or not exportable:
        assert got["path"] == want["path"]
    rate = pcost.HANDOFF_BW_TABLE["h100"]
    assert got["handoff"]["time_us"] == pytest.approx(got["handoff"]["bytes"] / rate * 1e6, rel=1e-12)
    assert got["recompute_us"] == pytest.approx(2.0 * params * got["rows"] / pcost.PEAK_FLOPS_TABLE["h100"]["bf16"] * 1e6,
                                                rel=1e-12)
    kv = pcost.price_kv_handoff(bpt, prompt, fixed_bytes=fixed)
    assert kv["bytes"] == jcost.price_kv_handoff(bpt, prompt, fixed_bytes=fixed)["bytes"]
    assert kv["time_us"] == pytest.approx(kv["bytes"] / rate * 1e6, rel=1e-12)


# --------------------------------------------------------------------- #
# radix prefix cache
# --------------------------------------------------------------------- #


def _radix_promote(mod, eng, pm):
    rad = mod.RadixPrefixCache(eng, min_prefix_tokens=4, promote_after=2)
    pre = (np.arange(1, 7) % 250).astype(np.int32)
    p1, p2 = np.concatenate([pre, [41, 42]]).astype(np.int32), np.concatenate([pre, [51, 52, 53]]).astype(np.int32)
    out = [rad.lookup(p1), rad.observe(p1), rad.lookup(p2)]
    pid = rad.observe(p2)
    out += [pid, rad.lookup(p2)]
    uid = eng.submit(p2[6:], max_new_tokens=4, prefix_id=pid)
    eng.run()
    return out, rad.stats(), (np.asarray(eng.poll(uid)), np.asarray(eng.logprobs(uid)))


def _radix_min_tokens(mod, eng, pm):
    rad = mod.RadixPrefixCache(eng, min_prefix_tokens=8, promote_after=2)
    short = np.arange(1, 6, dtype=np.int32)
    out = [rad.observe(np.concatenate([short, [9]])), rad.observe(np.concatenate([short, [10]]))]
    rad2 = mod.RadixPrefixCache(eng, min_prefix_tokens=4, promote_after=2)
    pre = np.arange(20, 29, dtype=np.int32)
    rad2.observe(np.concatenate([pre, [1]]))
    out += [rad2.observe(np.concatenate([pre, [2]])), rad2.lookup(pre), rad2.lookup(np.concatenate([pre, [3]]))]
    return out, (rad.stats(), rad2.stats()), None


def _radix_lru(mod, eng, pm):
    rad = mod.RadixPrefixCache(eng, min_prefix_tokens=4, promote_after=2, max_entries=1)
    pre_a, pre_b = np.arange(1, 6, dtype=np.int32), np.arange(30, 36, dtype=np.int32)
    rad.observe(np.concatenate([pre_a, [7]]))
    pid_a = rad.observe(np.concatenate([pre_a, [8]]))
    rad.observe(np.concatenate([pre_b, [7]]))
    pid_b = rad.observe(np.concatenate([pre_b, [8]]))
    return ([pid_a, pid_b, sorted(eng._prefixes), rad.lookup(np.concatenate([pre_a, [9]]))], rad.stats(),
            eng.pool_free_blocks)


def _radix_referenced(mod, eng, pm):
    rad = mod.RadixPrefixCache(eng, min_prefix_tokens=4, promote_after=2, max_entries=1)
    pre_a = np.arange(1, 6, dtype=np.int32)
    rad.observe(np.concatenate([pre_a, [7]]))
    pid_a = rad.observe(np.concatenate([pre_a, [8]]))
    m = rad.lookup(np.concatenate([pre_a, [9]]))
    eng.submit(np.asarray([9], np.int32), max_new_tokens=2, prefix_id=m[0])
    pre_b = np.arange(30, 36, dtype=np.int32)
    rad.observe(np.concatenate([pre_b, [7]]))
    rad.observe(np.concatenate([pre_b, [8]]))
    out = [pid_a in eng._prefixes, len(rad.entries)]
    eng.run()
    pre_c = np.arange(60, 66, dtype=np.int32)
    rad.observe(np.concatenate([pre_c, [7]]))
    rad.observe(np.concatenate([pre_c, [8]]))
    return out + [len(rad.entries), sorted(eng._prefixes)], rad.stats(), None


def _radix_invalidate(mod, eng, pm):
    rad = mod.RadixPrefixCache(eng, min_prefix_tokens=4, promote_after=2)
    pre = np.arange(1, 7, dtype=np.int32)
    rad.observe(np.concatenate([pre, [1]]))
    pid = rad.observe(np.concatenate([pre, [2]]))
    out = [rad.invalidate(pid), rad.lookup(np.concatenate([pre, [3]])), pid in eng._prefixes]
    try:
        rad.invalidate(pid)
    except ValueError as exc:
        out.append(str(exc))
    return out, rad.stats(), None


RADIX_CASES = {"promote": _radix_promote, "min_tokens": _radix_min_tokens, "lru_eviction": _radix_lru,
               "referenced_entry": _radix_referenced, "invalidate": _radix_invalidate}


@pytest.mark.parametrize("layout", [None, 4])
@pytest.mark.parametrize("case", sorted(RADIX_CASES))
def test_radix_matches_jax(pair, case, layout):
    """The JAX package's radix cases through both packages: the same
    lookups and registrations, equal ``stats()``, and a prefix-reused
    request's tokens equal (logprobs within 1e-5)."""
    jmodel, model = pair
    kw = dict(ENGINE, paged_block_size=layout)
    got = RADIX_CASES[case](pfleet, ServingEngine(model, device="cpu", **kw), "port")
    want = RADIX_CASES[case](jfleet, JaxServingEngine(jmodel, **kw), "jax")
    assert repr(got[0]) == repr(want[0])
    assert got[1] == want[1]
    if case == "promote":
        _assert_close([got[2]], [want[2]])
    elif case == "lru_eviction":
        assert got[2] == want[2]


# --------------------------------------------------------------------- #
# KV handoff on the engine
# --------------------------------------------------------------------- #


def test_handoff_exact_dense_and_paged(pair):
    """A detached prefill handed to a dense and to a paged engine: tokens
    equal the JAX package's handoff and logprobs within 1e-5; the bytes a
    token equal the JAX engine's ``kv_handoff_dims``, and the moved bytes
    the prediction."""
    jmodel, model = pair
    prompt = (np.arange(1, 10) % 250).astype(np.int32)
    jsrc, src = JaxServingEngine(jmodel, **ENGINE), ServingEngine(model, device="cpu", **ENGINE)
    assert src.kv_handoff_dims() == jsrc.kv_handoff_dims()
    jh, h = jsrc.prefill_detached(prompt, 5, uid_key=3), src.prefill_detached(prompt, 5, uid_key=3)
    per_tok, fixed = src.kv_handoff_dims()
    assert h["wire_bytes"] == jh["wire_bytes"] == pcost.price_kv_handoff(per_tok, 9, fixed_bytes=fixed)["bytes"]
    assert h["next_tok"] == jh["next_tok"] and abs(h["lp"] - jh["lp"]) <= LP_ATOL
    for layout in (None, 4):
        jdst = JaxServingEngine(jmodel, paged_block_size=layout, **ENGINE)
        dst = ServingEngine(model, device="cpu", paged_block_size=layout, **ENGINE)
        ju, u = jdst.submit_prefilled(dict(jh)), dst.submit_prefilled(dict(h))
        jdst.run()
        dst.run()
        _assert_close([(dst.poll(u), dst.logprobs(u))], [(jdst.poll(ju), jdst.logprobs(ju))])
        local = ServingEngine(model, device="cpu", paged_block_size=layout, **ENGINE)
        lu = local.submit(prompt, 5)
        local.run()
        _assert_close([(dst.poll(u), dst.logprobs(u))], [(local.poll(lu), local.logprobs(lu))], exact=True)
    for n in (3, 8, 11):
        hn = src.prefill_detached((np.arange(1, n + 1) % 250).astype(np.int32), 2, uid_key=n)
        assert hn["wire_bytes"] == per_tok * n + fixed


def test_handoff_validation(pair):
    _, model = pair
    eng = ServingEngine(model, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill_detached(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="exceeds the slot cache"):
        eng.prefill_detached(np.ones((8,), np.int32), max_new_tokens=150)
    h = eng.prefill_detached(np.ones((4,), np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="handoff total"):
        eng.submit_prefilled({**h, "total": 3})
    with pytest.raises(ValueError, match="exceeds the slot cache"):
        eng.submit_prefilled({**h, "max_new_tokens": 150})
    bf16 = ServingEngine(create_llama_model(LlamaConfig.tiny(), device="cpu", dtype=torch.bfloat16), device="cpu",
                         **ENGINE)
    bf16.submit_prefilled(dict(h))
    with pytest.raises(ValueError, match="rows are torch.float32"):
        bf16.step()


@pytest.mark.parametrize("sampled", [False, True])
def test_handoff_codec_roundtrip_exact(pair, sampled):
    """The wire codec: one bytes blob and back, leaves bit-equal, the
    decoded handoff served token- and logprob-exactly as a local submit
    (greedy, and sampled with the generator's state in the blob); the
    trace id rides the blob and a blob without one decodes with None."""
    _, model = pair
    kw = dict(ENGINE, temperature=0.9, seed=5) if sampled else ENGINE
    prompt = (np.arange(1, 10) % 250).astype(np.int32)
    local = ServingEngine(model, device="cpu", **kw)
    lu = local.submit(prompt, 5)
    local.run()
    h = ServingEngine(model, device="cpu", **kw).prefill_detached(prompt, 5, uid_key=lu, trace=42)
    dst = ServingEngine(model, device="cpu", **kw)
    blob = pfleet.HandoffCodec.encode(h)
    assert isinstance(blob, bytes) and len(blob) >= h["wire_bytes"]
    h2 = pfleet.HandoffCodec.decode(blob, dst)
    assert h2["trace"] == 42 and h2["wire_bytes"] == h["wire_bytes"]
    assert all(torch.equal(h2["cache"][k], h["cache"][k]) for k in h["cache"])
    np.testing.assert_array_equal(h2["gen_state"], h["gen_state"])
    assert (len(h["gen_state"]) > 0) == sampled
    uid = dst.submit_prefilled(h2)
    dst.run()
    _assert_close([(dst.poll(uid), dst.logprobs(uid))], [(local.poll(lu), local.logprobs(lu))], exact=True)
    v1 = pfleet.HandoffCodec.decode(pfleet.HandoffCodec.encode({**h, "trace": None}))
    assert v1["trace"] is None


def test_handoff_codec_bf16_rows():
    """bf16 rows (numpy has no bfloat16) cross the codec as raw bytes with
    their dtype name, bit-equal."""
    model = create_llama_model(LlamaConfig.tiny(), device="cpu", dtype=torch.bfloat16)
    eng = ServingEngine(model, device="cpu", **ENGINE)
    h = eng.prefill_detached((np.arange(1, 8) % 250).astype(np.int32), 3)
    assert h["cache"]["key"].dtype == torch.bfloat16
    h2 = pfleet.HandoffCodec.decode(pfleet.HandoffCodec.encode(h), eng)
    assert all(torch.equal(h2["cache"][k], h["cache"][k]) for k in ("key", "value", "index"))
    assert h["wire_bytes"] == eng.kv_handoff_dims()[0] * 7 + eng.kv_handoff_dims()[1]


def test_handoff_request_survives_preemption(pair):
    """A handed-off request evicted mid-decode resumes by recompute (the
    payload is consumed at its first admission) and ends as the JAX
    package's does (tokens equal, logprobs within 1e-5)."""
    jmodel, model = pair
    prompt = (np.arange(1, 9) % 250).astype(np.int32)
    outs = []
    for mod, src, dst in (
        ("port", ServingEngine(model, device="cpu", **ENGINE),
         ServingEngine(model, device="cpu", num_slots=1, prompt_buckets=(4, 8), tick_block=2,
                       scheduler=SchedulerConfig(enable_preemption=True))),
        ("jax", JaxServingEngine(jmodel, **ENGINE),
         JaxServingEngine(jmodel, num_slots=1, prompt_buckets=(4, 8), tick_block=2,
                          scheduler=jsched.SchedulerConfig(enable_preemption=True))),
    ):
        uid = dst.submit_prefilled(src.prefill_detached(prompt, 8, uid_key=0), priority=1)
        dst.step()
        assert dst.partial(uid).size > 0
        hi = dst.submit(np.asarray([5, 6], np.int32), max_new_tokens=2, priority=0)
        dst.run()
        assert dst.metrics.decode_preemptions >= 1 and dst.poll(hi) is not None
        outs.append((dst.poll(uid), dst.logprobs(uid)))
    _assert_close(outs[:1], outs[1:])


# --------------------------------------------------------------------- #
# the router
# --------------------------------------------------------------------- #

FLEETS = {
    "mixed_reuse": dict(min_prefix_tokens=4, promote_after=2),
    "disaggregated": dict(roles=("prefill", "decode"), handoff="always", prefix_reuse=False),
    "disaggregated_reuse": dict(roles=("prefill", "decode", "decode"), handoff="always", min_prefix_tokens=4),
}


@pytest.mark.parametrize("kind", sorted(FLEETS))
def test_fleet_matches_jax(pair, kind):
    """A 2-replica fleet with radix reuse and disaggregated fleets (handoff
    always): tokens equal the JAX fleet's, logprobs within 1e-5, and the
    handoff accounting and radix stats equal."""
    jmodel, model = pair
    cfg = FLEETS[kind]
    n = len(cfg.get("roles", ("mixed", "mixed")))
    pre = (np.arange(1, 7) % 250).astype(np.int32)
    prompts = [np.concatenate([pre, [40 + i]]).astype(np.int32) for i in range(4)] + PROMPTS[:3]
    fr, jfr = _port_fleet(model, n, **cfg), _jax_fleet(jmodel, n, **cfg)
    got = _results(fr, [fr.submit(p, NEW) for p in prompts])
    want = _results(jfr, [jfr.submit(p, NEW) for p in prompts])
    _assert_close(got, want)
    keys = ("handoffs", "handoffs_local", "bytes_predicted", "bytes_moved")  # times: each package's own table
    assert {k: fr.handoff_accounting()[k] for k in keys} == {k: jfr.handoff_accounting()[k] for k in keys}
    assert fr.radix_stats() == jfr.radix_stats()
    acc = fr.handoff_accounting()
    assert acc["bytes_moved"] == acc["bytes_predicted"]
    if "roles" in cfg:
        assert acc["handoffs"] == len(prompts)
    merged = fr.metrics_merged()
    assert merged.requests_completed == len(prompts)
    assert merged.prefix_hits == sum(s["hits"] for s in fr.radix_stats().values())


def test_fleet_auto_and_never_decide_once(pair):
    jmodel, model = pair
    for mode in ("auto", "never"):
        fr = _port_fleet(model, roles=("prefill", "decode"), handoff=mode, prefix_reuse=False)
        u = fr.submit(PROMPTS[2], 3)
        out = fr.run()
        acc = fr.handoff_accounting()
        assert u in out and acc["handoffs"] + acc["handoffs_local"] == 1
        if mode == "never":
            assert acc == {"handoffs": 0, "handoffs_local": 1, "bytes_predicted": 0, "bytes_moved": 0,
                           "time_us_predicted": 0.0}


def test_drain_threaded_matches_step(pair):
    """One thread a replica drains to the same tokens and logprobs as the
    deterministic ``step()`` loop."""
    _, model = pair
    prompts = [(np.arange(1, 5 + i) % 250).astype(np.int32) for i in range(8)]
    outs = {}
    for mode in ("step", "threads"):
        fr = _port_fleet(model, prefix_reuse=False)
        fuids = [fr.submit(p, 3) for p in prompts]
        if mode == "threads":
            assert fr.drain_threaded() > 0
        outs[mode] = _results(fr, fuids)
    _assert_close(outs["threads"], outs["step"], exact=True)


def test_fleet_partial_cancel_and_request_errors(pair):
    _, model = pair
    fr = _port_fleet(model, engine=dict(num_slots=1, prompt_buckets=(4, 8), tick_block=2), prefix_reuse=False)
    u1, u2 = fr.submit(PROMPTS[3], 6), fr.submit(PROMPTS[3], 6)
    assert fr.partial(u1).size == 0 and fr.poll(u1) is None
    fr.step()
    assert isinstance(fr.cancel(u2), np.ndarray)
    with pytest.raises(KeyError):
        fr.partial(u2)
    fr.run()
    assert fr.poll(u1) is not None and fr.logprobs(u1).shape[0] == len(fr.partial(u1))
    with pytest.raises(pfleet.FleetRequestError, match="unknown request id"):
        fr.poll(10_000)
    fr2 = _port_fleet(model, routing=psched.RoutingConfig(max_fleet_queue_depth=1), prefix_reuse=False,
                      engine=dict(num_slots=1, prompt_buckets=(4, 8)))
    fr2.submit(np.ones((4,), np.int32), 2)
    fr2.submit(np.ones((4,), np.int32), 2)
    with pytest.raises(ShedError, match="fleet queue depth"):
        while True:
            fr2.submit(np.ones((4,), np.int32), 2, priority=1)
    assert fr2.fleet_shed == 1


def test_spin_up_builds_nothing_and_replicas_share_the_store(pair, tmp_path):
    """A spun-up replica builds no kernel library on the CPU; without a
    store its memory-only program cache compiles its programs, and over
    ``from_model(store_dir=...)`` every replica's cache shares one store,
    so a replica spun up after the first served the same shapes compiles
    nothing and installs every program (the JAX package's contract)."""
    _, model = pair
    fr = _port_fleet(model, 1, prefix_reuse=False)
    info = fr.spin_up(warm_prompt_lens=(4, 9))
    assert info["replica"] == "r1" and info["nvcc_builds"] == 0 and info["spinup_ms"] > 0
    # the 4-bucket prefill, the 9-token prompt's windows of 8 and 4, the decode tick
    assert info["compiles"] == 4 and info["deserialized"] == 0
    u = fr.submit(PROMPTS[0], 3)
    assert u in fr.run()
    shared = pfleet.FleetRouter.from_model(model, num_replicas=1, config=pfleet.FleetConfig(prefix_reuse=False),
                                           store_dir=str(tmp_path), device="cpu", **ENGINE)
    first = shared.replicas[0].engine
    assert first.program_cache.store.path == str(tmp_path)
    first.generate_many([np.arange(1, 5, dtype=np.int32), np.arange(1, 10, dtype=np.int32)], max_new_tokens=2)
    assert first.program_cache.misses == 4 and len(first.program_cache.store.keys()) == 4
    info = shared.spin_up(warm_prompt_lens=(4, 9))
    assert (info["compiles"], info["deserialized"], info["nvcc_builds"]) == (0, 4, 0)
    assert shared.replicas[1].engine.program_cache is not first.program_cache
    # the process fleet is ported: process chaos builds and serializes as the JAX package's does
    for action in ("sigkill", "sigstop"):
        chaos = ReplicaChaos("pre_tick", action=action, hits=3)
        assert chaos.to_env_spec("w1") == JaxReplicaChaos("pre_tick", action=action, hits=3).to_env_spec("w1")


# --------------------------------------------------------------------- #
# failover: the chaos matrix
# --------------------------------------------------------------------- #


# two tokens a tick: one tick leaves requests decoding, their rows exportable
CHAOS_ENGINE = dict(ENGINE, tick_block=2)


def _chaos_run(mod, chaos_cls, model, label, failover, chaos_kw=None, engine=None, **cfg_kw):
    """The chaos workload on a 2-replica fleet (a prefill and a decode
    replica for ``pre_handoff``): one tick, then the fault on r0, then to
    the end. ``label`` None: the no-fault control."""
    disagg = label == "pre_handoff"
    if disagg:
        cfg_kw.update(roles=("prefill", "decode"), handoff="always")
    cfg = mod.FleetConfig(failover=failover, prefix_reuse=False, **cfg_kw)
    kw = dict(device="cpu") if mod is pfleet else {}
    fr = mod.FleetRouter.from_model(model, num_replicas=2, config=cfg, **(engine or CHAOS_ENGINE), **kw)
    fuids = [fr.submit(p, NEW) for p in PROMPTS]
    if not disagg:
        fr.step()
    if label is None:
        return fr, _results(fr, fuids)
    with chaos_cls(label, replica="r0", **(chaos_kw or {"action": "crash"})) as chaos:
        out = _results(fr, fuids)
    assert chaos.fired
    return fr, out


@pytest.fixture(scope="module")
def chaos_control(pair):
    _, model = pair
    return {failover: _chaos_run(pfleet, ReplicaChaos, model, None, failover)[1] for failover in ("recompute", "handoff")}


@pytest.mark.parametrize("path", ["recompute", "handoff"])
@pytest.mark.parametrize("label", SERVING_CRASH_POINTS)
def test_chaos_matrix(pair, chaos_control, label, path):
    """A crash on r0 at each serving crash point, failover pinned to
    recompute or to KV: zero requests lost, every output within 1e-5 of
    the port's no-fault control (bit-equal over KV), and the failover
    accounting (counts and bytes, predicted == moved) equal to the JAX
    fleet's at the same fault."""
    jmodel, model = pair
    fr, out = _chaos_run(pfleet, ReplicaChaos, model, label, path)
    jfr, _ = _chaos_run(jfleet, JaxReplicaChaos, jmodel, label, path)
    assert fr.health()["r0"]["health"] == "dead"
    acc = fr.failover_accounting()
    assert acc["failovers_lost"] == 0 and acc["bytes_moved"] == acc["bytes_predicted"]
    if path == "recompute":
        assert acc["failovers_kv"] == 0
    elif label in ("pre_tick", "mid_decode"):
        assert acc["failovers_kv"] >= 1 and acc["bytes_moved"] > 0
    keys = ("failovers", "failovers_kv", "failovers_recompute", "failovers_lost", "bytes_predicted", "bytes_moved")
    assert {k: acc[k] for k in keys} == {k: jfr.failover_accounting()[k] for k in keys}
    if label == "pre_handoff":
        _assert_close(out, [(np.asarray(jfr.poll(f)), np.asarray(jfr.logprobs(f))) for f in range(len(PROMPTS))])
    _assert_close(out, chaos_control[path], exact=path == "handoff" and label != "pre_handoff")


def test_chaos_poison_quarantines_and_never_ships_kv(pair, chaos_control):
    _, model = pair
    fr, out = _chaos_run(pfleet, ReplicaChaos, model, "mid_decode", "auto", {"action": "poison"})
    h = fr.health()["r0"]
    assert h["health"] == "quarantined" and "NonFinitePoison" in h["last_error"]
    acc = fr.failover_accounting()
    assert acc["failovers"] >= 1 and acc["failovers_kv"] == 0 and acc["bytes_moved"] == 0
    assert acc["failovers_lost"] == 0
    _assert_close(out, chaos_control["recompute"])


def test_chaos_sampled_failover_by_kv_exact(pair):
    """temperature 0.9: each request's generator state rides its snapshot,
    so a stream that fails over by KV equals the no-fault run, token for
    token and logprob for logprob."""
    _, model = pair
    engine = dict(CHAOS_ENGINE, temperature=0.9, seed=7)
    _, want = _chaos_run(pfleet, ReplicaChaos, model, None, "handoff", engine=engine)
    fr, got = _chaos_run(pfleet, ReplicaChaos, model, "mid_decode", "handoff", engine=engine)
    assert fr.failover_accounting()["failovers_kv"] >= 1
    _assert_close(got, want, exact=True)


def test_hang_degrades_then_quarantines_and_heals(pair):
    """One slow tick degrades, a second quarantines (the work migrates with
    its rows: the tick finished, late); a degraded replica heals after
    clean ticks."""
    _, model = pair
    fr = _port_fleet(model, engine=dict(ENGINE, tick_block=2), prefix_reuse=False, quarantine_after_timeouts=2)
    fuids = [fr.submit(p, 8) for p in PROMPTS[:4]]
    fr.step()
    fr.config.tick_timeout_s = 0.05
    with ReplicaChaos("pre_tick", replica="r0", action="hang", hang_s=0.2, repeat=True):
        fr.step()
        assert fr.health()["r0"]["health"] == "degraded"
        out = _results(fr, fuids)
    assert fr.health()["r0"]["health"] == "quarantined" and fr.failover_accounting()["failovers_lost"] == 0
    clean = _port_fleet(model, engine=dict(ENGINE, tick_block=2), prefix_reuse=False)
    _assert_close(out, _results(clean, [clean.submit(p, 8) for p in PROMPTS[:4]]))
    fr2 = _port_fleet(model, engine=dict(ENGINE, tick_block=2), prefix_reuse=False, heal_after_ticks=2)
    fr2.submit(PROMPTS[0], 10)
    fr2.step()
    fr2.config.tick_timeout_s = 0.05
    with ReplicaChaos("pre_tick", replica="r0", action="hang", hang_s=0.2):
        fr2.step()
    assert fr2.health()["r0"]["health"] == "degraded"
    fr2.step()
    fr2.step()
    assert fr2.health()["r0"]["health"] == "healthy"


def test_capacity_lost_sheds_until_add_replica(pair):
    _, model = pair
    fr = _port_fleet(model, 1, prefix_reuse=False)
    doomed = fr.submit(PROMPTS[0], 2)
    fr.fail_replica("r0")
    assert fr.health()["r0"]["health"] == "dead" and fr.failover_accounting()["failovers_lost"] == 1
    with pytest.raises(KeyError, match="lost"):
        fr.poll(doomed)
    with pytest.raises(ShedError, match="capacity lost"):
        fr.submit(PROMPTS[1], 2)
    assert fr.add_replica(warm_prompt_lens=(4,))["nvcc_builds"] == 0
    u = fr.submit(PROMPTS[1], 3)
    ref = ServingEngine(model, device="cpu", **ENGINE).generate_many([PROMPTS[1]], 3)[0]
    np.testing.assert_array_equal(fr.run()[u], ref)


def test_drain_moves_work_and_never_reuses_names(pair, chaos_control):
    _, model = pair
    fr = _port_fleet(model, engine=CHAOS_ENGINE, prefix_reuse=False)
    fuids = [fr.submit(p, NEW) for p in PROMPTS]
    fr.step()
    res = fr.drain("r0")
    assert res["replica"] == "r0" and res["lost"] == 0 and [r.name for r in fr.replicas] == ["r1"]
    _assert_close(_results(fr, fuids), chaos_control["handoff"])
    assert fr.add_replica(warm_prompt_lens=(4,))["replica"] == "r2"
    fr.drain("r1")
    with pytest.raises(ValueError, match="no other serving replica"):
        fr.drain("r2")


def test_drain_threaded_survives_a_worker_crash(pair, chaos_control):
    _, model = pair
    fr = _port_fleet(model, engine=CHAOS_ENGINE, prefix_reuse=False)
    fuids = [fr.submit(p, NEW) for p in PROMPTS]
    with ReplicaChaos("pre_tick", replica="r0", action="crash") as chaos:
        fr.drain_threaded()
    assert chaos.fired and fr.health()["r0"]["health"] == "dead"
    for f, (want, _) in zip(fuids, chaos_control["recompute"]):
        np.testing.assert_array_equal(fr.poll(f), want)
    solo = _port_fleet(model, 1, prefix_reuse=False)
    solo.submit(PROMPTS[0], 2)
    with ReplicaChaos("pre_tick", replica="r0", action="crash"), pytest.raises(SimulatedCrash):
        solo.drain_threaded()


def test_failover_handoff_leg_retries_transient_io(pair, chaos_control, monkeypatch):
    """The KV import leg rides utils.retry: one transient OSError on the
    destination neither loses the request nor turns it into a recompute."""
    _, model = pair
    fr = _port_fleet(model, engine=CHAOS_ENGINE, prefix_reuse=False, failover="handoff",
                     failover_retry_base_delay_s=0.001)
    fuids = [fr.submit(p, NEW) for p in PROMPTS]
    fr.step()
    dst = fr.replicas[1].engine
    real, calls = dst.import_inflight, {"n": 0}

    def flaky(snap):
        calls["n"] += 1
        if calls["n"] == 1 and snap.get("cache") is not None:
            raise OSError("transient")
        return real(snap)

    monkeypatch.setattr(dst, "import_inflight", flaky)
    with ReplicaChaos("pre_tick", replica="r0", action="crash"):
        out = _results(fr, fuids)
    assert fr.failover_accounting()["failovers_kv"] >= 1
    _assert_close(out, chaos_control["handoff"], exact=True)


# --------------------------------------------------------------------- #
# thread-exact launch counts
# --------------------------------------------------------------------- #

COUNTERS = [(paged_attention, "launches"), (qmatmul, "launches"), (flash_attention, "launches_fwd"),
            (flash_attention, "launches_dq"), (flash_attention, "launches_dkv"),
            (reference, "launches_matmul_softmax"), (reference, "launches_accumulate"),
            (fixtures, "launches_copy"), (fixtures, "launches_add"), (fixtures, "launches_scale"),
            (fp8, "launches"), (build, "nvcc_builds")]


@pytest.mark.parametrize("module,name", COUNTERS, ids=[f"{m.__name__.split('.')[-1]}.{n}" for m, n in COUNTERS])
def test_launch_counts_exact_under_threads(module, name, monkeypatch):
    """Each kernel wrapper counts its launch through ``count_launch`` (the
    one place a counter moves): eight threads adding 5,000 each leave the
    count at 40,000, with the interpreter switching threads every
    microsecond."""
    import sys

    monkeypatch.setattr(module, name, 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [launch.count_launch(vars(module), name) for _ in range(5000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert getattr(module, name) == 40_000


def _counter_name(node) -> bool:
    name = node.id if isinstance(node, ast.Name) else node.attr if isinstance(node, ast.Attribute) else ""
    return name.startswith("launches") or name == "nvcc_builds"


def test_launch_counters_move_only_through_count_launch():
    """No source line of the package moves a launch counter by itself: an
    augmented assignment (``launches += 1``) or an assignment that reads
    the counter (``launches = launches + 1``) to a ``launches*`` or
    ``nvcc_builds`` name fails, so every count goes through
    ``count_launch`` and its lock. Resetting a counter to a constant stays
    allowed. Every counter of ``COUNTERS`` is moved by a ``count_launch``
    call in its own module."""
    pkg = Path(pfleet.__file__).resolve().parent
    bad, counted = [], set()
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.AugAssign) and _counter_name(node.target):
                bad.append(f"{path.relative_to(pkg)}:{node.lineno}")
            elif isinstance(node, ast.Assign) and any(_counter_name(t) for t in node.targets):
                if any(_counter_name(n) for n in ast.walk(node.value)):
                    bad.append(f"{path.relative_to(pkg)}:{node.lineno}")
            elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) == "count_launch":
                name = node.args[1].value if len(node.args) > 1 else "launches"
                counted.add((path.stem, name))
    assert bad == []
    assert {(m.__name__.split(".")[-1], n) for m, n in COUNTERS} <= counted
