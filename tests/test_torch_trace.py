"""The port's request tracing (telemetry/trace.py), crash flight recorder
(telemetry/flightrec.py) and critical-path monitor (telemetry/critpath.py)
held against the JAX package's, unit by unit on injected clocks and end
to end on a traced fleet run of each package over the same weights and
prompts: the same span classes and counts for every request, segment
sums equal to end-to-end latency, a Perfetto-loadable export, and a
flight dump whose last event is the injected fault."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.models as jm
import accelerate_tpu.serving_fleet as jfleet
import accelerate_tpu.telemetry.critpath as jcrit
import accelerate_tpu.telemetry.eventlog as jlog
import accelerate_tpu.telemetry.flightrec as jflight
import accelerate_tpu.telemetry.trace as jtrace
import accelerate_tpu_torch.serving_fleet as pfleet
import accelerate_tpu_torch.telemetry.critpath as pcrit
import accelerate_tpu_torch.telemetry.eventlog as plog
import accelerate_tpu_torch.telemetry.flightrec as pflight
import accelerate_tpu_torch.telemetry.trace as ptrace
from accelerate_tpu.test_utils.fault_injection import ReplicaChaos as JaxReplicaChaos
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.scheduling import SchedulerConfig, ShedError
from accelerate_tpu_torch.test_utils.fault_injection import ReplicaChaos

torch.set_num_threads(2)

ENGINE = dict(num_slots=2, prompt_buckets=(4, 8), tick_block=2)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def _scenario_frontier(tr, clock):
    tid = tr.start(fuid=7, prompt_tokens=5)
    clock.tick(0.010)
    tr.seg(tid, "queue_wait", accounted_ms=9.5)
    tr.seg(tid, "admit", resume=False)
    clock.tick(0.020)
    tr.seg(tid, "prefill", tokens=8, compute_ms=19.0)
    for _ in range(3):
        clock.tick(0.005)
        tr.window(tid, "decode", tokens=2)
    clock.tick(0.001)
    tr.seg(tid, "preempt", generated=6)
    clock.tick(0.004)
    tr.window(tid, "decode", tokens=1)
    tr.attach(tid, uid=3)
    return [tr.finish(tid, status="ok", tokens=7)]


def _scenario_noops(tr, clock):
    tid = tr.start()
    out = [tr.seg(None, "prefill"), tr.window(None, "decode"), tr.finish(None), tr.seg(999, "prefill"),
           tr.attach(999, x=1), tr.finish(999)]
    out.append(tr.finish(tid, status="shed", reason="queue depth"))
    out.append(tr.finish(tid))
    tid2 = tr.start()
    tr.discard(tid2)
    out.append(tr.finish(tid2))
    return out + [tr.started, tr.finished]


def _scenario_ring(tr, clock):
    for i in range(5):
        tid = tr.start(fuid=i)
        clock.tick(0.001 * (i + 1))
        tr.seg(tid, "prefill", tokens=i)
        tr.finish(tid)
    open_id = tr.start(fuid=9)
    clock.tick(0.002)
    tr.seg(open_id, "queue_wait")
    return [tr.completed(), tr.completed(2), tr.open_spans()]


TRACER_CASES = {"frontier": _scenario_frontier, "noops": _scenario_noops, "ring": _scenario_ring}


@pytest.mark.parametrize("case", sorted(TRACER_CASES))
def test_tracer_matches_jax(case):
    """The same calls on an injected clock give the same trace dicts,
    completed ring and open spans in both packages; segments are
    frontier-contiguous, consecutive decode windows merge and a segment
    breaks the merge."""
    outs = []
    for mod in (ptrace, jtrace):
        clock = _Clock()
        tr = mod.Tracer(max_traces=3, clock=clock)
        outs.append(TRACER_CASES[case](tr, clock))
    assert outs[0] == outs[1]
    if case == "frontier":
        (trace,) = outs[0]
        assert [s["name"] for s in trace["spans"]] == ["queue_wait", "admit", "prefill", "decode", "preempt", "decode"]
        assert trace["spans"][3]["tokens"] == 6
        assert abs(sum(s["dur_ms"] for s in trace["spans"]) - trace["dur_ms"]) < 1e-6


def _traces(mod):
    clock = _Clock()
    tr = mod.Tracer(clock=clock)
    traces = _scenario_frontier(tr, clock)
    tid = tr.start(fuid=8)
    clock.tick(0.003)
    tr.seg(tid, "kv_handoff", src="r0", dst="r1", tokens=9, moved_bytes=4616, predicted_bytes=4616, predicted_us=1.0)
    tr.seg(tid, "failover", src="r1", dst="r2", path="handoff", moved_bytes=100, predicted_bytes=96)
    clock.tick(0.002)
    tr.seg(tid, "drain", path="recompute", moved_bytes=0, predicted_bytes=0)
    clock.tick(0.020)
    tr.seg(tid, "queue_wait", accounted_ms=0.0)
    clock.tick(0.030)
    tr.seg(tid, "prefill", tokens=4, compute_ms=30.0)
    traces.append(tr.finish(tid, status="ok"))
    tid = tr.start(fuid=9)
    traces.append(tr.finish(tid, status="lost", reason="no snapshot"))
    return traces


def test_trace_export_and_reconstruction_match_jax(tmp_path):
    """Span records and ``trace_complete`` events written by each package
    reconstruct to the same traces through either package's
    ``traces_from_events``; the Chrome export loads as JSON with one
    ``tid`` a request and matches the JAX package's but for the process
    name."""
    outs = {}
    for name, mod, log_mod in (("port", ptrace, plog), ("jax", jtrace, jlog)):
        clock = _Clock()
        log = log_mod.EventLog(str(tmp_path / f"{name}.jsonl"), rank=0, clock=clock)
        tr = mod.Tracer(clock=clock, log=log)
        _scenario_frontier(tr, clock)
        tid = tr.start(fuid=4)
        clock.tick(0.002)
        tr.seg(tid, "prefill", tokens=4)
        tr.finish(tid)
        log.close()
        events = log_mod.read_events(str(tmp_path / f"{name}.jsonl"))
        outs[name] = (events, mod.traces_from_events(events), json.loads(json.dumps(mod.chrome_trace(tr.completed()))))
    strip = lambda evs: [{k: v for k, v in e.items() if k != "seq"} for e in evs]  # noqa: E731
    assert strip(outs["port"][0]) == strip(outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1] == jtrace.traces_from_events(outs["port"][0])
    pdoc, jdoc = outs["port"][2], outs["jax"][2]
    assert pdoc["traceEvents"][1:] == jdoc["traceEvents"][1:]
    assert pdoc["traceEvents"][0]["args"]["name"] == "accelerate_tpu_torch serving"
    assert {e["tid"] for e in pdoc["traceEvents"] if e["ph"] == "X"} == {1, 2}


def test_critpath_matches_jax():
    """``decompose``, ``render_critpath`` and ``CritPathMonitor``'s latched
    drift (one ``trace_drift`` a segment class, byte checks exact, time
    checks past their threshold and floor) equal the JAX package's."""
    traces = _traces(ptrace)
    assert traces == _traces(jtrace)
    assert pcrit.decompose(traces) == jcrit.decompose(traces)
    outs = []
    for mod, log_mod in ((pcrit, plog), (jcrit, jlog)):
        got = []
        log = log_mod.EventLog(None, rank=0)
        log.add_tap(got.append)
        mon = mod.CritPathMonitor(log, price_prefill_us=lambda n: 1000.0 * n)
        for tr in traces + traces:
            mon.observe(tr)
        report = mod.decompose(traces)
        outs.append(([{k: v for k, v in e.items() if k not in ("seq", "ts")} for e in got],
                     {k: {kk: vv for kk, vv in v.items() if kk not in ("seq", "ts")} for k, v in mon.drift_events.items()},
                     mod.render_critpath(report, drift=list(mon.drift_events.values())), mon.observed))
        mon.reset()
        assert mon.drift_events == {}
    assert outs[0] == outs[1]
    assert set(outs[0][1]) == {"failover", "prefill", "queue_wait"}


def test_flightrec_matches_jax(tmp_path):
    """The ring keeps the last N records in order; a dump (written, read
    back and rendered) equals the JAX package's, and hostile fields never
    make it raise."""
    docs = []
    for name, mod in (("port", pflight), ("jax", jflight)):
        fr = mod.FlightRecorder(8, name="r0", clock=lambda: 5.0)
        for i in range(11):
            fr.record({"seq": i, "kind": "event", "name": "admit" if i < 10 else "replica_state", "uid": i,
                       "severity": "warning" if i == 10 else "info", "reason": "dead: boom"})
        assert len(fr) == 8 and [r["seq"] for r in fr.tail()] == list(range(3, 11))
        path = str(tmp_path / f"{name}.json")
        doc = fr.dump(reason="dead: boom", inflight=[{"uid": 1, "state": "active", "trace": None}],
                      open_spans=[{"trace": 3, "segment": "decode", "age_ms": 2.0, "spans": 4}], path=path)
        back = mod.read_dump(path)
        docs.append((back, mod.render_dump(back, tail=4), fr.dump_count))
        (tmp_path / "a_file").write_text("")
        bad = fr.dump(reason="x", path=str(tmp_path / "a_file" / "f.json"))
        assert "write_error" in bad
    assert docs[0] == docs[1]
    assert docs[0][0]["events"][-1]["name"] == "replica_state"
    with pytest.raises(ValueError, match="capacity"):
        pflight.FlightRecorder(4)


# --------------------------------------------------------------------- #
# traced fleets (JAX package and port, same weights)
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def pair():
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


PROMPTS = [(np.arange(1, 7 + i) % 250).astype(np.int32) for i in range(3)] + [
    (np.arange(3, 14) % 250).astype(np.int32)]


@pytest.mark.parametrize("roles", [None, ("prefill", "decode")], ids=["mixed", "disaggregated"])
def test_fleet_traces_match_jax(pair, roles):
    """One trace a request across prefill, handoff and decode: the span
    class names and counts of every request equal the JAX fleet's for the
    same greedy run; segment sums equal end-to-end latency (frontier
    contiguity); the handoff spans carry moved == predicted bytes; no
    drift latches; the Chrome export loads as JSON."""
    jmodel, model = pair
    counts = []
    for mod, m, kw in ((pfleet, model, dict(device="cpu")), (jfleet, jmodel, {})):
        fr = mod.FleetRouter.from_model(m, num_replicas=2, config=mod.FleetConfig(
            roles=roles, handoff="always", prefix_reuse=False), trace=True, **ENGINE, **kw)
        fuids = [fr.submit(p, 5) for p in PROMPTS]
        out = fr.run()
        assert sorted(out) == fuids
        traces = {t["meta"]["fuid"]: t for t in fr.tracer.completed()}
        assert sorted(traces) == fuids and all(t["status"] == "ok" for t in traces.values())
        per_request = {}
        for fuid, t in traces.items():
            names = [s["name"] for s in t["spans"]]
            per_request[fuid] = {n: names.count(n) for n in sorted(set(names))}
            assert abs(t["dur_ms"] - sum(s["dur_ms"] for s in t["spans"])) <= 1.0
            for s in t["spans"]:
                if s["name"] == "kv_handoff" and "moved_bytes" in s:
                    assert s["moved_bytes"] == s["predicted_bytes"] > 0
        assert fr.critpath.drift_events.keys() <= {"queue_wait"}
        doc = (ptrace if mod is pfleet else jtrace).chrome_trace(fr.tracer.completed())
        assert len(json.loads(json.dumps(doc))["traceEvents"]) > len(fuids)
        counts.append(per_request)
    assert counts[0] == counts[1]
    if roles:
        assert all(c["kv_handoff"] == 2 for c in counts[0].values())


@pytest.mark.parametrize("action", ["crash", "poison", "hang"])
def test_every_fault_class_dumps_the_flight_recorder(pair, action):
    """A crash, a poison and a hang each leave a dump on the faulted
    replica that ends with the injected fault's ``replica_state`` event,
    and a ``flight_dump`` event in the log; every request is served."""
    _, model = pair
    fr = pfleet.FleetRouter.from_model(model, num_replicas=2, config=pfleet.FleetConfig(
        prefix_reuse=False, quarantine_after_timeouts=1), trace=True, device="cpu", **ENGINE)
    emitted = []
    for rep in fr.replicas:
        rep.engine._log.add_tap(emitted.append)
    fuids = [fr.submit(p, 6) for p in PROMPTS]
    fr.step()
    if action == "hang":
        fr.config.tick_timeout_s = 0.05
        kw = {"action": "hang", "hang_s": 0.2, "repeat": True}
    else:
        kw = {"action": action}
    with ReplicaChaos("pre_tick", replica="r0", **kw) as chaos:
        out = fr.run()
    assert chaos.fired and sorted(out) == fuids
    expected = {"crash": "dead", "poison": "quarantined", "hang": "quarantined"}[action]
    assert fr.health()["r0"]["health"] == expected
    dump = fr.replicas[0].flightrec.last_dump
    assert dump["reason"].startswith(expected)
    last = dump["events"][-1]
    marker = {"crash": "SimulatedCrash", "poison": "NonFinitePoison", "hang": "timeout"}[action]
    assert last["name"] == "replica_state" and last["state"] == expected and marker in last["reason"]
    assert any(e.get("name") == "flight_dump" for e in emitted)
    assert "in-flight requests" in pflight.render_dump(dump)


def test_flight_dump_tail_matches_jax_at_the_same_fault(pair):
    """The event names in the faulted replica's dump equal the JAX fleet's
    at the same crash."""
    jmodel, model = pair
    names = []
    for mod, chaos, m, kw in ((pfleet, ReplicaChaos, model, dict(device="cpu")), (jfleet, JaxReplicaChaos, jmodel, {})):
        fr = mod.FleetRouter.from_model(m, num_replicas=2, config=mod.FleetConfig(prefix_reuse=False),
                                        trace=True, **ENGINE, **kw)
        for p in PROMPTS:
            fr.submit(p, 6)
        fr.step()
        with chaos("mid_decode", replica="r0", action="crash"):
            fr.run()
        # the JAX engine logs its program builds too; the port builds no program
        names.append([e["name"] for e in fr.replicas[0].flightrec.last_dump["events"]
                      if not e["name"].startswith(("compile_cache", "serving_bucket_compile"))])
    assert names[0] == names[1] and names[0][-1] == "replica_state"


def test_shed_closes_the_trace_and_carries_its_id(pair):
    """A shed at submit closes a router-minted trace (status ``shed``) and
    the ShedError names it; a tracing engine mints its own trace for a
    request submitted without one, after the shed gate."""
    _, model = pair
    tracer = ptrace.Tracer()
    eng = ServingEngine(model, device="cpu", tracer=tracer, scheduler=SchedulerConfig(max_queue_depth=1), **ENGINE)
    eng.submit(PROMPTS[0], 2, priority=1)
    tid = tracer.start(fuid=1)
    with pytest.raises(ShedError) as err:
        eng.submit(PROMPTS[1], 2, priority=1, trace=tid)
    assert err.value.trace_id == tid and f"trace={tid}" in str(err.value)
    (done,) = tracer.completed()
    assert done["id"] == tid and done["status"] == "shed" and done["meta"]["reason"].startswith("queue depth")
    eng.run()
    assert [t["status"] for t in tracer.completed()] == ["shed", "ok"]
    assert tracer.completed()[1]["meta"]["uid"] == 0
