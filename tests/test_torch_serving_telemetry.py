"""The port's serving telemetry (telemetry/serving_metrics.py's event log,
Prometheus exposition and fleet merge; telemetry/summarize.py) held
against the JAX package's: the JAX package's ``summarize`` and
``render_text`` over an event log the port's engine and fleet wrote equal
the port's own; Prometheus metric names, labels and count-valued samples
equal the JAX engine's after the same greedy stream (time-valued samples
are each run's own); a fleet's scrape and merge carry ``replica``
labels."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.models as jm
import accelerate_tpu.serving_fleet as jfleet
from accelerate_tpu.telemetry.summarize import render_text as jax_render_text
from accelerate_tpu.telemetry.summarize import summarize as jax_summarize
from accelerate_tpu.scheduling import SchedulerConfig as JaxSchedulerConfig
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.telemetry.serving_metrics import ServingMetrics as JaxServingMetrics
from accelerate_tpu.telemetry.serving_metrics import fleet_prometheus_text as jax_fleet_prometheus_text
import accelerate_tpu_torch.serving_fleet as pfleet
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.scheduling import SchedulerConfig, ShedError
from accelerate_tpu_torch.telemetry import EventLog, read_events, render_text, summarize, summarize_file
from accelerate_tpu_torch.telemetry.serving_metrics import ServingMetrics, fleet_prometheus_text
from accelerate_tpu_torch.test_utils.fault_injection import ReplicaChaos

torch.set_num_threads(2)

ENGINE = dict(num_slots=2, prompt_buckets=(4, 8), tick_block=2)
PROMPTS = [(np.arange(1, 5 + 2 * i) % 250).astype(np.int32) for i in range(5)]
# samples whose value is a time or a rate: each run's own clock
TIMED = ("ttft_ms", "e2e_ms", "itl_ms", "queue_wait_ms", "tokens_per_sec")


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


def _stream(eng, shed_error):
    """The same greedy stream on either engine: five requests, a
    preemption by a priority-0 arrival, a shed at the queue-depth SLO."""
    uids = [eng.submit(p, 5, priority=1) for p in PROMPTS[:2]]
    eng.step()
    uids.append(eng.submit(PROMPTS[2], 3, priority=0))
    uids.append(eng.submit(PROMPTS[3], 3, priority=0))
    with pytest.raises(shed_error):
        eng.submit(PROMPTS[4], 3, priority=1)
    eng.run()
    return uids


def _engines(pair, **kw):
    jmodel, model = pair
    jeng = JaxServingEngine(jmodel, scheduler=JaxSchedulerConfig(enable_preemption=True, max_queue_depth=2), **kw,
                            **ENGINE)
    eng = ServingEngine(model, device="cpu", scheduler=SchedulerConfig(enable_preemption=True, max_queue_depth=2),
                        **kw, **ENGINE)
    return jeng, eng


def _samples(text: str) -> dict:
    """``{(metric, labels): value}`` of a Prometheus exposition, and the
    HELP/TYPE lines in order."""
    out, meta = {}, []
    for line in text.splitlines():
        if line.startswith("#"):
            meta.append(line)
            continue
        m = re.fullmatch(r"(\w+)(\{[^}]*\})? (\S+)", line)
        assert m, line
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out, meta


def _assert_same_exposition(text, jtext):
    got, meta = _samples(text)
    want, jmeta = _samples(jtext)
    assert meta == jmeta
    assert set(got) == set(want)
    for key, value in want.items():
        timed = any(key[0].endswith(f"_{t}") for t in TIMED) and not key[0].endswith("_count")
        if not timed:
            assert got[key] == value, key


@pytest.mark.parametrize("layout", [None, 4], ids=["dense", "paged"])
def test_prometheus_matches_jax(pair, layout):
    """After the same stream (preemption, resume, shed), the port's
    exposition has the JAX engine's HELP/TYPE blocks, metric names and
    labels, and its count-valued samples (counters, ``_count``s, the
    gauges) equal the JAX engine's."""
    jeng, eng = _engines(pair, paged_block_size=layout)
    from accelerate_tpu.scheduling import ShedError as JaxShedError

    _stream(jeng, JaxShedError)
    _stream(eng, ShedError)
    assert eng.metrics.decode_preemptions >= 1 and eng.metrics.requests_shed == 1
    _assert_same_exposition(eng.metrics.prometheus_text(), jeng.metrics.prometheus_text())
    for m in (eng.metrics, jeng.metrics):
        m.replica = "r7"
    _assert_same_exposition(eng.metrics.prometheus_text(), jeng.metrics.prometheus_text())
    assert 'accelerate_tpu_serving_requests_completed_total{replica="r7"} 4' in eng.metrics.prometheus_text()


def test_fleet_prometheus_and_merge_carry_replica_labels(pair):
    """A fleet's scrape: one HELP/TYPE block a metric and a ``replica``
    label a sample, equal to the JAX fleet's after the same stream; the
    merged view sums counters, pools windows, reports the worst replica
    state and renders with ``replica="fleet"``; an unlabelled instance is
    labelled for the render only."""
    jmodel, model = pair
    fleets = []
    for mod, m, kw in ((pfleet, model, dict(device="cpu")), (jfleet, jmodel, {})):
        fr = mod.FleetRouter.from_model(m, num_replicas=2, config=mod.FleetConfig(prefix_reuse=False), **ENGINE, **kw)
        for p in PROMPTS:
            fr.submit(p, 4)
        fr.step()
        fr.fail_replica("r1")
        fr.run()
        fleets.append(fr)
    fr, jfr = fleets
    _assert_same_exposition(fr.prometheus_text(), jfr.prometheus_text())
    text = fr.prometheus_text()
    assert text.count("# TYPE accelerate_tpu_serving_requests_completed_total counter") == 1
    assert 'replica="r0"' in text and 'replica="r1"' in text
    merged, jmerged = fr.metrics_merged(), jfr.metrics_merged()
    _assert_same_exposition(merged.prometheus_text(), jmerged.prometheus_text())
    assert merged.requests_completed == len(PROMPTS) and merged.replica_state == 3
    assert merged.failovers_in == merged.failovers_out >= 1
    assert len(merged.ttft_ms) == sum(len(r.engine.metrics.ttft_ms) for r in fr.replicas)
    assert 'accelerate_tpu_serving_replica_state{replica="fleet"} 3' in merged.prometheus_text()
    bare = [ServingMetrics(None), ServingMetrics(None)]
    assert 'replica="r1"' in fleet_prometheus_text(bare) and all(m.replica is None for m in bare)
    _assert_same_exposition(fleet_prometheus_text(bare), jax_fleet_prometheus_text([JaxServingMetrics(None)] * 2))


def test_summarize_and_render_match_jax(pair, tmp_path):
    """An event log written by the port (an engine's scheduler events and
    metric snapshot, then a traced fleet's spans, failover and flight
    dump): the JAX package's ``summarize`` and ``render_text`` over it
    equal the port's own, and its serving section equals the last
    snapshot's counters."""
    _, model = pair
    path = str(tmp_path / "run.jsonl")
    log = EventLog(path, rank=0)
    eng = ServingEngine(model, device="cpu", telemetry_log=log,
                        scheduler=SchedulerConfig(enable_preemption=True, max_queue_depth=2), **ENGINE)
    _stream(eng, ShedError)
    eng.metrics.emit()
    fr = pfleet.FleetRouter.from_model(model, num_replicas=2, config=pfleet.FleetConfig(
        prefix_reuse=False, failover="handoff"), trace=True, telemetry_log=log, device="cpu", **ENGINE)
    fuids = [fr.submit(p, 5) for p in PROMPTS]
    fr.step()
    with ReplicaChaos("mid_decode", replica="r1"):
        assert sorted(fr.run()) == fuids
    merged = fr.metrics_merged()
    merged.log = log
    merged.emit()
    snap = merged.snapshot()
    log.close()
    events = read_events(path)
    report = summarize(events)
    assert report == jax_summarize(events) == summarize_file(path)
    assert render_text(report) == jax_render_text(report)
    for key in ("requests_submitted", "requests_completed", "tokens_generated", "prefills", "failovers_in",
                "failovers_out", "failovers_lost", "replica_errors", "replica_state", "resumes"):
        assert report["serving"][key] == snap[key], key
    assert report["scheduler"]["shed"] == 1 and report["scheduler"]["preempted"] >= 1
    assert report["traces"]["count"] == len(fuids) and report["traces"]["flight_dumps"] == 1
    assert {"queue_wait", "admit", "prefill", "decode", "failover"} <= set(report["traces"]["by_class"])
    assert "traces:" in render_text(report) and "flight dumps" in render_text(report)


def test_engine_events_match_jax(pair):
    """The engine's own events (admit, shed, preemption, resume), in order
    and with the same fields but the clocks, equal the JAX engine's."""
    jeng, eng = _engines(pair)
    from accelerate_tpu.scheduling import ShedError as JaxShedError

    got, want = [], []
    eng._log.add_tap(got.append)
    jeng._log.add_tap(want.append)
    _stream(jeng, JaxShedError)
    _stream(eng, ShedError)
    drop = ("v", "seq", "ts", "rank", "queue_wait_ms")
    keep = lambda evs: [{k: v for k, v in e.items() if k not in drop} for e in evs  # noqa: E731
                        if not e["name"].startswith(("compile_cache", "serving_bucket_compile"))]
    assert keep(got) == keep(want)
    assert [e["name"] for e in keep(got)].count("resume") >= 1
