"""The port's runtime telemetry (accelerate_tpu_torch.telemetry) against
the JAX package's: the event log's schema and line format (each
package's ``read_events`` reads the other's log), the step split and the
recompile watchdog driven by one fake clock through both, ``mfu`` and
``goodput`` on the same numbers, the non-finite watchdog's events, device
memory sampling, and the Accelerator's wiring (the telemetry property,
``accumulate`` timed as steps, prepare markers, forwarding to the
trackers, the train step's finiteness probe, the checkpoint events). The
JAX side runs on the CPU."""

import json
import math
import os

import numpy as np
import pytest
import torch

from accelerate_tpu import telemetry as jtel
from accelerate_tpu_torch import Accelerator, ProjectConfiguration, TelemetryKwargs
from accelerate_tpu_torch import telemetry as tel
from accelerate_tpu_torch.analysis.costmodel import HBM_GB_TABLE, PEAK_FLOPS_TABLE, peak_flops
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils.training import RegressionDataset, RegressionModel, linear_loss_fn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _strip(events):
    """Records without the per-process counter and the wall clock."""
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")} for e in events]


class FakeClock:
    """Advances by the next of ``steps`` (seconds) on every read."""

    def __init__(self, steps):
        self.t, self.steps, self.i = 100.0, steps, 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


# --------------------------------------------------------------------- #
# event log
# --------------------------------------------------------------------- #


def _emit_all(log, array):
    log.counter("hbm_bytes_in_use", 1024)
    log.event("recompile", severity="warning", step=7, changed=["0/0/x: int32[8] -> int32[16]"])
    log.event("weird", arr=array, scalar=np.int32(7))
    with log.span("prefill", bucket=32):
        pass
    log.close()


def test_eventlog_line_format_matches_and_each_package_reads_the_others(tmp_path):
    """The same emits through both loggers give the same records (the span's
    duration aside), and each package's ``read_events`` reads the other's
    file; a tensor field is written as the JAX package writes an array."""
    jpath, ppath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    _emit_all(jtel.EventLog(jpath, rank=3, main_process_only=False, buffer_lines=2, clock=lambda: 123.5),
              np.zeros((2, 3), np.float32))
    _emit_all(tel.EventLog(ppath, rank=3, main_process_only=False, buffer_lines=2, clock=lambda: 123.5),
              torch.zeros(2, 3))
    assert tel.SCHEMA_VERSION == jtel.SCHEMA_VERSION == 1
    for reader in (tel.read_events, jtel.read_events):
        want, got = _strip(reader(jpath)), _strip(reader(ppath))
        for e in want + got:
            e.pop("dur_ms", None)
        assert got == want
    [weird] = [e for e in tel.read_events(ppath) if e["name"] == "weird"]
    assert weird["arr"] == "float32[2,3]" and weird["scalar"] == 7
    events = tel.read_events(ppath)
    assert [e["kind"] for e in events] == ["counter", "event", "event", "span"]
    assert all(e["v"] == 1 and e["rank"] == 3 and e["ts"] == 123.5 for e in events)
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == 4


def test_eventlog_buffers_disabled_modes_and_bad_kinds(tmp_path):
    path = str(tmp_path / "run.jsonl")
    log = tel.EventLog(path, rank=0, buffer_lines=10)
    log.counter("a", 1)
    assert tel.read_events(path) == []  # still buffered
    log.flush()
    assert len(tel.read_events(path)) == 1
    log.close()
    assert tel.EventLog(None).counter("x", 1)["value"] == 1
    rank1 = tel.EventLog(str(tmp_path / "rank1.jsonl"), rank=1, main_process_only=True)
    assert not rank1.enabled and not os.path.exists(tmp_path / "rank1.jsonl")
    with pytest.raises(ValueError):
        tel.EventLog(None).emit("bogus", "x")
    corrupt = tmp_path / "corrupt.jsonl"
    corrupt.write_text('{"v": 1, "kind": "counter", "name": "a", "value": 1}\n{truncated\n')
    assert len(tel.read_events(str(corrupt))) == 1
    merged = tel.merge_events([{"ts": 2.0, "seq": 0, "rank": 0}], [{"ts": 1.0, "seq": 5, "rank": 1}])
    assert [e["ts"] for e in merged] == [1.0, 2.0]


def test_the_rank_comes_from_an_existing_state_only():
    assert tel.EventLog(None).rank == 0  # no PartialState: no state is made
    assert not PartialState._shared_state
    PartialState(cpu=True)
    assert tel.EventLog(None).rank == 0


# --------------------------------------------------------------------- #
# step timeline and watchdog, one fake clock through both packages
# --------------------------------------------------------------------- #


def _drive(module, log, steps_fn):
    """Seven calls through ``StepTelemetry.wrap``, then a context-manager
    step: shapes 32, 32, 32, 16 (a miss), 16, 32 (seen: no miss), 8 (a
    miss); the clock advances 1 ms, 2 ms, 3 ms, 4 ms in turn."""
    st = module.StepTelemetry(log, warmup_steps=2, clock=FakeClock([1e-3, 2e-3, 3e-3, 4e-3]),
                              flops_per_step=2e9, peak_flops_per_device=1e12)
    step = st.wrap(lambda batch: None)
    for n in (32, 32, 32, 16, 16, 32, 8):
        step(steps_fn(n))
    with st.step() as handle:
        handle.done(None)
    return st


def test_step_split_and_watchdog_match_jax_on_a_fake_clock(tmp_path):
    jpath, ppath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jst = _drive(jtel, jtel.EventLog(jpath, rank=0, clock=lambda: 1.0),
                 lambda n: {"input_ids": np.zeros((8, n), np.int32)})
    pst = _drive(tel, tel.EventLog(ppath, rank=0, clock=lambda: 1.0),
                 lambda n: {"input_ids": torch.zeros(8, n, dtype=torch.int32)})
    jst.log.close()
    pst.log.close()
    assert list(pst.records) == list(jst.records)
    assert pst.recompiles == jst.recompiles == 2
    assert _strip(tel.read_events(ppath)) == _strip(jtel.read_events(jpath))
    assert pst.summary() == jst.summary()
    [first, second] = pst.recompile_events
    assert first["changed"] == ["0/0/input_ids: int32[8,32] -> int32[8,16]"]
    assert first["suggested_bucket"] == ["0/0/input_ids: pad to int32[8,32]"]
    assert second["step"] == 6
    rec = pst.records[3]
    assert rec["compile"] and math.isclose(rec["dur_ms"], rec["data_wait_ms"] + rec["dispatch_ms"] + rec["execute_ms"],
                                           abs_tol=0.01)
    assert all("mfu" in r for r in pst.steady_records())


def test_signature_and_diff_name_the_changed_leaf():
    a = tel.signature_of({"input_ids": torch.zeros(8, 128, dtype=torch.int32)})
    b = tel.signature_of({"input_ids": torch.zeros(8, 256, dtype=torch.int32)})
    assert a == jtel.signature_of({"input_ids": np.zeros((8, 128), np.int32)})
    [change] = tel.diff_signatures(a, b)
    assert change == jtel.diff_signatures(jtel.signature_of({"input_ids": np.zeros((8, 128), np.int32)}),
                                          jtel.signature_of({"input_ids": np.zeros((8, 256), np.int32)}))[0]
    assert tel.suggest_buckets(a, tel.signature_of({"input_ids": torch.zeros(8, 100, dtype=torch.int32)})) == [
        "input_ids: pad to int32[8,128]"]


def test_watchdog_state_is_per_wrapper():
    st = tel.StepTelemetry(warmup_steps=2)
    for _ in range(5):
        with st.step() as h:
            h.done(None)
    step_a = st.wrap(lambda x: x.sum())
    for _ in range(4):
        step_a(torch.ones(24, 24))
    step_b = st.wrap(lambda x: (x + 1).sum())
    for _ in range(3):
        step_b(torch.ones(24, 24))
    assert st.recompiles == 0
    step_a(torch.ones(12, 12))
    assert st.recompiles == 1


def test_static_step_estimate_drift_fires_once():
    st = tel.StepTelemetry(clock=FakeClock([5e-3]), warmup_steps=1)
    st.set_static_step_estimate(1.0)
    step = st.wrap(lambda: None)
    for _ in range(10):
        step()
    assert st.perf_drift_event is not None and st.summary()["perf_model_drift"]


# --------------------------------------------------------------------- #
# MFU, goodput, memory
# --------------------------------------------------------------------- #


def test_mfu_and_goodput_equal_the_jax_functions():
    flops = 2 * 512**3
    for args, kw in (((flops, 1e-3, 1), {"peak": 1e12}), ((flops, 1e-3, 2), {"peak": 1e12}),
                     ((6.0e15, 0.61, 1), {"peak": 989.4e12})):
        assert tel.mfu(*args, **kw) == jtel.mfu(*args, **kw)
    assert tel.mfu(flops, 1e-3, generation="h100") == pytest.approx(flops / 1e-3 / 989.4e12)
    assert tel.mfu(flops, 1e-3, generation="h100", dtype="int8") == pytest.approx(flops / 1e-3 / 1978.9e12)
    assert peak_flops("unknown-card") == PEAK_FLOPS_TABLE["h100"]["bf16"] and HBM_GB_TABLE["h100"] == 80.0
    for bad in ((flops, 0.0), (flops, 1e-3, 0)):
        with pytest.raises(ValueError):
            tel.mfu(*bad)
    recs = [{"dur_ms": 10.0, "data_wait_ms": 5.0, "dispatch_ms": 1.0, "execute_ms": 4.0},
            {"dur_ms": 10.0, "data_wait_ms": 0.0, "dispatch_ms": 2.0, "execute_ms": 8.0}]
    assert tel.goodput(recs) == jtel.goodput(recs) == pytest.approx(0.75)
    assert tel.goodput([]) is None


def test_flops_from_one_call_with_the_flop_counter():
    """``flops_from_compiled`` counts one call with FlopCounterMode (the
    JAX function reads XLA's cost analysis): a 128^3 matmul is 2 x 128^3."""
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    assert tel.flops_from_compiled(lambda: a @ b) == 2 * 128**3
    assert tel.flops_from_compiled(object()) is None
    assert tel.flops_from_compiled(lambda: a + b) is None


def test_hbm_sampler_drift_once_and_degrades_without_a_card(tmp_path):
    path = str(tmp_path / "run.jsonl")
    log = tel.EventLog(path, rank=0)
    stats = {"bytes_in_use": 100, "peak_bytes_in_use": 130 * 2**20, "bytes_limit": 80 * 2**30}
    sampler = tel.HBMSampler(log, static_peak_bytes=100 * 2**20, stats_fn=lambda: stats)
    sampler.sample()
    sampler.sample()
    log.close()
    assert sampler.drift_event["rel_error"] == pytest.approx(0.3)
    assert [e["name"] for e in tel.read_events(path)].count("hbm_drift") == 1
    assert sampler.headroom_bytes(hbm_gb=HBM_GB_TABLE["h100"]) == int(80 * 1024**3) - 130 * 2**20
    if not torch.cuda.is_available():
        assert tel.HBMSampler().sample() is None and sampler.headroom_bytes() is None


# --------------------------------------------------------------------- #
# non-finite watchdog
# --------------------------------------------------------------------- #


def _observe_all(wd, grads):
    wd.observe(1, loss=float("nan"))  # off cadence: nothing
    for step in range(0, 6, 2):
        wd.observe(step, loss=1.0, grad_norm=0.5, loss_scale=2.0**15)
    wd.observe(6, loss=1.0, loss_scale=2.0**14)
    wd.observe(8, loss=1.0, grads=grads, loss_scale=2.0**14, scaler_handled=True)
    wd.observe(10, loss=float("inf"), loss_scale=2.0**13)
    wd.observe(12, loss=float("nan"), loss_scale=2.0**13)  # latched: no second event
    wd.log.close()
    return wd


def test_nonfinite_watchdog_events_equal_jax(tmp_path):
    jpath, ppath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jwd = _observe_all(jtel.NonFiniteWatchdog(jtel.EventLog(jpath, rank=0, clock=lambda: 1.0), every=2),
                       {"w": np.ones(4), "inner": {"b": np.array([0.0, np.nan])}})
    pwd = _observe_all(tel.NonFiniteWatchdog(tel.EventLog(ppath, rank=0, clock=lambda: 1.0), every=2),
                       {"w": torch.ones(4), "inner": {"b": torch.tensor([0.0, float("nan")])}})
    assert _strip(tel.read_events(ppath)) == _strip(jtel.read_events(jpath))
    assert pwd.summary() == jwd.summary()
    assert pwd.scaler_skips == 1 and pwd.nonfinite_event["leaf"] == "loss"
    wd = tel.NonFiniteWatchdog(every=1)
    rec = wd.observe(0, grads={"w": torch.ones(4), "inner": {"b": torch.tensor([0.0, float("nan")])}})
    assert rec["bad_leaf"] == "grads['inner']['b']"


# --------------------------------------------------------------------- #
# the Accelerator's wiring
# --------------------------------------------------------------------- #


def _regression(acc, lr=0.1):
    model = acc.prepare_model(RegressionModel())
    opt = acc.prepare_optimizer(torch.optim.SGD(model.module.parameters(), lr=lr))
    data = RegressionDataset(length=16)
    batch = {"x": torch.from_numpy(data.x), "y": torch.from_numpy(data.y)}
    return model, opt, batch


def test_accelerator_telemetry_end_to_end(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path),
                      kwargs_handlers=[TelemetryKwargs(hbm_sample_every=1, forward_to_trackers_every=0)])
    model, _, batch = _regression(acc)
    step = acc.telemetry.wrap(acc.build_train_step(linear_loss_fn))
    for _ in range(4):
        step(batch)
    acc.telemetry.close()
    path = str(tmp_path / "telemetry.jsonl")
    assert acc.telemetry.path == path
    assert len([e for e in tel.read_events(path) if e["kind"] == "span" and e["name"] == "step"]) == 4
    summary = acc.telemetry.summary()
    # the first call is attributed as the compile; the same signature after it is steady
    assert summary["steps"] == 4 and summary["recompiles"] == 0 and summary["steady_steps"] == 3


def test_accumulate_blocks_are_timed_and_prepare_is_marked(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    acc.telemetry  # live before prepare: the prepare is marked
    model, opt, batch = _regression(acc)
    acc.prepare(RegressionModel())
    for _ in range(3):
        with acc.accumulate(model):
            acc.backward(linear_loss_fn, batch)
            opt.step()
    assert acc.telemetry.steps.step_index == 3
    acc.telemetry.close()
    [marker] = [e for e in tel.read_events(str(tmp_path / "telemetry.jsonl")) if e["name"] == "prepare"]
    assert marker["models"] == 2 and marker["optimizers"] == 1 and marker["mixed_precision"] == "no"


def test_telemetry_forwards_summaries_to_the_trackers(tmp_path):
    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path),
                      kwargs_handlers=[TelemetryKwargs(forward_to_trackers_every=2, hbm_sample_every=0)])
    acc.init_trackers("proj")
    _, _, batch = _regression(acc)
    step = acc.telemetry.wrap(acc.build_train_step(linear_loss_fn))
    acc.telemetry.steps.flops_per_step, acc.telemetry.steps.peak_flops_per_device = 1e6, 1e12
    for _ in range(6):
        step(batch)
    acc.end_training()
    lines = [json.loads(line) for line in (tmp_path / "proj" / "metrics.jsonl").read_text().splitlines()]
    forwarded = [line for line in lines if any(k.startswith("telemetry/") for k in line)]
    assert [line["_step"] for line in forwarded] == [2, 4]
    assert all(line["telemetry/recompiles"] == 0 and "telemetry/step_ms" in line for line in forwarded)
    assert "telemetry/mfu" in forwarded[-1]


def test_telemetry_disabled_keeps_the_in_memory_summary(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path), kwargs_handlers=[TelemetryKwargs(enabled=False)])
    _, _, batch = _regression(acc)
    step = acc.telemetry.wrap(acc.build_train_step(linear_loss_fn))
    for _ in range(3):
        step(batch)
    assert acc.telemetry.path is None and not (tmp_path / "telemetry.jsonl").exists()
    assert acc.telemetry.summary()["steps"] == 3


def test_the_train_step_probes_finiteness_at_its_cadence(tmp_path):
    """``TelemetryKwargs(nonfinite_every=2)``: a clean fp16 run stays
    silent and its loss scale is in the trajectory; a diverging one
    latches one ``nonfinite`` event naming the loss."""
    path = str(tmp_path / "run.jsonl")
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[TelemetryKwargs(output_path=path, nonfinite_every=2)])
    acc.telemetry
    _, _, batch = _regression(acc, lr=0.05)
    step = acc.build_train_step(linear_loss_fn)
    for _ in range(6):
        step(batch)
    wd = acc.telemetry.nonfinite
    assert wd.probes == 3 and wd.nonfinite_event is None
    assert wd.scale_trajectory[-1][1] == acc._loss_scale
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(cpu=True, kwargs_handlers=[TelemetryKwargs(output_path=path, nonfinite_every=1)])
    acc.telemetry
    _, _, batch = _regression(acc, lr=1e6)  # diverges
    step = acc.build_train_step(linear_loss_fn)
    for _ in range(8):
        step(batch)
    acc.telemetry.close()
    events = [e for e in tel.read_events(path) if e["name"] == "nonfinite"]
    assert len(events) == 1 and events[0]["leaf"] in ("loss", "grad_norm")


def test_checkpoint_events_fire_once_telemetry_is_live(tmp_path):
    """``checkpointing._telemetry_log`` returns the live log: a save
    writes ``ckpt_commit``, an auto-resume ``ckpt_auto_resume`` and a
    checkpoint missing its RNG file ``ckpt_rng_missing``; before the
    telemetry is touched nothing is written."""
    from accelerate_tpu_torch.checkpointing import _telemetry_log

    project = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True)
    acc = Accelerator(cpu=True, project_config=project)
    _, _, batch = _regression(acc)
    step = acc.build_train_step(linear_loss_fn)
    step(batch)
    assert _telemetry_log(acc) is None
    acc.save_state()
    assert not (tmp_path / "telemetry.jsonl").exists()
    assert _telemetry_log(acc.telemetry and acc) is acc.telemetry.log
    out = acc.save_state()
    for f in os.listdir(out):
        if f.startswith("rng_state"):
            os.remove(os.path.join(out, f))
    acc.load_state(out)
    acc.telemetry.close()
    names = [e["name"] for e in tel.read_events(str(tmp_path / "telemetry.jsonl"))]
    assert names.count("ckpt_commit") == 1 and "ckpt_rng_missing" in names
    [commit] = [e for e in tel.read_events(str(tmp_path / "telemetry.jsonl")) if e["name"] == "ckpt_commit"]
    assert commit["iteration"] == 1 and commit["step"] == 1


def test_what_stays_unported_raises_naming_its_item():
    assert TelemetryKwargs().trace_config() is None
    cfg = TelemetryKwargs(trace_requests=True, flight_capacity=512).trace_config()
    assert isinstance(cfg, tel.TraceConfig) and cfg.flight_capacity == 512
    with pytest.raises(ValueError, match="flight_capacity"):
        TelemetryKwargs(flight_capacity=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8"):
        tel.hlo_wire_bytes()
    # item 10's process half is ported: the HTTP endpoint is the real one
    from accelerate_tpu_torch.telemetry.httpd import TelemetryHTTPD

    assert tel.TelemetryHTTPD is TelemetryHTTPD
    with pytest.raises(NotImplementedError, match="item 8"):
        tel.Telemetry(None).record_wire_bytes(1, 1)
    with pytest.raises(ValueError):
        TelemetryKwargs(nonfinite_every=-1)
