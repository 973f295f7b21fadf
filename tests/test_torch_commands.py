"""The port's command-line surfaces (commands/{trace,telemetry,fleet,serve,
cli}.py) against the JAX package's: ``trace summarize`` / ``export`` /
``flight-dump`` / ``selfcheck`` and ``telemetry summarize`` print what the
JAX commands print on the same files; ``fleet price-*`` follows the JAX
formulas at the same bandwidth and peak; the CLI front registers the
port's commands and no others; the entry points that need the card refuse
without one."""

import argparse
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import accelerate_tpu.analysis.costmodel as jcost
import accelerate_tpu.commands.fleet as jfleet_cmd
import accelerate_tpu.commands.telemetry as jtel_cmd
import accelerate_tpu.commands.trace as jtrace_cmd
import accelerate_tpu_torch.analysis.costmodel as pcost
import accelerate_tpu_torch.commands.fleet as pfleet_cmd
import accelerate_tpu_torch.commands.telemetry as ptel_cmd
import accelerate_tpu_torch.commands.trace as ptrace_cmd
from accelerate_tpu_torch import LlamaConfig, create_llama_model
from accelerate_tpu_torch.commands import cli
from accelerate_tpu_torch.serving_fleet import FleetConfig, FleetRouter
from accelerate_tpu_torch.telemetry import EventLog, FlightRecorder, Telemetry
from accelerate_tpu_torch.test_utils.fault_injection import ReplicaChaos

torch.set_num_threads(2)


def _run(parser_fn, argv):
    """``(exit code, stdout)`` of one command through its own parser."""
    args = parser_fn().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = args.func(args) if hasattr(args, "func") else (
            args.trace_func(args) if hasattr(args, "trace_func") else args.telemetry_func(args))
    return rc, out.getvalue()


def _both(argv, j=jtrace_cmd.trace_parser, p=ptrace_cmd.trace_parser):
    return _run(j, argv), _run(p, argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Files the commands read, written by the port: a traced fleet's event
    log (a crash failing over, its flight dump), a step-telemetry log, and
    a supervisor-style run dir of per-process logs with tied timestamps."""
    root = tmp_path_factory.mktemp("runs")
    fleet_log = str(root / "fleet.jsonl")
    log = EventLog(fleet_log, rank=0)
    model = create_llama_model(LlamaConfig.tiny(), device="cpu")
    fr = FleetRouter.from_model(model, num_replicas=2, config=FleetConfig(prefix_reuse=False), trace=True,
                                telemetry_log=log, num_slots=2, prompt_buckets=(8,), max_len=64, tick_block=2,
                                device="cpu")
    fuids = [fr.submit(np.arange(1, 6 + i, dtype=np.int32) * 3 % 250, 8) for i in range(4)]
    fr.step()
    with ReplicaChaos("mid_decode", replica="r1") as chaos:
        fr.run()
    assert chaos.fired and all(fr.poll(f) is not None for f in fuids)
    merged = fr.metrics_merged()
    merged.log = log
    merged.emit()
    log.close()
    dump = next(r for r in fr.replicas if r.name == "r1").flightrec.last_dump
    flight = str(root / "flight_r1.json")
    with open(flight, "w") as f:
        json.dump(dump, f)
    fr2 = FlightRecorder(8, name="w1")
    for i in range(12):
        fr2.record({"kind": "event", "name": f"e{i}", "seq": i})
    small_flight = str(root / "flight_w1.json")
    fr2.dump(reason="process exit rc=-9", inflight=[{"fuid": 3, "uid": 1, "generated": 4, "trace": None}],
             path=small_flight)

    step_log = str(root / "steps.jsonl")
    tel = Telemetry(step_log, rank=0, hbm_sample_every=1, flops_per_step=2 * 32**3, peak_flops_per_device=1e12)
    step = tel.wrap(lambda x: (x @ x).sum())
    for n in (32, 32, 32, 32, 16):
        step(torch.ones((n, n)))
    tel.close()

    run_dir = root / "sup"
    run_dir.mkdir()
    for name, rank in (("supervisor", -1), ("w0", 0), ("w1", 1)):
        recs = [{"v": 1, "seq": s, "ts": 10.0, "rank": rank, "kind": "event", "name": f"{name}_{s}"} for s in range(3)]
        with open(run_dir / f"events_{name}.jsonl", "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    os.link(fleet_log, run_dir / "events_fleet.jsonl")
    return {"fleet": fleet_log, "steps": step_log, "flight": flight, "small_flight": small_flight,
            "run_dir": str(run_dir), "empty": str(root / "nothing_here")}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("which", ["fleet", "run_dir", "steps", "empty"])
def test_trace_summarize_prints_what_jax_prints(runs, which, fmt):
    (jrc, jout), (prc, pout) = _both(["summarize", runs[which], "--format", fmt, "--strict"])
    assert (prc, pout) == (jrc, jout)
    if which == "fleet" and fmt == "json":
        report = json.loads(pout)
        assert report["count"] == 4 and "failover" in report["by_class"]


@pytest.mark.parametrize("which", ["fleet", "run_dir"])
def test_trace_export_writes_what_jax_writes(runs, which, tmp_path):
    outs = []
    for parser in (jtrace_cmd.trace_parser, ptrace_cmd.trace_parser):
        path = str(tmp_path / f"{parser.__module__}.json")
        rc, text = _run(parser, ["export", runs[which], "-o", path])
        with open(path) as f:
            outs.append((rc, text.replace(path, "<out>"), json.load(f)))
    # the one difference by design: the process row names its package
    names = [doc["traceEvents"][0]["args"].pop("name") for _, _, doc in outs]
    assert names == ["accelerate_tpu serving", "accelerate_tpu_torch serving"]
    assert outs[0] == outs[1]
    rc, text = _run(ptrace_cmd.trace_parser, ["export", runs["fleet"]])
    assert rc == 0 and json.loads(text)["traceEvents"]


@pytest.mark.parametrize("argv", [["--tail", "4"], ["--format", "json"], []])
@pytest.mark.parametrize("which", ["flight", "small_flight", "empty"])
def test_trace_flight_dump_prints_what_jax_prints(runs, which, argv):
    (jrc, jout), (prc, pout) = _both(["flight-dump", runs[which], *argv])
    assert (prc, pout) == (jrc, jout)


def test_trace_selfcheck_prints_what_jax_prints():
    (jrc, jout), (prc, pout) = _both(["selfcheck"])
    assert prc == jrc == 0 and pout == jout and "[trace selfcheck] OK" in pout


@pytest.mark.parametrize("argv", [["--format", "text"], ["--format", "json"], ["--strict"]])
@pytest.mark.parametrize("which", ["fleet", "steps", "empty"])
def test_telemetry_summarize_prints_what_jax_prints(runs, which, argv):
    (jrc, jout), (prc, pout) = _both(["summarize", runs[which], *argv], j=jtel_cmd.telemetry_parser,
                                     p=ptel_cmd.telemetry_parser)
    assert (prc, pout) == (jrc, jout)
    if which == "steps" and argv == ["--strict"]:
        assert prc == 1  # the shape change is a recompile warning


def test_telemetry_selfcheck_on_cpu_and_refused_without_card(monkeypatch):
    rc, out = _run(ptel_cmd.telemetry_parser, ["selfcheck", "--device", "cpu"])
    assert rc == 0 and "[telemetry selfcheck] OK on cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(ptel_cmd.telemetry_parser, ["selfcheck"])


HANDOFF_CASES = [
    ["--layers", "22", "--kv-heads", "4", "--head-dim", "64", "--tokens", "1280"],
    ["--layers", "22", "--kv-heads", "4", "--head-dim", "64", "--tokens", "1280", "--params", "1.1e9"],
    ["--layers", "2", "--kv-heads", "1", "--head-dim", "16", "--dtype-bytes", "4", "--tokens", "7",
     "--params", "1e12"],
]
FAILOVER_CASES = [
    ["--layers", "22", "--kv-heads", "4", "--head-dim", "64", "--prompt-tokens", "1024", "--generated-tokens",
     "16", "--params", "1.1e9"],
    ["--layers", "22", "--kv-heads", "4", "--head-dim", "64", "--prompt-tokens", "5", "--params", "1e13"],
    ["--layers", "80", "--kv-heads", "8", "--head-dim", "128", "--prompt-tokens", "300", "--generated-tokens",
     "3", "--params", "7e10", "--no-kv"],
]


@pytest.fixture
def jax_h100(monkeypatch):
    """The JAX cost model given the port's H100 rows: its formulas at the
    same bandwidth and peak."""
    bw = pcost.HANDOFF_BW_TABLE["h100"]
    monkeypatch.setitem(jcost.BANDWIDTH_TABLE, "h100", {jcost.ICI: bw, jcost.DCN: bw})
    monkeypatch.setitem(jcost.PEAK_FLOPS_TABLE, "h100", dict(pcost.PEAK_FLOPS_TABLE["h100"]))


@pytest.mark.parametrize("case", range(len(HANDOFF_CASES)))
def test_fleet_price_handoff_follows_jax_formulas(jax_h100, case):
    argv = ["price-handoff", *HANDOFF_CASES[case], "--generation", "h100", "--format", "json"]
    _, jout = _run(jfleet_cmd.fleet_parser, argv)
    rc, pout = _run(pfleet_cmd.fleet_parser, argv)
    got, want = json.loads(pout), json.loads(jout)
    assert rc == 0 and got.pop("transport") == "host round trip" and want.pop("transport") == "ici"
    assert got == want
    rc, sarif = _run(pfleet_cmd.fleet_parser, argv[:-1] + ["sarif"])
    doc = json.loads(sarif)
    [result] = doc["runs"][0]["results"]
    assert rc == 0 and result["ruleId"] == "FLEET001"
    assert result["level"] == ("warning" if got.get("decision") == "local-prefill" else "note")
    rc, text = _run(pfleet_cmd.fleet_parser, argv[:-2])
    assert rc == 0 and f"{got['handoff_bytes']:,} B over the host round trip (h100)" in text


@pytest.mark.parametrize("case", range(len(FAILOVER_CASES)))
def test_fleet_price_failover_follows_jax_formulas(jax_h100, case):
    argv = ["price-failover", *FAILOVER_CASES[case], "--generation", "h100", "--format", "json"]
    _, jout = _run(jfleet_cmd.fleet_parser, argv)
    rc, pout = _run(pfleet_cmd.fleet_parser, argv)
    got, want = json.loads(pout), json.loads(jout)
    assert rc == 0 and got.pop("transport") == "host round trip" and want.pop("transport") == "ici"
    assert got == want
    rc, text = _run(pfleet_cmd.fleet_parser, argv[:-2])
    assert rc == 0 and f"-> router picks: {got['path']}" in text


def test_fleet_demo_on_cpu():
    rc, out = _run(pfleet_cmd.fleet_parser, ["demo", "--device", "cpu", "--requests", "6", "--format", "json"])
    report = json.loads(out)
    assert rc == 0 and report["completed"] == 6 and report["replicas"] == ["r0", "r1"]
    assert report["merged_metrics"]["tokens_generated"] == 48 and report["merged_metrics"]["prefix_hits"] >= 1


def test_cli_registers_the_ported_commands_only():
    parser = cli.cli_parser()
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    assert tuple(sub.choices) == cli.COMMANDS == ("launch", "config", "env", "test", "estimate-memory",
                                                  "kernel-check", "merge-weights", "migrate", "telemetry", "trace",
                                                  "checkpoints", "compile-cache", "fleet", "serve", "tpu-config")
    for argv in (["fleet", "price-handoff", "--layers", "2", "--kv-heads", "1", "--head-dim", "16",
                  "--tokens", "4"], ["trace", "selfcheck"], ["kernel-check", "--selfcheck"],
                 ["compile-cache", "--selfcheck"], ["checkpoints", "verify", "--selfcheck"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ei:
            cli.main(argv)
        assert ei.value.code == 0, out.getvalue()
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit) as ei:
        cli.main(["lint", "."])
    assert ei.value.code == 2


def test_serve_refuses_without_card_and_passes_store_dir(monkeypatch, tmp_path):
    """``serve`` refuses to run without a card unless the CPU is asked for,
    and hands ``--store-dir`` to the supervisor's ProcConfig (the store
    every worker's program cache shares)."""
    import accelerate_tpu_torch.serving_proc as sproc
    from accelerate_tpu_torch.commands.serve import serve_parser

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve_parser().parse_args(["--run-dir", str(tmp_path), "--http-port", "0"])
    assert args.device == "cuda"
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="no CUDA device"):
        args.func(args)
    seen = []
    monkeypatch.setattr(sproc, "serve", lambda config, **kw: seen.append(config) or 0)
    args = serve_parser().parse_args(["--run-dir", str(tmp_path), "--device", "cpu", "--store-dir", str(tmp_path)])
    with contextlib.redirect_stdout(io.StringIO()):
        assert args.func(args) == 0
    assert seen[0].store_dir == str(tmp_path) and seen[0].device == "cpu"
