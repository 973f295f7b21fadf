"""The port's multi-process serving fleet (serving_proc.py) with real
engine-worker processes on the CPU, on a tiny Llama whose weights are the
JAX package's (``models/convert.py``): greedy tokens of two workers equal
the JAX ``ServingEngine``'s on the same prompts (logprobs within 1e-5,
f32); a worker SIGKILLed mid-decode fails over to the survivor with the
same tokens, greedy and sampled; a sole worker's death loses its requests
with a reason, never strands them. The worker's device check and the
supervisor's counts and run dir are covered on the way."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import accelerate_tpu_torch.commands.trace as ptrace_cmd
from accelerate_tpu_torch.serving_proc import FleetRequestError
from accelerate_tpu_torch.telemetry.trace import traces_from_events
from torch_proc_harness import (
    PAGED,
    REPO,
    WORKER_ENV,
    assert_matches,
    boot,
    drive_all,
    jax_reference,
    make_weights,
    prompts,
    proc_config,
    pump_until,
)


GREEDY = prompts(6)
# the kill comes at the fourth decode tick, and each forward sleeps a few
# milliseconds: every submit reaches its worker before the kill
KILL_W1 = {"worker": "w1", "label": "mid_decode", "action": "sigkill", "hits": 4}
DELAY_S = 0.005
KILLED = prompts(6, seed=1)
SAMPLED = prompts(6, seed=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return make_weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine's greedy runs of the three prompt sets."""
    greedy, killed, sampled = jax_reference(weights[0], (GREEDY, 8), (KILLED, 16), (SAMPLED, 16))
    return {"greedy": greedy, "killed": killed, "sampled": sampled}


def test_proc_greedy_matches_jax_engine(weights, reference, tmp_path):
    """Two paged workers serve six prompts: tokens equal the JAX engine's,
    logprobs within 1e-5; both workers served (decode steps counted since
    reset_counts), built nothing, and the merged run dir gives one finished
    trace a request."""
    sup = boot(proc_config(tmp_path, weights))
    try:
        hellos = {n: s["hello"] for n, s in sup.worker_stats().items()}
        assert set(hellos) == {"w0", "w1"}
        assert all(h["nvcc_builds"] == 0 and h["device"] == "cpu" and h["num_hidden_layers"] == 2
                   for h in hellos.values())
        sup.reset_counts()
        fids = [sup.submit(p, max_new_tokens=8) for p in GREEDY]
        outs, lost = drive_all(sup, fids)
        assert not lost
        assert_matches(outs, fids, reference["greedy"])
        pump_until(sup, lambda: all((s.get("decode_steps") or 0) > 0 for s in sup.worker_stats().values()), 10,
                   "both workers report decode steps")
        stats = sup.worker_stats()
        # K4 is the card's: on the CPU the wrappers run their plain versions and count nothing
        assert all(s["launches"] == {"paged_decode_attention": 0, "int4_matmul": 0} for s in stats.values())
        assert all(s["timing"]["ticks"] > 0 and s["spinup_s"] > 0 for s in stats.values())
        assert sup.summary()["done"] == 6 and sup.failover_accounting()["failovers"] == 0
    finally:
        sup.shutdown()
    traces = traces_from_events(ptrace_cmd._load_events(str(tmp_path)))
    assert len(traces) == 6 and all(t["status"] == "ok" for t in traces)


def test_proc_sigkill_failover_completes_on_survivor(weights, reference, tmp_path):
    """SIGKILL a worker process at its fourth decode tick: its requests
    finish on the survivor with the JAX engine's tokens, none lost; the
    slot respawns as w1.1 with 0 builds; the flight dump holds the kill."""
    cfg = proc_config(tmp_path, weights, delay_s=DELAY_S, chaos=KILL_W1)
    sup = boot(cfg)
    try:
        fids = [sup.submit(p, max_new_tokens=16) for p in KILLED]
        outs, lost = drive_all(sup, fids)
        assert not lost and len(outs) == 6
        acct = sup.failover_accounting()
        assert acct["failovers"] >= 1 and acct["failovers_lost"] == 0 and acct["bytes_moved"] == 0
        assert_matches(outs, fids, reference["killed"])
        pump_until(sup, lambda: sup.health().get("w1.1", {}).get("health") == "healthy", 60, "respawn to hello")
        assert sup.worker_stats()["w1.1"]["hello"]["compiles"] == 0
        dump = json.load(open(os.path.join(str(tmp_path), "flight_w1.json")))
        assert any(e.get("name") == "proc_exit" and e.get("killed") for e in dump["events"])
    finally:
        sup.shutdown()


def test_proc_sampled_sigkill_equals_no_fault(weights, reference, tmp_path):
    """Sampled streams (temperature 0.8, top-k 20) carry their generator's
    state across a SIGKILL failover: each request's tokens equal a no-fault
    run of the same fleet, logprobs within 1e-5."""
    engine = dict(PAGED, temperature=0.8, top_k=20)
    runs = []
    for name, chaos in (("clean", None), ("chaos", KILL_W1)):
        sup = boot(proc_config(tmp_path / name, weights, engine=engine, chaos=chaos, seed=7, max_respawns=0,
                               delay_s=DELAY_S))
        try:
            fids = [sup.submit(p, max_new_tokens=16) for p in SAMPLED]
            outs, lost = drive_all(sup, fids)
            assert not lost
            runs.append([outs[f] for f in fids])
            acct = sup.failover_accounting()
            assert (acct["failovers"] >= 1) == (chaos is not None) and acct["failovers_lost"] == 0
        finally:
            sup.shutdown()
    clean, chaos = runs
    # sampling is on: the streams are not the greedy ones
    assert any(not np.array_equal(t, g) for (t, _), (g, _) in zip(clean, reference["sampled"]))
    for (got, got_lps), (want, want_lps) in zip(chaos, clean):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got_lps, want_lps, atol=1e-5, rtol=0)


def test_proc_sole_worker_death_lost_not_stranded(weights, tmp_path):
    """The only worker dies with no respawn budget: its requests surface
    as lost with a reason (never a hang), counted; a new submit sheds."""
    cfg = proc_config(tmp_path, weights, workers=1, max_respawns=0, delay_s=DELAY_S,
                      chaos=dict(KILL_W1, worker="w0"))
    sup = boot(cfg)
    try:
        fids = [sup.submit(p, max_new_tokens=16) for p in prompts(3, seed=3)]
        outs, lost = drive_all(sup, fids)
        assert lost and len(outs) + len(lost) == 3
        assert all("no routable survivor after crash" in reason for reason in lost.values())
        assert sup.summary()["lost"] == len(lost) == sup.failover_accounting()["failovers_lost"]
        assert sup._slots[0]["gave_up"] and sup.health()["w0"]["health"] == "dead"
        fid = sup.submit([1, 2, 3], max_new_tokens=4)
        pump_until(sup, lambda: sup.request_state(fid) in ("shed", "lost"), 10, "the submit sheds")
        with pytest.raises(FleetRequestError, match="shed"):
            sup.poll(fid)
    finally:
        sup.shutdown()


def test_worker_without_card_exits_nonzero(weights, tmp_path):
    """A worker asked for the card on a machine without one exits non-zero
    with the reason in its log, before building anything."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "w0", "slot": 0, "port": 1, "token": "t", "run_dir": str(tmp_path),
                                "device": "cuda", "model_spec": "torch_proc_factory:llama_from_file",
                                "model_kwargs": {"path": weights[1], "config": weights[2]}}))
    env = dict(os.environ, **WORKER_ENV, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.serving_proc", "--worker", str(spec)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr
    assert "worker w0: no CUDA device is available" in proc.stderr
    assert not (tmp_path / "events_w0.jsonl").exists()
