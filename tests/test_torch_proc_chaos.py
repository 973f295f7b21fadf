"""Process chaos on the port's multi-process fleet (CPU workers, the JAX
package's tiny Llama): a SIGSTOPped worker goes degraded, then
quarantined, is SIGKILLed and respawns with 0 builds while its requests
finish on the survivor; with ``shadow_kv`` a killed dense worker's
requests fail over by KV, the moved bytes equal the predicted ones, and
the streams are bit-equal to a run with no fault; a drained worker's
requests move with their rows."""

import json
import os
import signal

import numpy as np
import pytest

from torch_proc_harness import (
    ENGINE,
    assert_matches,
    boot,
    drive_all,
    jax_reference,
    make_weights,
    prompts,
    proc_config,
    pump_until,
)

STOPPED = prompts(6, seed=4)
SHADOWED = prompts(6, seed=5, lo=4, hi=8)
NEW = 24


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return make_weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def reference(weights):
    stopped, shadowed = jax_reference(weights[0], (STOPPED, 16), (SHADOWED, NEW))
    return {"stopped": stopped, "shadowed": shadowed}


def _events(run_dir, name="supervisor"):
    with open(os.path.join(str(run_dir), f"events_{name}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_proc_sigstop_quarantines_and_respawns(weights, reference, tmp_path):
    """w1 stops itself at its fourth decode tick (each forward sleeps a few
    milliseconds, so every submit lands first): two heartbeat timeouts
    take it degraded, then quarantined and SIGKILLed; its requests finish
    on w0 with the JAX engine's tokens; the slot respawns with 0 builds."""
    cfg = proc_config(tmp_path, weights, heartbeat_timeout_s=1.0, quarantine_after_timeouts=2, delay_s=0.005,
                      chaos={"worker": "w1", "label": "mid_decode", "action": "sigstop", "hits": 4})
    sup = boot(cfg)
    try:
        fids = [sup.submit(p, max_new_tokens=16) for p in STOPPED]
        outs, lost = drive_all(sup, fids)
        assert not lost and len(outs) == 6
        assert_matches(outs, fids, reference["stopped"])
        pump_until(sup, lambda: sup.health().get("w1.1", {}).get("health") == "healthy", 60, "respawn to hello")
        assert sup.worker_stats()["w1.1"]["hello"]["compiles"] == 0
        assert sup.failover_accounting()["failovers"] >= 1 and sup.summary()["respawns_total"] == 1
    finally:
        sup.shutdown()
    states = [(e["worker"], e["state"]) for e in _events(tmp_path) if e["name"] == "proc_health"]
    w1 = [s for w, s in states if w == "w1"]
    assert w1[-2:] == ["degraded", "quarantined"], states
    assert ("w1.1", "healthy") in states
    # the stopped process was SIGKILLed (its exit is observed after the slot took its next name)
    exits = [e for e in _events(tmp_path) if e["name"] == "proc_exit" and e.get("after") == "quarantine"]
    assert [e["returncode"] for e in exits] == [-signal.SIGKILL]


def test_proc_shadow_kv_bytes_predicted_equal_moved(weights, reference, tmp_path):
    """Dense workers with shadow_kv: kill w1 (SIGKILL from outside) once its
    polled snapshots carry rows; its decoding requests fail over by KV
    with moved bytes == predicted and are bit-equal to a no-fault run of
    the same fleet; the rest recompute, within 1e-5; all equal the JAX
    engine's tokens."""
    runs = {}
    for name in ("clean", "killed"):
        run_dir = tmp_path / name
        sup = boot(proc_config(run_dir, weights, engine=ENGINE, shadow_kv=True, delay_s=0.004, max_respawns=0))
        try:
            fids = [sup.submit(p, max_new_tokens=NEW) for p in SHADOWED]
            if name == "killed":
                slot = sup._slots[1]

                def rows_polled():
                    shadow = slot["shadow"]
                    return shadow is not None and sum(m["has_kv"] and m["generated"] >= 2 for m in shadow[0]) == 2

                pump_until(sup, rows_polled, 30, "w1's snapshots carry rows")
                os.kill(slot["proc"].pid, signal.SIGKILL)
            outs, lost = drive_all(sup, fids)
            assert not lost
            runs[name] = ([outs[f] for f in fids], sup.failover_accounting())
        finally:
            sup.shutdown()
    (clean, clean_acct), (killed, acct) = runs["clean"], runs["killed"]
    assert clean_acct["failovers"] == 0
    assert acct["failovers_kv"] == 2 and acct["failovers_lost"] == 0
    assert acct["bytes_moved"] == acct["bytes_predicted"] > 0
    moved = [e for e in _events(tmp_path / "killed") if e["name"] == "proc_failover"]
    by_kv = {e["fuid"] for e in moved if e["kv"]}
    assert len(by_kv) == 2 and all(e["moved_bytes"] == e["predicted_bytes"] for e in moved if e["kv"])
    for i, ((got, got_lps), (want, want_lps)) in enumerate(zip(killed, clean)):
        np.testing.assert_array_equal(got, want)
        if i in by_kv:  # fuids are 0..5 in submission order
            np.testing.assert_array_equal(got_lps, want_lps)
        else:
            np.testing.assert_allclose(got_lps, want_lps, atol=1e-5, rtol=0)
    assert_matches(dict(enumerate(clean)), range(6), reference["shadowed"])


def test_proc_drain_worker_migrates(weights, reference, tmp_path):
    """Planned maintenance: drain_worker exports w1's whole in-flight state
    (rows included, dense layout), migrates it to w0 and shuts w1 down;
    every request still completes with the JAX engine's tokens, the moved
    bytes equal to the predicted ones."""
    sup = boot(proc_config(tmp_path, weights, engine=ENGINE, delay_s=0.004, max_respawns=0))
    try:
        fids = [sup.submit(p, max_new_tokens=NEW) for p in SHADOWED]
        pump_until(sup, lambda: any(len(sup.partial(f)) >= 2 for f in fids[1::2]), 30, "w1 decoding")
        res = sup.drain_worker("w1")
        assert res["migrated"] >= 1 and sup.health()["w1"]["health"] == "dead"
        outs, lost = drive_all(sup, fids)
        assert not lost
        acct = sup.failover_accounting()
        assert acct["failovers_kv"] >= 1 and acct["bytes_moved"] == acct["bytes_predicted"] > 0
        assert_matches(outs, fids, reference["shadowed"])
    finally:
        sup.shutdown()
