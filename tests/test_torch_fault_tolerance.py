"""The port's fault tolerance (accelerate_tpu_torch.ft, the atomic commit
of checkpointing.py, utils/retry.py), mirroring
tests/test_fault_tolerance.py on a tiny Llama in place of the regression
model: the crash-at-every-point matrix over the save and restore paths,
integrity checks, auto-resume, async-save failure, preemption, retries;
then the pure functions (crash labels, backoff, topology) held to the JAX
package's outputs on the same inputs. The invariant: after a crash at any
labeled point, ``load_state()`` auto-resume restores a bit-exact valid
state (step, parameters, optimizer state, sampler position, RNG) from the
newest committed checkpoint, and no path deletes the last valid
checkpoint before a new one commits. All on the CPU."""

import json
import logging
import os
import random
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu.ft as jft
from accelerate_tpu.utils.retry import backoff_delays as jax_backoff_delays
from accelerate_tpu_torch import Accelerator, LlamaConfig, ProjectConfiguration, causal_lm_loss, create_llama_model
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.ft import (
    ALL_CRASH_POINTS,
    CRASH_POINTS,
    RESTORE_CRASH_POINTS,
    CheckpointManager,
    PreemptionHandler,
    build_manifest,
    compare_topology,
    derive_rng_state,
    read_manifest,
    redistribute_sampler_state,
    verify_manifest,
    write_manifest,
)
from accelerate_tpu_torch.ft.crashpoints import SERVING_CRASH_POINTS
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils import CrashPoint, SimulatedCrash, corrupt_file
from accelerate_tpu_torch.utils import FaultToleranceKwargs
from accelerate_tpu_torch.utils.retry import backoff_delays, retry, retry_call

torch.set_num_threads(2)

SEQ = 8
BATCH = {"input_ids": torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, SEQ)))}


def _reset():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    _reset()
    yield
    _reset()


class Rows:
    def __init__(self, n=64):
        self.ids = np.random.default_rng(11).integers(0, 256, (n, SEQ))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


def _fresh(project_dir, total_limit=None, with_loader=False, **acc_kwargs):
    """A 'new process': reset the singletons and build a tiny Llama with
    AdamW, its step and (optionally) a shuffled loader, under automatic
    checkpoint naming."""
    _reset()
    acc = Accelerator(
        cpu=True,
        project_config=ProjectConfiguration(
            project_dir=str(project_dir), automatic_checkpoint_naming=True, total_limit=total_limit
        ),
        **acc_kwargs,
    )
    model = acc.prepare_model(create_llama_model(LlamaConfig.tiny(), seed=0, device="cpu"))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=1e-2))
    loader = acc.prepare_data_loader(Rows(), batch_size=8, shuffle=True, seed=3) if with_loader else None
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    return acc, model, step, loader


def _next_draws(np_state, torch_state):
    """The next numpy and torch draws a process restored to these states
    will produce."""
    rs = np.random.RandomState()
    rs.set_state(np_state)
    gen = torch.Generator().set_state(torch_state)
    return float(rs.rand()), float(torch.rand((), generator=gen))


def _snapshot(acc, model):
    opt = acc._optimizers[-1].optimizer
    return {
        "params": {k: v.clone() for k, v in model.state_dict().items()},
        "opt": [{k: v.clone() for k, v in s.items()} for s in opt.state.values()],
        "step": acc.step,
        "draws": _next_draws(np.random.get_state(), torch.get_rng_state()),
    }


def _assert_restored(acc, model, want):
    for k, v in model.state_dict().items():
        assert torch.equal(v, want["params"][k]), k
    opt = acc._optimizers[-1].optimizer
    for got, exp in zip(opt.state.values(), want["opt"], strict=True):
        for k in exp:
            assert torch.equal(got[k], exp[k]), k
    assert acc.step == want["step"]
    # the RNGs come back bit-exactly: the next draws are the saved process's
    assert (float(np.random.rand()), float(torch.rand(()))) == want["draws"]


# --------------------------------------------------------------------------- #
# the crash matrix
# --------------------------------------------------------------------------- #

# which checkpoint auto-resume must land on after a crash at each point:
# before the manifest exists the save never committed -> the OLD checkpoint;
# from pre_rename on, the manifest IS written (commit point) -> the NEW
# state (gc finishes the rename) -- the JAX package's table
EXPECT_SOURCE = {
    "pre_write": "old",
    "mid_pytree": "old",
    "pre_manifest": "old",
    "pre_rename": "new",
    "mid_prune": "new",
}


def test_crash_labels_are_the_jax_packages():
    assert CRASH_POINTS == jft.CRASH_POINTS
    assert RESTORE_CRASH_POINTS == jft.RESTORE_CRASH_POINTS
    assert SERVING_CRASH_POINTS == jft.crashpoints.SERVING_CRASH_POINTS
    assert ALL_CRASH_POINTS == jft.ALL_CRASH_POINTS
    assert set(EXPECT_SOURCE) == set(CRASH_POINTS) == set(jft.CRASH_POINTS)


@pytest.mark.parametrize("label", CRASH_POINTS)
def test_crash_at_every_point_resumes_on_valid_checkpoint(tmp_path, label):
    # mid_prune only fires when pruning has victims: give it a total_limit
    total_limit = 2 if label == "mid_prune" else None
    acc, model, step, loader = _fresh(tmp_path, total_limit=total_limit, with_loader=True)

    # deliver 2 batches mid-epoch, train, take one GOOD checkpoint
    it = iter(loader)
    next(it), next(it)
    step(BATCH)
    step(BATCH)
    acc.save_state()
    old = _snapshot(acc, model)

    if label == "mid_prune":
        step(BATCH)  # pruning needs existing checkpoints beyond the limit
        acc.save_state()

    # train further, then the save CRASHES at `label`
    step(BATCH)
    next(it)  # 3 batches delivered now
    new = _snapshot(acc, model)
    with CrashPoint(label) as cp:
        with pytest.raises(SimulatedCrash):
            acc.save_state()
    assert cp.fired, f"crash point {label} was never reached"
    del it

    # ---- 'new process': auto-resume must land on the newest VALID state ----
    acc2, model2, step2, loader2 = _fresh(tmp_path, total_limit=total_limit, with_loader=True)
    acc2.load_state()
    _assert_restored(acc2, model2, new if EXPECT_SOURCE[label] == "new" else old)
    assert loader2.skip_batches == (3 if EXPECT_SOURCE[label] == "new" else 2)

    # no .tmp garbage survives resume, and training + saving continue
    mgr = CheckpointManager(tmp_path / "checkpoints")
    assert mgr.tmp_dirs() == []
    step2(BATCH)
    committed_before = {p.name for p in mgr.all_valid(deep=True)}
    assert committed_before, "resume must leave at least one valid checkpoint"
    out = acc2.save_state()
    assert mgr.verify(out).ok
    assert os.path.basename(out) not in committed_before, "the next save goes to a fresh index"


def test_crash_save_never_deletes_last_valid_checkpoint(tmp_path):
    acc, model, step, _ = _fresh(tmp_path, total_limit=1)
    step(BATCH)
    acc.save_state()  # checkpoint_0
    mgr = CheckpointManager(tmp_path / "checkpoints")
    assert [p.name for p in mgr.all_valid(deep=True)] == ["checkpoint_0"]
    step(BATCH)
    for label in ("pre_write", "mid_pytree", "pre_manifest"):
        with CrashPoint(label):
            with pytest.raises(SimulatedCrash):
                acc.save_state()
        assert mgr.verify(tmp_path / "checkpoints" / "checkpoint_0").ok, label
    out = acc.save_state()  # an uninterrupted save finally prunes it, post-commit
    names = {p.name for p in mgr.all_valid(deep=True)}
    assert os.path.basename(out) in names and "checkpoint_0" not in names


def test_prune_protects_resume_source(tmp_path):
    acc, model, step, _ = _fresh(tmp_path, total_limit=1)
    step(BATCH)
    acc.save_state()  # checkpoint_0
    acc2, model2, step2, _ = _fresh(tmp_path, total_limit=1)
    assert os.path.basename(acc2.load_state()) == "checkpoint_0"
    step2(BATCH)
    acc2.save_state()  # checkpoint_1; limit=1 would normally remove checkpoint_0
    names = {p.name for p in CheckpointManager(tmp_path / "checkpoints").all_valid(deep=True)}
    assert names == {"checkpoint_0", "checkpoint_1"}


def test_iteration_restored_on_resume(tmp_path):
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    acc.save_state()
    want = _snapshot(acc, model)
    acc2, model2, step2, _ = _fresh(tmp_path)
    acc2.load_state()
    assert acc2.project_configuration.iteration == 1
    step2(BATCH)
    acc2.save_state()
    base = tmp_path / "checkpoints"
    assert (base / "checkpoint_1").is_dir(), "resumed save must continue the numbering"
    acc3, model3, _, _ = _fresh(tmp_path)
    acc3.load_state(str(base / "checkpoint_0"))  # untouched
    for k, v in model3.state_dict().items():
        assert torch.equal(v, want["params"][k]), k
    assert acc3.project_configuration.iteration == 1  # an explicit load restores the counter too


# --------------------------------------------------------------------------- #
# corruption / truncation detection
# --------------------------------------------------------------------------- #

def test_auto_resume_walks_back_past_corrupt_checkpoint(tmp_path):
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    acc.save_state()  # checkpoint_0 (good)
    want = _snapshot(acc, model)
    step(BATCH)
    acc.save_state()  # checkpoint_1 (to be corrupted)
    base = tmp_path / "checkpoints"
    corrupt_file(base / "checkpoint_1" / "accelerate_state.json", mode="garbage")
    res = CheckpointManager(base).verify(base / "checkpoint_1")
    assert not res.ok and any("crc32" in p for p in res.problems)
    acc2, model2, _, _ = _fresh(tmp_path)
    assert os.path.basename(acc2.load_state()) == "checkpoint_0"
    for k, v in model2.state_dict().items():
        assert torch.equal(v, want["params"][k]), k


@pytest.mark.parametrize("mode,which", [
    ("truncate", "model/model.safetensors"), ("delete", "model/model.safetensors"),
    ("truncate", "optimizer/optimizer.bin"), ("delete", "optimizer/optimizer.bin"),
    ("garbage", "accelerate_state.json"), ("garbage", "rng_state_0.pkl"), ("truncate", "samplers.json"),
])
def test_verify_detects_damaged_files(tmp_path, mode, which):
    """Array files carry their sizes in the manifest, control files their
    sizes and crc32s: every corrupt_file mode is caught where it can be."""
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    out = acc.save_state()
    mgr = CheckpointManager(tmp_path / "checkpoints")
    assert mgr.verify(out).ok
    manifest = read_manifest(out)
    assert which in manifest["pytree_files"] or "crc32" in manifest["files"][which]
    corrupt_file(os.path.join(out, which), mode=mode)
    res = mgr.verify(out)
    assert not res.ok and any(which in p for p in res.problems)
    assert mgr.latest(deep=True) is None  # nothing valid left to resume from
    acc2, _, _, _ = _fresh(tmp_path)
    with pytest.raises(FileNotFoundError):
        acc2.load_state()


def test_uncommitted_checkpoint_is_invisible(tmp_path):
    base = tmp_path / "checkpoints"
    (base / "checkpoint_0").mkdir(parents=True)
    (base / "checkpoint_0" / "accelerate_state.json").write_text(json.dumps({"step": 3}))
    mgr = CheckpointManager(base)
    assert mgr.all_checkpoints() != []
    assert mgr.all_valid() == [] and mgr.latest() is None
    assert any("no commit manifest" in p for p in verify_manifest(base / "checkpoint_0"))


def test_truncated_manifest_means_uncommitted(tmp_path):
    d = tmp_path / "checkpoint_0"
    d.mkdir()
    (d / "data.json").write_text("{}")
    write_manifest(d, build_manifest(d, step=1, iteration=0))
    assert verify_manifest(d) == []
    corrupt_file(d / "commit_success.json", mode="truncate", nbytes=8)
    assert read_manifest(d) is None
    assert verify_manifest(d) != []


def test_gc_finishes_a_committed_rename_and_removes_partial_dirs(tmp_path):
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    with CrashPoint("pre_rename"):
        with pytest.raises(SimulatedCrash):
            acc.save_state()  # checkpoint_0.tmp, committed
    mgr = CheckpointManager(tmp_path / "checkpoints")
    assert mgr.all_checkpoints() == [] and [p.name for p in mgr.tmp_dirs()] == ["checkpoint_0.tmp"]
    assert mgr.gc(dry_run=True) == {"recovered": ["checkpoint_0.tmp"], "removed": []}
    step(BATCH)
    with CrashPoint("pre_manifest"):
        with pytest.raises(SimulatedCrash):
            acc.save_state()  # its own gc finished checkpoint_0's rename; checkpoint_1.tmp is not committed
    assert [p.name for p in mgr.all_valid(deep=True)] == ["checkpoint_0"]
    assert mgr.gc(dry_run=True) == {"recovered": [], "removed": ["checkpoint_1.tmp"]}
    mgr.gc()
    assert mgr.tmp_dirs() == [] and [p.name for p in mgr.all_valid(deep=True)] == ["checkpoint_0"]


# --------------------------------------------------------------------------- #
# async saves
# --------------------------------------------------------------------------- #

def test_failed_async_save_never_looks_committed(tmp_path, monkeypatch):
    """A write that fails on the writer thread aborts the commit, removes
    the partial directory and raises from wait_for_checkpoint()."""
    acc, model, step, _ = _fresh(tmp_path, kwargs_handlers=[FaultToleranceKwargs(handle_preemption=False,
                                                                                 io_retries=1)])
    step(BATCH)
    acc.save_state()  # checkpoint_0, good
    step(BATCH)
    real = checkpointing.torch.save

    def failing(obj, path):
        real(obj, path)  # let the real write land...
        raise OSError("simulated filer failure")  # ...then report failure

    monkeypatch.setattr(checkpointing.torch, "save", failing)
    acc.save_state(async_save=True)  # checkpoint_1 in flight
    assert len(checkpointing._PENDING_ASYNC) == 1
    assert checkpointing._PENDING_ASYNC[0].thread.name == "checkpoint-writer"
    with pytest.raises(OSError, match="simulated filer failure"):
        acc.wait_for_checkpoint()
    monkeypatch.undo()

    base = tmp_path / "checkpoints"
    mgr = CheckpointManager(base)
    assert not (base / "checkpoint_1").exists(), "failed save must not be committed"
    assert mgr.tmp_dirs() == [], "failed save's partial dir must be removed"
    assert [p.name for p in mgr.all_valid(deep=True)] == ["checkpoint_0"]
    assert checkpointing._PENDING_ASYNC == []
    out = acc.save_state()  # a later save still works
    assert mgr.verify(out).ok


def test_async_save_commits_manifest_on_drain(tmp_path):
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    out = acc.save_state(async_save=True)
    base = tmp_path / "checkpoints"
    acc.wait_for_checkpoint()
    assert (base / "checkpoint_0").is_dir()
    res = CheckpointManager(base).verify(out)
    assert res.ok, res.problems
    assert res.manifest["step"] == acc.step


# --------------------------------------------------------------------------- #
# preemption
# --------------------------------------------------------------------------- #

def test_preemption_handler_latches_flag():
    handler = PreemptionHandler(signals=("SIGTERM",))
    try:
        assert handler.install()
        assert not handler.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.preempted and handler.received == "SIGTERM"
    finally:
        handler.uninstall()


def test_accelerator_preemption_checkpoint_and_stop(tmp_path):
    acc, model, step, _ = _fresh(tmp_path, kwargs_handlers=[FaultToleranceKwargs(preemption_signals=("SIGTERM",))])
    try:
        assert acc.preemption_handler is not None and acc.preemption_handler.installed
        assert not acc.should_stop and not acc.should_checkpoint
        step(BATCH)
        os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
        assert acc.preempted and acc.should_checkpoint and acc.should_stop
        out = acc.save_state(async_save=True)  # async demoted to sync under preemption
        assert checkpointing._PENDING_ASYNC == [], "preempted save must be synchronous"
        assert CheckpointManager(tmp_path / "checkpoints").verify(out).ok
        assert not acc.should_checkpoint, "final checkpoint taken exactly once"
        assert acc.should_stop
    finally:
        acc.preemption_handler.uninstall()


def test_accelerator_without_ft_handler_installs_nothing():
    acc = Accelerator(cpu=True)
    assert acc.preemption_handler is None
    assert not acc.should_stop and not acc.should_checkpoint and acc.checkpoint_manager is None


def test_fault_tolerance_kwargs_validate_like_jax():
    from accelerate_tpu.utils.dataclasses import FaultToleranceKwargs as JaxFaultToleranceKwargs

    assert FaultToleranceKwargs().to_dict() == JaxFaultToleranceKwargs().to_dict()
    for bad in ({"io_retries": 0}, {"tracker_retries": 0}, {"retry_base_delay": -1.0},
                {"retry_base_delay": 2.0, "retry_max_delay": 1.0}):
        with pytest.raises(ValueError):
            FaultToleranceKwargs(**bad)
        with pytest.raises(ValueError):
            JaxFaultToleranceKwargs(**bad)


# --------------------------------------------------------------------------- #
# retry
# --------------------------------------------------------------------------- #

def test_retry_succeeds_after_transient_failures():
    sleeps, calls = [], []

    @retry(attempts=4, base_delay=0.01, sleep=sleeps.append)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert flaky() == "ok"
    assert len(calls) == 3 and len(sleeps) == 2


def test_retry_gives_up_and_reports():
    events = []
    with pytest.raises(OSError):
        retry_call(
            lambda: (_ for _ in ()).throw(OSError("dead")),
            attempts=3,
            base_delay=0.01,
            sleep=lambda s: None,
            on_retry=lambda a, d, e: events.append(("retry", a)),
            on_giveup=lambda a, e: events.append(("giveup", a)),
        )
    assert events == [("retry", 1), ("retry", 2), ("giveup", 3)]


def test_retry_does_not_catch_simulated_crash():
    def boom():
        raise SimulatedCrash("not retryable")

    with pytest.raises(SimulatedCrash):
        retry_call(boom, attempts=5, sleep=lambda s: None)


def test_backoff_delays_grow_and_cap():
    assert list(backoff_delays(5, base_delay=1.0, max_delay=4.0, jitter=0.0, rng=lambda: 0.0)) == [1.0, 2.0, 4.0, 4.0]
    assert list(backoff_delays(3, base_delay=1.0, max_delay=9.0, jitter=0.5, rng=lambda: 1.0)) == [1.5, 3.0]


@pytest.mark.parametrize("attempts,base,cap,jitter", [(6, 0.1, 5.0, 0.5), (9, 0.25, 2.0, 1.0), (1, 1.0, 1.0, 0.5)])
def test_backoff_delays_equal_jax_for_the_same_rng(attempts, base, cap, jitter):
    got = list(backoff_delays(attempts, base, cap, jitter, rng=random.Random(5).random))
    want = list(jax_backoff_delays(attempts, base, cap, jitter, rng=random.Random(5).random))
    assert got == want and len(got) == attempts - 1


# --------------------------------------------------------------------------- #
# topology
# --------------------------------------------------------------------------- #

TOPOLOGY_PAIRS = {
    "identical": ({"process_count": 2, "mesh_shape": {"data": 4, "tensor": 1}, "dcn_axes": [],
                   "data_parallel_degree": 4}, {"mesh_shape": {"data": 4}}),
    "mesh": ({"process_count": 1, "mesh_shape": {"data": 4}, "dcn_axes": [], "data_parallel_degree": 4},
             {"mesh_shape": {"data": 8}, "data_parallel_degree": 8}),
    "processes": ({"process_count": 2, "mesh_shape": {"data": 4}, "dcn_axes": [], "data_parallel_degree": 4},
                  {"process_count": 4}),
    "dcn": ({"process_count": 1, "mesh_shape": {"data": 2, "fsdp": 2}, "dcn_axes": ["fsdp"],
             "data_parallel_degree": 4}, {"dcn_axes": []}),
    "v1": (None, {}),
}


@pytest.mark.parametrize("case", list(TOPOLOGY_PAIRS))
def test_compare_topology_tiers_equal_jax(case):
    saved, change = TOPOLOGY_PAIRS[case]
    live = {**(saved or {"process_count": 1, "mesh_shape": {}, "dcn_axes": [], "data_parallel_degree": 1}), **change}
    got, want = compare_topology(saved, live), jft.compare_topology(saved, live)
    assert (got.status, got.changes, got.is_elastic) == (want.status, want.changes, want.is_elastic)
    assert got.describe() == want.describe()
    assert got.status == {"identical": "identical", "v1": "unknown"}.get(case, "elastic")


@pytest.mark.parametrize("seed,index,step", [(42, 0, 10), (42, 1, 10), (43, 0, 10), (42, 0, 11), (None, 3, 0)])
def test_derive_rng_state_equals_jax(seed, index, step):
    got = derive_rng_state(seed, process_index=index, step=step)
    assert got == jft.derive_rng_state(seed, process_index=index, step=step)
    assert got == derive_rng_state(seed, process_index=index, step=step)


def test_applying_a_derived_rng_state_is_reproducible_and_keeps_the_seed(monkeypatch):
    import accelerate_tpu.utils.random as jax_random
    from accelerate_tpu.ft.topology import apply_derived_rng_state as jax_apply
    from accelerate_tpu.utils.random import get_seed as jax_get_seed

    import accelerate_tpu_torch.utils.random as port_random
    from accelerate_tpu_torch.ft.topology import apply_derived_rng_state
    from accelerate_tpu_torch.utils.random import get_seed

    for module in (jax_random, port_random):  # the recorded seeds go back as they were after the test
        monkeypatch.setattr(module, "_GLOBAL_SEED", module._GLOBAL_SEED)

    derived = derive_rng_state(42, process_index=1, step=7)
    draws = []
    for _ in range(2):
        apply_derived_rng_state(derived)
        draws.append((random.random(), float(np.random.rand()), float(torch.rand(()))))
    assert draws[0] == draws[1] and get_seed() == 42
    jax_apply(derived)  # python and numpy as the JAX package seeds them
    assert (random.random(), float(np.random.rand())) == draws[0][:2] and jax_get_seed() == 42


@pytest.mark.parametrize("state,new_gb", [
    ({"batches_yielded": 6, "global_batch_size": 8, "sampler_seed": 3}, 16),
    ({"batches_yielded": 6, "global_batch_size": 8, "sampler_seed": 3}, 32),
    ({"batches_yielded": 6, "global_batch_size": 8}, 8),
    ({"batches_yielded": 2}, 16),
    ({"batches_yielded": 5, "global_batch_size": 12}, None),
])
def test_redistribute_sampler_state_equals_jax(state, new_gb):
    assert redistribute_sampler_state(state, new_gb) == jft.redistribute_sampler_state(state, new_gb)


def test_redistribute_sampler_state_math():
    s = {"batches_yielded": 6, "global_batch_size": 8, "sampler_seed": 3}
    out, replayed = redistribute_sampler_state(s, 16)
    assert out["batches_yielded"] == 3 and replayed == 0
    out, replayed = redistribute_sampler_state(s, 32)
    assert out["batches_yielded"] == 1 and replayed == 16  # rounds DOWN: replay, never skip
    assert out["sampler_seed"] == 3


def test_elastic_delta_raises_and_restores_nothing(tmp_path):
    """A checkpoint whose topology names two processes (as one written by
    a multi-process run would) is refused before anything is restored."""
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    out = acc.save_state()
    manifest = read_manifest(out)
    manifest["topology"]["process_count"] = 2
    manifest["topology"]["mesh_shape"]["data"] = 2
    write_manifest(out, manifest)
    assert verify_manifest(out, deep=True) == []

    acc2, model2, step2, _ = _fresh(tmp_path)
    before = {k: v.clone() for k, v in model2.state_dict().items()}
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        acc2.load_state()
    for k, v in model2.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert acc2.step == 0 and acc2._optimizers[-1].optimizer.state == {}


# --------------------------------------------------------------------------- #
# restore-side fault injection
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("label", RESTORE_CRASH_POINTS)
def test_crash_at_every_restore_point_leaves_checkpoint_valid(tmp_path, label):
    acc, model, step, loader = _fresh(tmp_path, with_loader=True)
    step(BATCH)
    acc.save_state()
    want = _snapshot(acc, model)

    acc2, model2, step2, loader2 = _fresh(tmp_path, with_loader=True)
    with CrashPoint(label) as cp:
        with pytest.raises(SimulatedCrash):
            acc2.load_state()
    assert cp.fired, f"restore crash point {label} was never reached"
    assert CheckpointManager(tmp_path / "checkpoints").verify(tmp_path / "checkpoints" / "checkpoint_0").ok
    acc3, model3, step3, loader3 = _fresh(tmp_path, with_loader=True)
    assert os.path.basename(acc3.load_state()) == "checkpoint_0"
    _assert_restored(acc3, model3, want)


@pytest.mark.parametrize("strip", ["v1", "topology"])
def test_pre_elastic_manifest_restores_on_identical_topology(tmp_path, strip):
    acc, model, step, _ = _fresh(tmp_path, with_loader=True)
    step(BATCH)
    acc.save_state()
    want = _snapshot(acc, model)
    ck = tmp_path / "checkpoints" / "checkpoint_0"
    manifest = read_manifest(ck)
    assert manifest["schema_version"] == 2 and "topology" in manifest
    manifest.pop("topology")
    if strip == "v1":
        manifest["schema_version"] = 1
    write_manifest(ck, manifest)
    acc2, model2, step2, _ = _fresh(tmp_path, with_loader=True)
    assert os.path.basename(acc2.load_state()) == "checkpoint_0"
    _assert_restored(acc2, model2, want)


def test_missing_rng_file_warns(tmp_path, caplog):
    acc, model, step, _ = _fresh(tmp_path)
    step(BATCH)
    out = acc.save_state()
    (Path(out) / "rng_state_0.pkl").unlink()
    acc2, model2, step2, _ = _fresh(tmp_path)
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.checkpointing"):
        acc2.load_state(out)  # explicit dir: bypasses deep-verify discovery
    assert any("rng_state_0.pkl" in r.getMessage() and r.levelno == logging.WARNING for r in caplog.records)
    for k, v in model2.state_dict().items():  # the arrays still restore
        assert torch.equal(v, model.state_dict()[k]), k


def test_sampler_count_mismatch_warns(tmp_path, caplog):
    acc, model, step, loader = _fresh(tmp_path, with_loader=True)
    step(BATCH)
    out = acc.save_state()
    acc2, model2, step2, _ = _fresh(tmp_path)  # no loader prepared
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.checkpointing"):
        acc2.load_state(out)
    assert any("saved 1 dataloader state(s) but 0 dataloader(s)" in r.getMessage() for r in caplog.records)
