"""Checkpoint save/load of the full training state.

Counterpart of :mod:`accelerate_tpu.checkpointing`, with the same
directory layout, file names, commit protocol and crash points, so its
``CheckpointManager`` and manifest checks hold either package's
checkpoints::

    checkpoint_dir/
      model/model.safetensors     # the model's state_dict, its mutable state too (model_{i}/ for the i-th, i > 0)
      optimizer/optimizer.bin     # the optimizer's state_dict, torch.save (optimizer_{i}/)
      scheduler_0.json
      samplers.json               # every prepared loader's state_dict
      custom_checkpoint_0.pkl
      rng_state_0.pkl             # python, numpy, torch (and cuda) RNG states, the seed
      accelerate_state.json       # step, save_iteration, loss scale, precision, seed
      commit_success.json         # integrity manifest: the COMMIT marker (ft/manifest.py)

The JAX package writes its arrays with orbax; here each model's tensors
go through the port's own safetensors writer
(:mod:`.utils.safetensors_io`) and each optimizer's ``state_dict`` through
``torch.save``, read back with ``torch.load(weights_only=True)``. A
model's mutable state (:attr:`~.modeling.Model.state`, ResNet's BatchNorm
running statistics) is buffers of its module, so it rides in
``model.safetensors`` with the parameters, where the JAX package writes
it beside them (``model_state_<i>/``).

**Atomic commit protocol**: every save writes into ``<dir>.tmp/``, the
main process writes the ``commit_success.json`` manifest (per-file sizes
+ crc32) and renames to the final name. A crash at ANY point leaves
either (a) a ``.tmp`` dir without a manifest -- invisible to discovery,
removed by GC -- or (b) a fully committed checkpoint. ``total_limit``
pruning runs strictly AFTER the new checkpoint commits and never touches
the checkpoint the run resumed from.

**Tensors are copied to the host first.** A save copies every model and
optimizer tensor to host memory (pinned, for tensors on the card) and
waits for those copies before it returns or writes, so the training step
that follows, which updates the parameters and the optimizer state in
place, cannot race the save. ``async_save=True`` then hands the file
writes to a background thread; the manifest, the rename and the pruning
run when the save is drained (:func:`wait_for_checkpoint`, the next
save or load, or interpreter exit). A failed write removes the ``.tmp``
directory and raises from the drain.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import pickle
import random
import re
import shutil
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .ft.crashpoints import crash_point
from .ft.manifest import TMP_SUFFIX, build_manifest, write_manifest
from .utils import safetensors_io
from .utils.retry import retry_call

logger = logging.getLogger(__name__)

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
RNG_STATE_NAME = "rng_state"
MODEL_FILE = "model.safetensors"
OPTIMIZER_FILE = "optimizer.bin"


class _PendingSave:
    """One in-flight ``save_state(..., async_save=True)``: its writer thread
    plus the commit/abort actions. The COMMIT (manifest write + rename +
    pruning) is deferred until every file write has finished -- a
    half-written async checkpoint must never look committed."""

    def __init__(self, jobs: list, finalize: Callable[[], None], abort: Callable[[BaseException], None]):
        self.finalize = finalize
        self.abort = abort
        self.error: Optional[Exception] = None
        self.thread = threading.Thread(target=self._write, args=(jobs,), name="checkpoint-writer")
        self.thread.start()

    def _write(self, jobs: list):
        try:
            for job in jobs:
                job()
        except Exception as e:  # surfaced by drain(), never swallowed
            self.error = e

    def drain(self) -> Optional[Exception]:
        """Wait for the writer thread, then run ``finalize`` on success or
        ``abort`` on failure. Returns the first exception instead of
        raising so the caller can sweep every pending save before
        propagating."""
        self.thread.join()
        first_error = self.error
        try:
            if first_error is None:
                self.finalize()
            else:
                self.abort(first_error)
        except Exception as e:
            if first_error is None:
                first_error = e
        return first_error


# in-flight async saves; drained by wait_for_checkpoint() and before any
# subsequent save/load touches the same process
_PENDING_ASYNC: list[_PendingSave] = []
_ATEXIT_REGISTERED = False


def wait_for_checkpoint():
    """Block until every async ``save_state(..., async_save=True)`` has
    fully COMMITTED (files written, manifest written, directory renamed
    into place). A save whose background write failed is aborted: its
    ``.tmp`` directory is removed so nothing can ever mistake it for a
    checkpoint, and the first error propagates after the sweep. Safe to
    call when nothing is pending."""
    global _PENDING_ASYNC
    pending, _PENDING_ASYNC = _PENDING_ASYNC, []
    first_error = None
    for save in pending:
        err = save.drain()
        if err is not None and first_error is None:
            first_error = err
    if first_error is not None:
        raise first_error


def _register_drain_atexit():
    global _ATEXIT_REGISTERED
    if _ATEXIT_REGISTERED:
        return
    # a script whose last action is an async save must still commit; the
    # threading atexit hooks run before the interpreter joins threads and
    # shuts executors down, plain atexit after
    import atexit

    try:
        threading._register_atexit(wait_for_checkpoint)
    except Exception:  # very late in shutdown -- best effort
        atexit.register(wait_for_checkpoint)
    _ATEXIT_REGISTERED = True


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _to_host(tree):
    """A copy of every tensor in ``tree`` in host memory (pinned for tensors
    on the card), complete when this returns: the step after a save updates
    the originals in place."""
    on_card = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type == "cpu":
            return t.clone()
        on_card.append(t.device)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    out = _map_tensors(copy, tree)
    for device in set(on_card):
        torch.cuda.current_stream(device).synchronize()
    return out


def _telemetry_log(accelerator):
    """The live telemetry event log, or None. Reads the private slot:
    checkpointing must not be what creates the telemetry (the
    ``Accelerator.telemetry`` property is lazy)."""
    tel = getattr(accelerator, "_telemetry", None)
    return tel.log if tel is not None else None


def _retry_cfg(accelerator, log, what: str) -> dict:
    """Retry policy for checkpoint filesystem IO, from the accelerator's
    ``FaultToleranceKwargs``; every retry and give-up is logged."""
    h = accelerator.ft_handler

    def on_retry(attempt, delay, exc):
        logger.warning(f"checkpoint IO retry {attempt} for {what}: {exc}")
        if log is not None:
            log.event("ckpt_retry", severity="warning", what=what, attempt=attempt,
                      delay_s=round(delay, 3), error=str(exc))

    def on_giveup(attempt, exc):
        logger.error(f"checkpoint IO for {what} failed after {attempt} attempts: {exc}")
        if log is not None:
            log.event("ckpt_giveup", severity="error", what=what, attempts=attempt, error=str(exc))

    return dict(
        attempts=h.io_retries,
        base_delay=h.retry_base_delay,
        max_delay=h.retry_max_delay,
        on_retry=on_retry,
        on_giveup=on_giveup,
    )


def _commit_checkpoint(accelerator, tmp: Path, final: Path, iteration: Optional[int], step: int,
                       topology: Optional[dict] = None):
    """The commit half of the atomic save protocol: barrier -> the main
    process writes the integrity manifest into the tmp dir (THE commit
    point) -> rename to the final name -> post-commit ``total_limit``
    pruning that never touches the new checkpoint or the one this run
    resumed from. ``step`` is the step the tensors were copied at (an
    async save commits later, after more steps may have run)."""
    log = _telemetry_log(accelerator)
    accelerator.wait_for_everyone()
    if accelerator.is_main_process:
        manifest = build_manifest(
            tmp, step=step, iteration=iteration, num_processes=accelerator.num_processes, topology=topology
        )
        retry_call(write_manifest, tmp, manifest, **_retry_cfg(accelerator, log, "manifest"))
        crash_point("pre_rename")
        if final.exists():
            # overwriting an explicit output_dir: swap via a side name so a
            # crash leaves either the old committed dir or the new one,
            # never a hole
            old = final.with_name(final.name + ".old" + TMP_SUFFIX)
            if old.exists():
                shutil.rmtree(old)
            final.rename(old)
            tmp.rename(final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            tmp.rename(final)
    accelerator.wait_for_everyone()
    if log is not None:
        log.event("ckpt_commit", dir=str(final), iteration=iteration, step=step)

    project = accelerator.project_configuration
    if project.automatic_checkpoint_naming and accelerator.is_main_process and project.total_limit is not None:
        from .ft.manager import CheckpointManager

        protect = [final]
        if accelerator._resumed_from:
            protect.append(accelerator._resumed_from)
        CheckpointManager(final.parent).prune(project.total_limit, protect=protect)
    logger.info(f"Saved accelerator state to {final}")


def _abort_checkpoint(accelerator, tmp: Path, error):
    """A background write failed: the ``.tmp`` directory holds a partial,
    never-committed state -- remove it so no discovery or human ever
    mistakes it for a checkpoint."""
    log = _telemetry_log(accelerator)
    logger.error(f"async checkpoint save to {tmp} FAILED ({error}); removing partial directory")
    if log is not None:
        log.event("ckpt_abort", severity="error", dir=str(tmp), error=str(error))
    if accelerator.is_main_process:
        shutil.rmtree(tmp, ignore_errors=True)


def _pickle_to(path: Path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _rng_states() -> dict:
    """This process's host RNG states: python, numpy and torch, the card's
    generators where a card is present, and the recorded seed."""
    from .utils.random import get_seed

    states = {
        "python": random.getstate(),
        "numpy": np.random.get_state(),
        "seed": get_seed(),
        "torch": torch.get_rng_state().numpy(),
    }
    if torch.cuda.is_available():
        states["cuda"] = [s.numpy() for s in torch.cuda.get_rng_state_all()]
    return states


def _restore_rng_states(states: dict) -> None:
    """Set every RNG back to ``states`` without reseeding anything."""
    from .utils.random import restore_seed_for_keys

    random.setstate(states["python"])
    np.random.set_state(states["numpy"])
    if "torch" in states:
        torch.set_rng_state(torch.from_numpy(states["torch"]))
    if "cuda" in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all([torch.from_numpy(s) for s in states["cuda"]])
    restore_seed_for_keys(states.get("seed"))


def save_accelerator_state(
    accelerator, output_dir: Optional[str] = None, safe_serialization: bool = True, async_save: bool = False
):
    """Save the full training state into ``output_dir`` (or the next
    ``checkpoint_{iteration}`` under automatic naming). Atomic: writes into
    ``<output_dir>.tmp``, writes the ``commit_success.json`` manifest,
    renames. A kill at any instant leaves the previous checkpoints
    untouched and the partial one invisible to discovery.

    ``async_save=True`` returns once the tensors are copied to the host;
    the file writes continue on a background thread and the commit runs
    when the save is drained (:func:`wait_for_checkpoint`, or the next
    save or load). ``safe_serialization`` is accepted for the JAX
    signature: model tensors are always written as safetensors.

    As in the JAX package (``accelerate_tpu/checkpointing.py:381-511``
    saves the step counter and the arrays, never the train step's
    accumulation buffer), a window of gradient accumulation still open at
    the save is not persisted: save on a sync boundary."""
    wait_for_checkpoint()  # a previous async save must fully commit first
    project = accelerator.project_configuration
    iteration = None
    if project.automatic_checkpoint_naming:
        base = os.path.join(accelerator.project_dir or ".", project.checkpoints_dir_name)
        iteration = project.iteration
        output_dir = os.path.join(base, f"checkpoint_{iteration}")
    if output_dir is None:
        raise ValueError("output_dir is required unless automatic_checkpoint_naming is enabled")
    final = Path(output_dir)
    tmp = final.with_name(final.name + TMP_SUFFIX)
    log = _telemetry_log(accelerator)
    rcfg = _retry_cfg(accelerator, log, "state files")

    crash_point("pre_write")
    if accelerator.is_main_process:
        if project.automatic_checkpoint_naming and accelerator.ft_handler.gc_tmp_on_save:
            # sweep stale .tmp leftovers of older crashed saves (recovering
            # any fully committed one) BEFORE creating our own
            from .ft.manager import CheckpointManager

            CheckpointManager(final.parent).gc()
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    accelerator.wait_for_everyone()

    for hook in accelerator._save_model_hooks:
        hook(accelerator._models, [], str(tmp))

    jobs: list = []  # the array writes: run here, or on the writer thread when async

    def write(fn, *args):
        if async_save:
            jobs.append(functools.partial(retry_call, fn, *args, **rcfg))
        else:
            retry_call(fn, *args, **rcfg)

    # every (dir_name, host state) handed to the writers: the topology
    # record is built from exactly this list
    array_trees: list = []
    for i, model in enumerate(accelerator._models):
        model_dir = tmp / (f"{MODEL_NAME}_{i}" if i > 0 else MODEL_NAME)
        state = _to_host(model.state_dict())
        array_trees.append((model_dir.name, state))
        model_dir.mkdir()
        write(safetensors_io.save_file, state, model_dir / MODEL_FILE)
        crash_point("mid_pytree")
    for i, opt in enumerate(accelerator._optimizers):
        opt_dir = tmp / (f"{OPTIMIZER_NAME}_{i}" if i > 0 else OPTIMIZER_NAME)
        state = _to_host(opt.state_dict())
        array_trees.append((opt_dir.name, state))
        opt_dir.mkdir()
        write(torch.save, state, opt_dir / OPTIMIZER_FILE)

    if accelerator.is_main_process:
        for i, sched in enumerate(accelerator._schedulers):
            retry_call((tmp / f"{SCHEDULER_NAME}_{i}.json").write_text, json.dumps(sched.state_dict()), **rcfg)
        # loader positions, including the exact offset inside an epoch
        samplers = [dl.state_dict() if hasattr(dl, "state_dict") else {} for dl in accelerator._dataloaders]
        retry_call((tmp / "samplers.json").write_text, json.dumps(samplers), **rcfg)
        for i, obj in enumerate(accelerator._custom_objects):
            retry_call(_pickle_to, tmp / f"custom_checkpoint_{i}.pkl", obj.state_dict(), **rcfg)
        from .utils.random import get_seed

        meta = {
            "step": accelerator.step,
            "save_iteration": iteration if iteration is not None else project.iteration,
            "loss_scale": accelerator._loss_scale,
            # the fp16 scaler's clean-boundary count (the JAX package keeps
            # it in the train step's device state and does not save it)
            "scale_growth_tracker": accelerator._scale_growth_tracker,
            "mixed_precision": accelerator.mixed_precision,
            "seed": get_seed(),
        }
        retry_call((tmp / "accelerate_state.json").write_text, json.dumps(meta), **rcfg)

    retry_call(_pickle_to, tmp / f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl", _rng_states(), **rcfg)

    # the NAME is now reserved; the commit stamps `iteration` into the
    # manifest, and load_accelerator_state restores the counter
    if project.automatic_checkpoint_naming:
        project.iteration += 1

    crash_point("pre_manifest")
    topology = None
    if accelerator.is_main_process:
        from .ft.topology import build_topology_record

        topology = build_topology_record(accelerator, array_trees)
    commit = functools.partial(_commit_checkpoint, accelerator, tmp, final, iteration, accelerator.step, topology)
    if async_save:
        _register_drain_atexit()
        _PENDING_ASYNC.append(_PendingSave(jobs, commit, functools.partial(_abort_checkpoint, accelerator, tmp)))
        return str(final)
    commit()
    return str(final)


def load_accelerator_state(accelerator, input_dir: Optional[str] = None, **kwargs):
    """Restore a checkpoint into the prepared objects, in place: every
    parameter is copied into the existing tensor (a train step built
    before the load trains the restored values), the optimizer state lands
    on its parameters' device and dtype, and the RNGs are set back without
    reseeding.

    ``input_dir=None`` **auto-resumes**: garbage-collects orphaned ``.tmp``
    dirs (finishing any interrupted rename), walks back from the newest
    ``checkpoint_N`` to the newest one whose integrity manifest verifies,
    and restores from it -- including ``project.iteration``, so the resumed
    run's next save lands on ``checkpoint_{N+1}``. Requires
    ``automatic_checkpoint_naming``.

    A checkpoint whose topology record names another layout (more
    processes, a mesh) raises ``NotImplementedError`` before anything is
    restored: the elastic restore needs multi-process training (ROADMAP.md
    Queue 1 item 8)."""
    wait_for_checkpoint()  # never read past a checkpoint still being written
    project = accelerator.project_configuration
    log = _telemetry_log(accelerator)
    if input_dir is None:
        from .ft.manager import CheckpointManager

        if not project.automatic_checkpoint_naming or accelerator.project_dir is None:
            raise ValueError(
                "load_state() auto-resume requires ProjectConfiguration("
                "project_dir=..., automatic_checkpoint_naming=True); otherwise pass input_dir"
            )
        base = os.path.join(accelerator.project_dir, project.checkpoints_dir_name)
        mgr = CheckpointManager(base)
        if accelerator.is_main_process:
            mgr.gc()
        accelerator.wait_for_everyone()
        target = mgr.latest(deep=accelerator.ft_handler.verify_on_resume)
        if target is None:
            raise FileNotFoundError(f"auto-resume found no valid checkpoint under {base}")
        input_dir = str(target)
        if log is not None:
            log.event("ckpt_auto_resume", dir=input_dir)
    inp = Path(input_dir)
    if not inp.is_dir():
        raise FileNotFoundError(f"checkpoint directory {input_dir} not found")

    from .ft.manifest import read_manifest
    from .ft.topology import compare_topology, live_topology

    manifest = read_manifest(inp)
    saved_topo = (manifest or {}).get("topology")
    delta = compare_topology(saved_topo, live_topology(accelerator))
    if delta.is_elastic:
        raise NotImplementedError(
            f"checkpoint {inp.name} was saved on another topology ({'; '.join(delta.changes)}): an elastic "
            "restore (reshard, re-derived RNG, redistributed sampler offsets) needs multi-process training, "
            "ROADMAP.md Queue 1 item 8; nothing was restored"
        )
    if saved_topo is None and manifest is not None:
        logger.info(
            f"checkpoint {inp.name} carries no topology record (schema v1): "
            "restore is only verifiable on the topology that wrote it"
        )
    crash_point("pre_restore")

    for hook in accelerator._load_model_hooks:
        hook(accelerator._models, str(inp))

    for i, model in enumerate(accelerator._models):
        path = inp / (f"{MODEL_NAME}_{i}" if i > 0 else MODEL_NAME) / MODEL_FILE
        with torch.no_grad():
            model.load_state_dict(safetensors_io.load_file(path))
        crash_point("mid_restore_arrays")
    for i, opt in enumerate(accelerator._optimizers):
        path = inp / (f"{OPTIMIZER_NAME}_{i}" if i > 0 else OPTIMIZER_NAME) / OPTIMIZER_FILE
        if path.exists():
            opt.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    for i, sched in enumerate(accelerator._schedulers):
        path = inp / f"{SCHEDULER_NAME}_{i}.json"
        if path.exists():
            sched.load_state_dict(json.loads(path.read_text()))
    samplers_path = inp / "samplers.json"
    if samplers_path.exists():
        saved = json.loads(samplers_path.read_text())
        loaders = accelerator._dataloaders
        if len(saved) != len(loaders):
            # never silently restore a prefix: a loader left at position 0
            # (or a saved position dropped on the floor) re-trains on seen
            # data without any signal
            logger.warning(
                f"checkpoint {inp.name} saved {len(saved)} dataloader state(s) but "
                f"{len(loaders)} dataloader(s) are prepared: restoring the first "
                f"{min(len(saved), len(loaders))} positionally -- verify prepare() order matches the saving run"
            )
            if log is not None:
                log.event("ckpt_sampler_mismatch", severity="error", saved=len(saved), prepared=len(loaders),
                          dir=str(inp))
        for dl, s in zip(loaders, saved):
            # restores the sampler's epoch and seed AND the position inside
            # the epoch: the next pass skips the batches already delivered
            dl.load_state_dict(s)
    for i, obj in enumerate(accelerator._custom_objects):
        path = inp / f"custom_checkpoint_{i}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                obj.load_state_dict(pickle.load(f))
    meta_path = inp / "accelerate_state.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        accelerator.step = meta.get("step", 0)
        accelerator._loss_scale = meta.get("loss_scale", accelerator._loss_scale)
        accelerator._scale_growth_tracker = meta.get("scale_growth_tracker", accelerator._scale_growth_tracker)
        if meta.get("save_iteration") is not None:
            # continue the automatic naming after the restored checkpoint
            project.iteration = int(meta["save_iteration"]) + 1
    crash_point("pre_restore_rng")
    rng_path = inp / f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl"
    if rng_path.exists():
        with open(rng_path, "rb") as f:
            _restore_rng_states(pickle.load(f))
    else:
        # a process resuming with its boot-time RNG draws a different
        # shuffle/dropout stream than the saved run would have
        logger.warning(
            f"checkpoint {inp.name} has no {rng_path.name}: this process resumes with its "
            f"current (unrestored) host RNG -- draws will not continue the saved streams"
        )
        if log is not None:
            log.event("ckpt_rng_missing", severity="warning", file=rng_path.name,
                      process_index=accelerator.process_index, dir=str(inp))
    # pruning must never delete the checkpoint this run restored from
    # until a newer one has committed
    accelerator._resumed_from = str(inp.resolve())
    logger.info(f"Loaded accelerator state from {inp}")
    return str(inp)


def _parse_size(size) -> int:
    if isinstance(size, int):
        return size
    m = re.fullmatch(r"(\d+)\s*([KMGT]?B)", str(size).strip(), re.IGNORECASE)
    if not m:
        raise ValueError(f"cannot parse shard size {size!r}")
    mult = {"B": 1, "KB": 2**10, "MB": 2**20, "GB": 2**30, "TB": 2**40}[m.group(2).upper()]
    return int(m.group(1)) * mult


def save_model(model, save_directory: str, max_shard_size="10GB", safe_serialization: bool = True):
    """Consolidated weight export of a ``Model`` (or ``nn.Module``):
    ``model.safetensors``, or with more bytes than ``max_shard_size`` an
    indexed set of ``model-0000i-of-0000n.safetensors`` shards;
    ``safe_serialization=False`` writes ``model.pkl`` with ``torch.save``."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(save_directory, exist_ok=True)
    limit = _parse_size(max_shard_size)

    def nbytes(t):
        return t.numel() * t.element_size()

    shards, current, current_bytes = [], {}, 0
    for key, t in state.items():
        if current and current_bytes + nbytes(t) > limit:
            shards.append(current)
            current, current_bytes = {}, 0
        current[key] = t
        current_bytes += nbytes(t)
    if current:
        shards.append(current)

    if not safe_serialization:
        torch.save(state, os.path.join(save_directory, "model.pkl"))
    elif len(shards) == 1:
        safetensors_io.save_file(shards[0], os.path.join(save_directory, "model.safetensors"))
    else:
        index = {"metadata": {"total_size": sum(nbytes(t) for t in state.values())}, "weight_map": {}}
        for i, shard in enumerate(shards, 1):
            name = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
            safetensors_io.save_file(shard, os.path.join(save_directory, name))
            for k in shard:
                index["weight_map"][k] = name
        with open(os.path.join(save_directory, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    return save_directory


def load_model(model, path: str):
    """Load a :func:`save_model` export back into ``model``, each tensor
    copied into the existing parameter (its device and dtype kept)."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    single_path = os.path.join(path, "model.safetensors")
    if os.path.exists(index_path):
        index = json.loads(Path(index_path).read_text())
        state = {}
        for shard_name in sorted(set(index["weight_map"].values())):
            state.update(safetensors_io.load_file(os.path.join(path, shard_name)))
    elif os.path.exists(single_path):
        state = safetensors_io.load_file(single_path)
    else:
        state = torch.load(os.path.join(path, "model.pkl"), map_location="cpu", weights_only=True)
    with torch.no_grad():
        model.load_state_dict(state)
    return model
