"""The self-checking "does it work" script that ``test`` runs through the
launcher.

Counterpart of :mod:`accelerate_tpu.test_utils.scripts.test_script`, at
one process: its process control, seeded shuffle (the RNG section),
loader and training-parity sections, each asserting and the script
exiting non-zero on a failure. The branches that need more than one
process wait for ROADMAP.md Queue 1 item 8. On the card by default;
launched with ``--cpu`` it runs on the CPU.

    python -m accelerate_tpu_torch.commands.cli launch --cpu \\
        accelerate_tpu_torch/test_utils/scripts/test_script.py
"""

from __future__ import annotations

import numpy as np


def check_process_control(accelerator):
    state = accelerator.state
    assert state.partial_state.process_index == accelerator.process_index
    accelerator.wait_for_everyone()
    with accelerator.main_process_first():
        pass
    executed = []
    accelerator.on_main_process(lambda: executed.append("main"))()
    if accelerator.is_main_process:
        assert executed == ["main"]
    with accelerator.split_between_processes(list(range(10))) as chunk:
        assert len(chunk) >= 10 // max(1, accelerator.num_processes)
    accelerator.print("process control OK")


def _local_order(dl):
    """The values yielded to this process, in order (the loaders keep their
    rows on the host: ``device_placement=False``)."""
    return [float(v) for b in dl for v in np.asarray(b["x"]).ravel()]


def make_ds(length: int):
    """A toy dict dataset: sample i is {"x": float(i)}."""

    class DS:
        def __len__(self):
            return length

        def __getitem__(self, i):
            return {"x": np.float32(i)}

    return DS()


def check_dataloader_sharding(accelerator):
    from accelerate_tpu_torch.data_loader import DataLoaderShard
    from accelerate_tpu_torch.utils.operations import gather_object

    pc = max(1, accelerator.num_processes)
    dl = DataLoaderShard(make_ds(40), batch_size=2, device_placement=False)
    seen = []
    for batch in dl:
        assert batch["x"].shape[0] == dl.total_batch_size // pc
        seen.extend(np.asarray(batch["x"]).ravel().tolist())
    # every real sample appears; a padded tail repeats rows
    global_seen = [v for chunk in gather_object([seen]) for v in chunk]
    assert set(range(40)) <= set(int(v) for v in global_seen)
    # one seed: one permutation
    dl_a = DataLoaderShard(make_ds(40), batch_size=2, shuffle=True, seed=5, device_placement=False)
    dl_b = DataLoaderShard(make_ds(40), batch_size=2, shuffle=True, seed=5, device_placement=False)
    assert _local_order(dl_a) == _local_order(dl_b)
    accelerator.print("dataloader sharding OK")


def _single_device_baseline(ds, n_steps_per_epoch, epochs=2, lr=0.1, global_batch=16, skipped=()):
    """The f32 plain loop every mode must match: SGD on ``linear_loss_fn``
    over the loader's rows in order. ``skipped``: the steps the fp16 run's
    loss scaler rejected (an overflow while the scale calibrates); the
    baseline drops those batches too."""
    import torch

    from accelerate_tpu_torch.test_utils import linear_loss_fn

    params = {"a": torch.zeros((), requires_grad=True), "b": torch.zeros((), requires_grad=True)}
    i = 0
    step_idx = 0
    for _ in range(epochs):
        for _ in range(n_steps_per_epoch):
            idx = np.arange(i, i + global_batch) % len(ds)
            i += global_batch
            if step_idx in skipped:
                step_idx += 1
                continue
            step_idx += 1
            batch = {"x": torch.as_tensor(ds.x[idx]), "y": torch.as_tensor(ds.y[idx])}
            grads = torch.autograd.grad(linear_loss_fn(params, batch), [params["a"], params["b"]])
            with torch.no_grad():
                for p, g in zip((params["a"], params["b"]), grads):
                    p -= lr * g
    return {k: float(v.detach()) for k, v in params.items()}


def _fresh_accelerator(**kwargs):
    """Reset the state singletons and make a new Accelerator (one per
    precision mode)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return Accelerator(**kwargs)


def check_training_parity(accelerator):
    """``build_train_step`` must match the plain loop in every precision
    mode: f32 to 1e-4, bf16 and fp16 (the two-parameter regression rounds
    its products) to 2e-2."""
    import torch

    from accelerate_tpu_torch.test_utils import RegressionDataset, RegressionModel, linear_loss_fn

    for mixed_precision, tol in (("no", 1e-4), ("bf16", 2e-2), ("fp16", 2e-2)):
        acc = _fresh_accelerator(mixed_precision=mixed_precision)
        ds = RegressionDataset(length=64)
        model = acc.prepare_model(RegressionModel())
        acc.prepare_optimizer(torch.optim.SGD(model.module.parameters(), lr=0.1))
        loader = acc.prepare_data_loader(ds)
        loader.batch_size = max(1, 16 // acc.num_data_shards)
        step = acc.build_train_step(linear_loss_fn)
        optimizer = acc._optimizers[-1]
        skipped = set()
        step_idx = 0
        for _ in range(2):
            for batch in loader:
                step(batch)
                if optimizer.step_was_skipped:
                    skipped.add(step_idx)
                step_idx += 1

        base = _single_device_baseline(ds, n_steps_per_epoch=len(loader), skipped=skipped)
        got = {k: float(v.detach()) for k, v in model.module.named_parameters()}
        assert all(abs(got[k] - base[k]) < tol for k in ("a", "b")), (
            f"[{mixed_precision}] training diverged: {got} vs {base}"
        )
        acc.print(f"training parity [{mixed_precision}] OK")


def check_split_batches(accelerator):
    """``split_batches=True``: ``batch_size`` is the global batch (each
    shard takes ``batch_size // n`` rows); False: per shard (the global
    batch is ``batch_size * n``)."""
    from accelerate_tpu_torch.data_loader import DataLoaderShard

    n = max(1, accelerator.num_data_shards)
    pc = max(1, accelerator.num_processes)
    dl_split = DataLoaderShard(make_ds(64), batch_size=16, split_batches=True, device_placement=False)
    assert dl_split.total_batch_size == 16, dl_split.total_batch_size
    batch = next(iter(dl_split))
    assert batch["x"].shape[0] == 16 // pc
    dl_grow = DataLoaderShard(make_ds(64), batch_size=16, split_batches=False, device_placement=False)
    assert dl_grow.total_batch_size == 16 * n
    accelerator.print("split batches OK")


def check_uneven_gather_exactness(accelerator):
    """``gather_for_metrics`` over a dataset whose length no batch divides
    gives back exactly the dataset: the wrapped tail's repeats dropped."""
    length = 61
    acc = _fresh_accelerator()
    loader = acc.prepare_data_loader(make_ds(length))
    loader.batch_size = max(1, 8 // max(1, acc.num_data_shards))
    seen = [np.asarray(acc.gather_for_metrics(batch["x"]).cpu()) for batch in loader]
    flat = np.concatenate(seen)
    assert len(flat) == length, f"expected exactly {length} rows, got {len(flat)}"
    assert sorted(int(v) for v in flat) == list(range(length)), "gathered rows are not the dataset"
    acc.print("uneven gather exactness OK")


def check_epoch_reshuffle(accelerator):
    """``set_epoch`` reshuffles, and one (seed, epoch) gives one order."""
    from accelerate_tpu_torch.data_loader import DataLoaderShard

    dl = DataLoaderShard(make_ds(32), batch_size=2, shuffle=True, seed=7, device_placement=False)
    dl.set_epoch(0)
    e0 = _local_order(dl)
    dl.set_epoch(1)
    e1 = _local_order(dl)
    assert e0 != e1, "epochs must reshuffle"
    dl2 = DataLoaderShard(make_ds(32), batch_size=2, shuffle=True, seed=7, device_placement=False)
    dl2.set_epoch(1)
    assert _local_order(dl2) == e1, "the same (seed, epoch) must give the same order"
    accelerator.print("epoch reshuffle OK")


def check_trigger(accelerator):
    """The early-stop flag: set on one process, read (and cleared) on all."""
    assert accelerator.check_trigger() is False
    if accelerator.process_index == accelerator.num_processes - 1:
        accelerator.set_trigger()
    assert accelerator.check_trigger() is True, "a trigger set on one rank must be visible on all"
    assert accelerator.check_trigger() is False, "check_trigger must reset the flag"
    accelerator.print("trigger OK")


def check_gather_ops(accelerator):
    import torch

    x = torch.arange(8.0, device=accelerator.device)
    assert accelerator.gather(x).shape[0] >= 8
    reduced = accelerator.reduce(torch.ones(4, device=accelerator.device), "mean")
    np.testing.assert_allclose(reduced.cpu().numpy(), np.ones(4))
    objs = accelerator.gather_for_metrics([accelerator.process_index], use_gather_object=True)
    assert accelerator.process_index in objs
    accelerator.print("gather ops OK")


def main():
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils import set_seed

    set_seed(42)
    accelerator = Accelerator()
    accelerator.print(f"state: device={accelerator.device} procs={accelerator.num_processes}")
    check_process_control(accelerator)
    check_dataloader_sharding(accelerator)
    check_split_batches(accelerator)
    check_epoch_reshuffle(accelerator)
    check_gather_ops(accelerator)
    check_trigger(accelerator)
    # the checks that reset the singletons run last (they make new Accelerators)
    check_uneven_gather_exactness(accelerator)
    check_training_parity(accelerator)
    accelerator.print("ALL CHECKS PASSED")


if __name__ == "__main__":
    main()
