"""The one-process Accelerator surface of the port, as
tests/test_accelerator_surface.py holds the JAX package's: free_memory and
clear, the autocast override, join_uneven_inputs, no_sync, the profiler,
main_process_first and the on_* decorators, split_between_processes, and
the project directories."""

import logging

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Accelerator, ProfileKwargs
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils import (
    AccelerateTestCase,
    RegressionDataset,
    RegressionModel,
    TempDirTestCase,
    execute_subprocess_async,
    linear_loss_fn,
)
from accelerate_tpu_torch.utils import AutocastKwargs, ProjectConfiguration, dataclasses, release_memory

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture
def acc():
    return Accelerator(cpu=True)


def _prepare(acc, lr=0.1):
    m = RegressionModel()
    return acc.prepare(m, torch.optim.SGD(m.module.parameters(), lr=lr))


def test_free_memory_clears_prepared_objects_and_buffers(acc):
    model, opt = _prepare(acc)
    acc.prepare_data_loader(RegressionDataset(length=8))
    acc.backward(linear_loss_fn, {"x": torch.ones(4), "y": torch.ones(4)})
    assert acc._grad_buffers
    acc.step = 7
    leftover = acc.free_memory(model)
    assert acc._models == [] and acc._optimizers == [] and acc._schedulers == []
    assert acc._dataloaders == [] and acc._grad_buffers == {} and acc.step == 0
    assert leftover == [None]  # release_memory nulls what it is handed


def test_clear_aliases_free_memory(acc):
    _prepare(acc)
    acc.clear()
    assert acc._models == []


def test_release_memory_takes_a_list():
    assert release_memory([1, 2, 3]) == [None, None, None]
    assert release_memory() == []


def test_autocast_context_overrides_policy():
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    x = {"w": torch.ones(3)}
    assert acc.cast_to_compute(x)["w"].dtype == torch.bfloat16
    with acc.autocast(AutocastKwargs(enabled=False)):
        assert acc.cast_to_compute(x)["w"].dtype == torch.float32
    assert acc.cast_to_compute(x)["w"].dtype == torch.bfloat16  # restored on exit


def test_autocast_keep_fp32_patterns():
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    tree = {"layernorm_scale": torch.ones(2), "dense_kernel": torch.ones(2)}
    with acc.autocast(AutocastKwargs(keep_fp32_patterns=("layernorm",))):
        out = acc.cast_to_compute(tree)
    assert out["layernorm_scale"].dtype == torch.float32
    assert out["dense_kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("mixed_precision, tf32_inside", [("no", False), ("bf16", True)])
def test_f32_policy_turns_tf32_off_inside_the_steps(monkeypatch, mixed_precision, tf32_inside):
    """mixed_precision="no" is real f32, as the JAX package's
    _matmul_precision_ctx makes it: the train step, backward and the eval
    step run with TF32 off for cuDNN's convolutions (torch's default is on)
    and for matmuls, and the flags come back after; a 16-bit policy keeps
    them."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    acc = Accelerator(cpu=True, mixed_precision=mixed_precision)
    model, _ = _prepare(acc)
    seen = []

    def loss_fn(params, batch):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return linear_loss_fn(params, batch)

    batch = {"x": torch.ones(4), "y": torch.ones(4)}
    acc.build_train_step(loss_fn)(batch)
    acc.backward(loss_fn, batch)
    acc.build_eval_step(lambda p, b: loss_fn(p, b))(batch)
    assert seen == [(tf32_inside, tf32_inside)] * 3
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_join_uneven_inputs_overrides_even_batches(acc):
    dl = acc.prepare_data_loader(RegressionDataset(length=10), even_batches=True)
    with acc.join_uneven_inputs([None], even_batches=False):
        assert dl.even_batches is False
    assert dl.even_batches is True


def test_no_sync_blocks_apply_until_exit(acc):
    model, opt = _prepare(acc, lr=0.5)
    batch = {"x": torch.ones(4), "y": torch.full((4,), 5.0)}
    with acc.no_sync():
        acc.backward(linear_loss_fn, batch)
        opt.step()
        assert model.module.a.item() == 0.0, "no_sync must suppress the apply"
    acc.backward(linear_loss_fn, batch)
    opt.step()
    assert model.module.a.item() != 0.0


def test_profile_context_writes_trace(acc, tmp_path):
    ready = []
    handler = ProfileKwargs(output_trace_dir=str(tmp_path / "trace"), on_trace_ready=ready.append)
    with acc.profile(handler) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = [p for p in (tmp_path / "trace").rglob("*") if p.is_file()]
    assert [p.name for p in files] == ["rank0.pt.trace.json"]
    assert ready == [str(tmp_path / "trace")]
    assert any("mm" in e.key for e in prof.key_averages())
    # a string is the trace directory
    with acc.profile(str(tmp_path / "plain")):
        torch.ones(2) + 1
    assert (tmp_path / "plain" / "rank0.pt.trace.json").is_file()


def test_profile_defaults_to_the_logging_dir(tmp_path):
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=str(tmp_path)))
    assert acc.logging_dir == str(tmp_path)
    with acc.profile():
        torch.ones(2) * 2
    assert (tmp_path / "profile" / "rank0.pt.trace.json").is_file()


def test_profile_kwargs_map_onto_torch_profiler(caplog, monkeypatch):
    from torch.profiler import ProfilerActivity

    assert ProfileKwargs().profiler_kwargs(cuda=True) == {
        "activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA], "record_shapes": False, "with_stack": False,
    }
    kw = ProfileKwargs(host_tracer_level=3, python_tracer_level=1).profiler_kwargs(cuda=False)
    assert kw == {"activities": [ProfilerActivity.CPU], "record_shapes": True, "with_stack": True}
    assert ProfileKwargs(host_tracer_level=0).profiler_kwargs(cuda=True)["activities"] == [ProfilerActivity.CUDA]
    monkeypatch.setattr(dataclasses, "_dropped_profile_options_warned", False)
    with caplog.at_level(logging.WARNING):
        ProfileKwargs(create_perfetto_link=True).profiler_kwargs(cuda=False)
        ProfileKwargs(create_perfetto_link=True).profiler_kwargs(cuda=False)
    assert [r.getMessage() for r in caplog.records].count(
        "ProfileKwargs: torch.profiler has no counterpart of create_perfetto_link; ignored") == 1


def test_main_process_first_and_on_process_decorators(acc):
    order = []
    with acc.main_process_first():
        order.append("main")
    with acc.local_main_process_first():
        order.append("local")
    assert order == ["main", "local"]
    assert acc.is_main_process and acc.is_local_main_process and acc.is_last_process
    assert acc.on_main_process(lambda: 1)() == 1
    assert acc.on_local_main_process(lambda: 2)() == 2
    assert acc.on_last_process(lambda: 3)() == 3
    assert acc.on_process(lambda: 4, process_index=0)() == 4
    assert acc.on_process(lambda: 5, process_index=1)() is None


@pytest.mark.parametrize("inputs", [[1, 2, 3], {"a": [1, 2, 3], "b": [4, 5, 6]}, np.arange(5)])
@pytest.mark.parametrize("apply_padding", [False, True])
def test_split_between_processes_gives_one_process_everything(acc, inputs, apply_padding):
    with acc.split_between_processes(inputs, apply_padding=apply_padding) as share:
        assert share is inputs


def test_project_directories_and_end_training(tmp_path):
    config = ProjectConfiguration(project_dir=str(tmp_path), logging_dir=str(tmp_path / "logs"), iteration=3)
    acc = Accelerator(cpu=True, project_config=config)
    assert acc.project_dir == str(tmp_path)
    assert acc.logging_dir == str(tmp_path / "logs")
    assert acc.save_iteration == 3
    acc.end_training()  # a barrier with one process


class TestCaseHelpers(TempDirTestCase):
    """The port's unittest helpers: a class temp dir emptied before each
    test, the singletons reset after each."""

    def test_a_tempdir_is_given(self):
        (self.tmpdir / "x").write_text("x")
        assert (self.tmpdir / "x").exists()

    def test_b_tempdir_was_emptied(self):
        assert not any(self.tmpdir.iterdir())

    def test_teardown_resets_the_singletons(self):
        Accelerator(cpu=True)
        assert PartialState._shared_state and AcceleratorState._shared_state
        AccelerateTestCase.tearDown(self)
        assert not PartialState._shared_state and not AcceleratorState._shared_state


def test_execute_subprocess_async_raises_on_failure():
    import sys

    assert execute_subprocess_async([sys.executable, "-c", "print('ok')"]).stdout.strip() == "ok"
    with pytest.raises(RuntimeError, match="rc=3"):
        execute_subprocess_async([sys.executable, "-c", "raise SystemExit(3)"])
