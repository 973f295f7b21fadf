"""The port's launcher on the CPU: ``launch`` (the environment protocol,
restarts, a gloo process group, the refusal of a world above 1) and
``notebook_launcher`` / ``debug_launcher`` (the cases of
tests/test_launchers.py, on gloo). The launcher runs in this process; each
launched script or spawned worker is a process of its own: four groups
here (two more, ``test --cpu`` and a refused mesh, are in
test_torch_cli_commands.py), so the file stays cheap."""

import os

import pytest
import torch

from accelerate_tpu_torch import debug_launcher, notebook_launcher
from accelerate_tpu_torch.commands.launch import launch_command, launch_parser
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)


# the spawned workers' functions: a worker imports this module by name (it imports torch and the port, no JAX)
def _gloo_sum():
    """Each rank adds its rank + 1 over gloo; every rank returns the sum."""
    import torch.distributed as dist

    dist.init_process_group("gloo")
    try:
        t = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(t)
        return float(t), os.environ["ACCELERATE_USE_CPU"], dist.get_world_size()
    finally:
        dist.destroy_process_group()


def _crash():
    raise AssertionError("worker crash")


def _inline_accelerator():
    """One process: the launcher's environment reaches a fresh Accelerator."""
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator()
    return acc.num_processes, acc.mixed_precision, acc.device.type


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    # no configuration file of the user's steers these launches
    monkeypatch.setenv("ACCELERATE_TPU_TORCH_HOME", str(tmp_path / "home"))
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _launch(*argv) -> int:
    return launch_command(launch_parser().parse_args([str(a) for a in argv]))


def test_cpu_launch_reads_the_environment_and_restarts(tmp_path):
    """``--cpu --mixed_precision bf16 --gradient_accumulation_steps 2``: a
    script's ``Accelerator()`` reads bf16, 2 and the CPU; with
    ``--max_restarts 1`` a script failing on attempt 0 is run again and the
    launch exits 0."""
    out = tmp_path / "out.txt"
    script = tmp_path / "script.py"
    script.write_text(
        "import os, sys\n"
        "from accelerate_tpu_torch import Accelerator\n"
        "acc = Accelerator()\n"
        f"with open({str(out)!r}, 'a') as f:\n"
        "    f.write(f\"{acc.mixed_precision} {acc.gradient_accumulation_steps} {acc.device.type} "
        "{os.environ['ACCELERATE_RESTART_COUNT']}\\n\")\n"
        "sys.exit(3 if os.environ['ACCELERATE_RESTART_COUNT'] == '0' else 0)\n"
    )
    rc = _launch("--cpu", "--mixed_precision", "bf16", "--gradient_accumulation_steps", "2", "--max_restarts", "1",
                 "--monitor_interval", "0", script)
    assert rc == 0
    assert out.read_text().splitlines() == ["bf16 2 cpu 0", "bf16 2 cpu 1"]


def test_gloo_group_sums_refuses_an_accelerator_and_restarts_as_a_group(tmp_path, capfd):
    """``--num_processes 2 --cpu``: both ranks rendezvous over gloo from
    ``env://`` and get the sum. On attempt 0 rank 1 then builds an
    ``Accelerator``, which refuses a world of 2 with item 8's message and
    exits non-zero; the group is restarted whole and attempt 1 passes."""
    script = tmp_path / "script.py"
    script.write_text(
        "import os\n"
        "import torch, torch.distributed as dist\n"
        "dist.init_process_group('gloo')\n"
        "t = torch.tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "attempt = os.environ['ACCELERATE_RESTART_COUNT']\n"
        f"open(os.path.join({str(tmp_path)!r}, f\"sum_{{dist.get_rank()}}_{{attempt}}\"), 'w').write(str(float(t)))\n"
        "dist.destroy_process_group()\n"
        "if attempt == '0' and os.environ['RANK'] == '1':\n"
        "    from accelerate_tpu_torch import Accelerator\n"
        "    Accelerator()\n"
    )
    rc = _launch("--num_processes", "2", "--cpu", "--max_restarts", "1", "--monitor_interval", "0", script)
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    for rank in (0, 1):
        for attempt in (0, 1):
            assert (tmp_path / f"sum_{rank}_{attempt}").read_text() == "3.0"
    assert "NotImplementedError: WORLD_SIZE=2" in err and "Queue 1 item 8" in err
    assert "restart 1/1" in err


def test_launcher_refuses_fake_devices(tmp_path):
    with pytest.raises(ValueError, match="XLA flag"):
        _launch("--cpu", "--fake_devices", "8", tmp_path / "never_run.py")


def test_notebook_launcher_in_process(monkeypatch):
    """One process: the function runs here, under the launcher's
    environment, and its value comes back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert notebook_launcher(_inline_accelerator, num_processes=1, mixed_precision="bf16",
                             cpu=True) == (1, "bf16", "cpu")
    assert "ACCELERATE_MIXED_PRECISION" not in os.environ  # patched for the call only


def test_notebook_launcher_rejects_live_state():
    PartialState(cpu=True)
    with pytest.raises(ValueError, match="already live"):
        notebook_launcher(lambda: None, num_processes=1)


def test_debug_launcher_spawns_gloo_workers():
    """Two spawned CPU processes over gloo; rank 0's value comes back."""
    assert debug_launcher(_gloo_sum, num_processes=2) == (3.0, "1", 2)


def test_notebook_launcher_worker_crash_raises_not_hangs():
    from accelerate_tpu_torch.utils.environment import get_free_port

    with pytest.raises(RuntimeError, match="nonzero"):
        notebook_launcher(_crash, num_processes=2, use_port=str(get_free_port()), cpu=True)
