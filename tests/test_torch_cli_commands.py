"""The port's commands beside the JAX package's, on the same inputs: the
launcher's environment (``build_env``) and configuration precedence, the
YAML schema, ``migrate``, ``estimate-memory``, ``checkpoints``,
``tpu-config`` and the menu; then the port's own: ``merge-weights``,
``test --cpu``, ``env``, the launcher's item-8 mesh refusal, and the
environment the launcher hands a script (``ACCELERATE_*``) read by
``Accelerator`` and ``PartialState``."""

import contextlib
import io
import json
import os
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu.commands import checkpoints as jax_ckpt
from accelerate_tpu.commands import config as jax_config
from accelerate_tpu.commands import estimate as jax_estimate
from accelerate_tpu.commands import launch as jax_launch
from accelerate_tpu.commands import menu as jax_menu
from accelerate_tpu.commands import migrate as jax_migrate
from accelerate_tpu.commands import tpu as jax_tpu
from accelerate_tpu.utils import environment as jax_environment
from accelerate_tpu.utils import versions as jax_versions
from accelerate_tpu_torch import Accelerator, LlamaConfig, ProjectConfiguration, create_llama_model
from accelerate_tpu_torch.commands import checkpoints as port_ckpt
from accelerate_tpu_torch.commands import config as port_config
from accelerate_tpu_torch.commands import estimate as port_estimate
from accelerate_tpu_torch.commands import launch as port_launch
from accelerate_tpu_torch.commands import menu as port_menu
from accelerate_tpu_torch.commands import migrate as port_migrate
from accelerate_tpu_torch.commands import tpu as port_tpu
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils import RegressionModel, corrupt_file, linear_loss_fn
from accelerate_tpu_torch.utils import environment as port_environment
from accelerate_tpu_torch.utils import safetensors_io
from accelerate_tpu_torch.utils import versions as port_versions

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    monkeypatch.setenv("ACCELERATE_TPU_TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setenv("ACCELERATE_TPU_HOME", str(tmp_path / "jax_home"))
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _stdout(fn, *args) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


# --------------------------------------------------------------------------- #
# the launcher's environment and configuration
# --------------------------------------------------------------------------- #

LAUNCH_FLAGS = [
    ([], 0, 1),
    (["--mixed_precision", "bf16", "--gradient_accumulation_steps", "4"], 0, 1),
    (["--mesh_fsdp", "2", "--mesh_data", "-1", "--mesh_tensor", "1", "--debug"], 0, 1),
    (["--num_processes", "4", "--main_process_port", "29999"], 3, 4),
    (["--num_processes", "4", "--num_machines", "2", "--main_process_ip", "10.0.0.1"], 2, 4),
    (["--cpu", "--mixed_precision", "fp8"], 0, 1),
    (["--cpu", "--num_processes", "2"], 1, 2),
]


@pytest.mark.parametrize("flags,process_id,num_processes", LAUNCH_FLAGS)
def test_build_env_matches_the_jax_launcher(flags, process_id, num_processes, monkeypatch):
    """The same ``ACCELERATE_*`` keys and values as the JAX launcher's for
    the same flags; the port's ``ACCELERATE_USE_CPU`` stands where the JAX
    launcher sets ``JAX_PLATFORMS=cpu``, and above one process torch's
    rendezvous names carry the same rank, world and address."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)  # so that only the JAX launcher's --cpu sets it
    argv = [*flags, "script.py", "--lr", "3"]
    jax_env = jax_launch.build_env(jax_launch.launch_parser().parse_args(argv), process_id, num_processes)
    port_env = port_launch.build_env(port_launch.launch_parser().parse_args(argv), process_id, num_processes)

    def accelerate(env):
        return {k: v for k, v in env.items() if k.startswith("ACCELERATE_") and k != "ACCELERATE_USE_CPU"}

    assert accelerate(port_env) == accelerate(jax_env)
    assert (port_env.get("ACCELERATE_USE_CPU") == "1") == (jax_env.get("JAX_PLATFORMS") == "cpu")
    assert port_env["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
    if num_processes > 1:
        assert port_env["RANK"] == port_env["ACCELERATE_PROCESS_ID"] == str(process_id)
        assert port_env["WORLD_SIZE"] == port_env["ACCELERATE_NUM_PROCESSES"] == str(num_processes)
        assert port_env["LOCAL_RANK"] == port_env["ACCELERATE_LOCAL_PROCESS_ID"]
        assert f"{port_env['MASTER_ADDR']}:{port_env['MASTER_PORT']}" == port_env["ACCELERATE_COORDINATOR_ADDRESS"]
    else:
        assert not {"RANK", "WORLD_SIZE", "MASTER_PORT"} & (port_env.keys() - os.environ.keys())


def test_ssh_fan_out_matches_the_jax_launcher(monkeypatch):
    """``--tpu_hosts``: one SSH command a host, each the JAX launcher's with
    torch's rendezvous names added (no process is started: Popen is
    faked). The JAX launcher's TPU pod discovery is not ported, so the
    JAX side's is switched off."""
    calls = {}

    class FakeProc:
        def __init__(self, cmd, **kw):
            calls.setdefault(self.side, []).append(cmd)

        def wait(self):
            return 0

    argv = ["--tpu_hosts", "w0,w1,w2", "--ssh_user", "me", "--main_process_port", "29400", "-m", "pkg.train",
            "--lr", "3e-4"]
    for side, mod in (("port", port_launch), ("jax", jax_launch)):
        monkeypatch.setattr(mod.subprocess, "Popen", type("P", (FakeProc,), {"side": side}))
        assert mod.launch_command(mod.launch_parser().parse_args(argv)) == 0
    assert len(calls["port"]) == len(calls["jax"]) == 3
    for rank, (port_cmd, jax_cmd) in enumerate(zip(calls["port"], calls["jax"])):
        assert port_cmd[:-1] == jax_cmd[:-1] == ["ssh", "-o", "StrictHostKeyChecking=no", f"me@w{rank}"]
        torch_names = f"MASTER_ADDR=w0 MASTER_PORT=29400 RANK={rank} LOCAL_RANK=0 WORLD_SIZE=3 "
        assert torch_names in port_cmd[-1]
        assert port_cmd[-1].replace(torch_names, "") == jax_cmd[-1]
        assert port_cmd[-1].endswith("-m pkg.train --lr 3e-4")


def test_interactive_config_asks_what_the_jax_questionnaire_asks(monkeypatch):
    answers = ["2", "", "4", "", "2", "8", "w0,w1", ""]
    got = []
    for mod, menu in ((port_config, port_menu), (jax_config, jax_menu)):
        it = iter(answers)
        monkeypatch.setattr("builtins.input", lambda prompt="", it=it: next(it))
        monkeypatch.setattr(menu, "select", lambda prompt, choices, default=None: choices[1])
        got.append(mod.interactive_config())
    assert got[0] == got[1] and got[0]["num_machines"] == 2 and got[0]["tpu_hosts"] == "w0,w1"


def test_config_file_fills_what_the_command_line_did_not(tmp_path):
    """CLI > YAML > defaults, as in the JAX launcher."""
    cfg = tmp_path / "cfg.yaml"
    port_config.save_config({"mixed_precision": "fp16", "gradient_accumulation_steps": 8, "num_processes": 2}, cfg)
    argv = ["--config_file", str(cfg), "--mixed_precision", "bf16", "script.py"]
    jax_args = jax_launch._load_config_into_args(jax_launch.launch_parser().parse_args(argv))
    port_args = port_launch._load_config_into_args(port_launch.launch_parser().parse_args(argv))
    for key in ("mixed_precision", "gradient_accumulation_steps", "num_processes", "max_restarts", "cpu"):
        assert getattr(port_args, key) == getattr(jax_args, key), key
    assert (port_args.mixed_precision, port_args.gradient_accumulation_steps) == ("bf16", 8)


CONFIGS = [
    {"num_machines": 1, "mixed_precision": "bf16", "mesh_data": -1},
    {"num_processes": 8, "mesh_fsdp": 8, "gradient_accumulation_steps": 2, "debug": True, "tpu_hosts": "a,b"},
    {"main_process_ip": "10.0.0.1", "main_process_port": 7777, "machine_rank": 1, "mesh_tensor": 4, "extra": 1},
]


@pytest.mark.parametrize("config", CONFIGS)
def test_config_files_load_alike_in_both_packages(config, tmp_path):
    """One text from both writers, and a file written by either loads to
    the same dict in both (unknown keys dropped by both readers)."""
    assert port_config._dump_yaml(config) == jax_config._dump_yaml(config)
    by_jax, by_port = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    jax_config.save_config(config, str(by_jax))
    port_config.save_config(config, str(by_port))
    loaded = [mod.load_config(str(p)) for mod in (jax_config, port_config) for p in (by_jax, by_port)]
    assert all(x == loaded[0] for x in loaded) and "extra" not in loaded[0]


LEGACY = [
    "dp: 2\ntp: 4\nprecision: bf16\nhosts: a,b\nunknown_key: 1\n",
    "mesh_data: 8\ndp: 2\n",
    "dp: 2\nmesh_data: 8\nnum_processes: '4'\n",
]


@pytest.mark.parametrize("text", LEGACY)
def test_update_config_migrates_like_the_jax_package(text, tmp_path):
    by_jax, by_port = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    by_jax.write_text(text)
    by_port.write_text(text)
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_config.update_config(str(by_port)) == jax_config.update_config(str(by_jax))
    assert by_port.read_text() == by_jax.read_text()


def test_config_default_path_is_the_ports_own(tmp_path):
    assert port_config.default_config_path() == str(tmp_path / "torch_home" / "default_config.yaml")
    assert port_config.default_config_path() != jax_config.default_config_path()
    args = port_config.config_parser().parse_args(["--default"])
    assert _stdout(port_config.config_command, args)[0] == 0
    assert port_config.load_config(port_config.default_config_path()) == {
        "num_machines": 1, "mixed_precision": "bf16", "mesh_data": -1}


# --------------------------------------------------------------------------- #
# migrate
# --------------------------------------------------------------------------- #

REFERENCE_CONFIGS = [
    # tests/test_cli.py::test_migrate_command's two inputs
    {"compute_environment": "LOCAL_MACHINE", "distributed_type": "FSDP", "mixed_precision": "bf16",
     "num_processes": 8, "num_machines": 2,
     "fsdp_config": {"fsdp_sharding_strategy": "FULL_SHARD", "fsdp_activation_checkpointing": True}},
    {"distributed_type": "MEGATRON_LM", "num_processes": 16,
     "megatron_lm_config": {"tp_degree": 4, "pp_degree": 2, "sequence_parallelism": True}},
    {"distributed_type": "DEEPSPEED", "deepspeed_config": {"zero_stage": 3, "offload_optimizer_device": "cpu"}},
    {"distributed_type": "DEEPSPEED", "deepspeed_config": {"zero_stage": 1}, "gpu_ids": "all"},
    {"distributed_type": "TP", "num_processes": 4},
    {"distributed_type": "MULTI_GPU", "num_processes": 8, "mixed_precision": "no", "use_cpu": False},
]
TEMPLATES = sorted((REPO / "examples" / "config_yaml_templates").glob("*.yaml"))


@pytest.mark.parametrize("ref", REFERENCE_CONFIGS + [p.name for p in TEMPLATES])
def test_migrate_converts_like_the_jax_package(ref, tmp_path):
    if isinstance(ref, str):
        ref = port_config._load_yaml((REPO / "examples" / "config_yaml_templates" / ref).read_text())
    assert port_migrate.convert_reference_config(ref) == jax_migrate.convert_reference_config(ref)
    src = tmp_path / "ref.yaml"
    src.write_text(port_config._dump_yaml(ref))
    args = types.SimpleNamespace(config_file=str(src), output_file=None, overwrite=False)
    assert _stdout(port_migrate.migrate_command, args) == _stdout(jax_migrate.migrate_command, args)


# --------------------------------------------------------------------------- #
# estimate-memory
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("text", ["7B", "124M", "350000", "1.1b", "2.5K"])
def test_parse_param_count_matches(text):
    assert port_estimate.parse_param_count(text) == jax_estimate.parse_param_count(text)


@pytest.mark.parametrize("num_params,devices,training", [(1_100_048_384, 1, True), (7 * 10**9, 8, True),
                                                          (124 * 10**6, 4, False)])
def test_estimate_table_matches(num_params, devices, training):
    assert (port_estimate.estimate_table(num_params, devices, training)
            == jax_estimate.estimate_table(num_params, devices, training))


def test_count_params_from_safetensors_matches(tmp_path):
    """A seeded file, and a directory of two, written by the port's writer."""
    rng = np.random.default_rng(24)
    for i in range(2):
        shapes = [tuple(int(d) for d in rng.integers(1, 40, size=rng.integers(1, 4))) for _ in range(5)]
        tensors = {f"t{j}": torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
                   for j, (s, dt) in enumerate(zip(shapes, (torch.float32, torch.bfloat16, torch.int8,
                                                            torch.float16, torch.int64)))}
        safetensors_io.save_file(tensors, tmp_path / f"part{i}.safetensors")
        if i == 0:
            want = sum(t.numel() for t in tensors.values())
            one = str(tmp_path / "part0.safetensors")
            assert port_estimate.count_params_from_safetensors(one) == jax_estimate.count_params_from_safetensors(
                one) == want
    assert (port_estimate.count_params_from_safetensors(str(tmp_path))
            == jax_estimate.count_params_from_safetensors(str(tmp_path)) > want)


def _fake_hf_cache(root, n_rows, n_cols, index_only):
    """A Hugging Face hub cache holding ``acme/tiny``: a safetensors file,
    or only its index and config (tests/test_cli.py's layout)."""
    repo_dir = root / "hub" / "models--acme--tiny"
    snap = repo_dir / "snapshots" / "rev0"
    snap.mkdir(parents=True)
    (repo_dir / "refs").mkdir()
    (repo_dir / "refs" / "main").write_text("rev0")
    if index_only:
        (snap / "model.safetensors.index.json").write_text(
            json.dumps({"metadata": {"total_size": n_rows * n_cols * 2}, "weight_map": {}}))
        (snap / "config.json").write_text(json.dumps({"torch_dtype": "bfloat16"}))
    else:
        safetensors_io.save_file({"w": torch.zeros(n_rows, n_cols)}, snap / "model.safetensors")


@pytest.mark.parametrize("index_only", [False, True])
def test_estimate_hub_repo_from_the_local_cache(index_only, monkeypatch, tmp_path):
    """A repo id resolves from the local HF cache, offline, as in the JAX
    command: the headers, else the index's total size over the dtype's width.
    ``huggingface_hub`` reads its cache location and offline flag when it is
    first imported, so the cache is passed to ``snapshot_download`` here and
    the metadata route, which would reach the network, raises."""
    import functools

    huggingface_hub = pytest.importorskip("huggingface_hub")
    _fake_hf_cache(tmp_path, 30, 10, index_only)

    def no_network(*args, **kwargs):
        raise OSError("the network route was taken")

    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        functools.partial(huggingface_hub.snapshot_download, cache_dir=str(tmp_path / "hub")))
    monkeypatch.setattr(huggingface_hub, "get_safetensors_metadata", no_network)
    got = port_estimate.count_params_from_hub("acme/tiny")
    assert got == jax_estimate.count_params_from_hub("acme/tiny") and got[0] == 300
    assert "local cache" in got[1]


def test_estimate_hub_metadata_mocked(monkeypatch, tmp_path):
    """The network route sums ``get_safetensors_metadata``'s parameter
    counts (tests/test_cli.py's mock; nothing reaches the network: the
    cache lookup is local-only, the metadata call is the mock)."""
    import functools

    huggingface_hub = pytest.importorskip("huggingface_hub")
    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        functools.partial(huggingface_hub.snapshot_download, cache_dir=str(tmp_path / "empty")))
    monkeypatch.setattr(huggingface_hub, "get_safetensors_metadata",
                        lambda repo_id, token=None: types.SimpleNamespace(parameter_count={"BF16": 1000, "F32": 24}))
    assert port_estimate.count_params_from_hub("acme/remote") == (1024, "hub safetensors metadata")


def test_estimate_fit_column_defaults_to_the_card(monkeypatch):
    """Without a card the fit column reads the H100 SXM's 80 GB; 7B trains
    in f32 with Adam in 104 GB, which does not fit; ``--jaxpr`` is item 11's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_estimate.estimate_parser().parse_args(["7B"])
    rc, out = _stdout(port_estimate.estimate_command, args)
    assert rc == 0 and "80.00 GiB per device" in out
    f32 = next(line for line in out.splitlines() if line.strip().startswith("float32"))
    assert f32.rstrip().endswith("no")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        port_estimate.estimate_command(port_estimate.estimate_parser().parse_args(["x.py::step", "--jaxpr"]))


# --------------------------------------------------------------------------- #
# checkpoints, on a checkpoint the port wrote
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """``checkpoints/`` of a tiny CPU run (two saves), and a copy with the
    second checkpoint garbled, a partial ``.tmp`` (no manifest) and a
    committed one whose rename was interrupted."""
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    root = tmp_path_factory.mktemp("ckpt")
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=str(root / "run"),
                                                                    automatic_checkpoint_naming=True))
    model = acc.prepare_model(RegressionModel())
    acc.prepare_optimizer(torch.optim.SGD(model.module.parameters(), lr=0.1))
    step = acc.build_train_step(linear_loss_fn)
    for i in range(2):
        step({"x": torch.full((4,), float(i)), "y": torch.full((4,), 3.0)})
        acc.save_state()
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    clean = root / "run" / "checkpoints"
    broken = root / "broken"
    shutil.copytree(clean, broken)
    corrupt_file(broken / "checkpoint_1" / "accelerate_state.json", mode="garbage")
    (broken / "checkpoint_2.tmp" / "model").mkdir(parents=True)
    (broken / "checkpoint_2.tmp" / "model" / "model.safetensors").write_bytes(b"\0" * 64)
    shutil.copytree(clean / "checkpoint_0", broken / "checkpoint_5.tmp")
    return {"clean": clean, "broken": broken}


CKPT_CASES = [
    ("list", {"format": "text", "deep": False}),
    ("list", {"format": "json", "deep": True}),
    ("verify", {"format": "json", "shallow": False, "selfcheck": False}),
    ("verify", {"format": "text", "shallow": True, "selfcheck": False}),
    ("gc", {"format": "json", "dry_run": True}),
    ("gc", {"format": "text", "dry_run": True}),
]


@pytest.mark.parametrize("which", ["clean", "broken"])
@pytest.mark.parametrize("command,opts", CKPT_CASES)
def test_checkpoints_commands_print_what_the_jax_command_prints(ckpt_dirs, which, command, opts):
    base = str(ckpt_dirs[which])
    args = types.SimpleNamespace(base_dir=base, path=base, **opts)
    fn = f"{command}_command"
    port = _stdout(getattr(port_ckpt, fn), args)
    assert port == _stdout(getattr(jax_ckpt, fn), args)
    if command == "verify" and opts["format"] == "json":
        results = json.loads(port[1])["results"]
        assert [r["valid"] for r in results] == ([True, True] if which == "clean" else [True, False])
    assert (Path(base) / "checkpoint_5.tmp").is_dir() == (which == "broken")  # a dry run recovers nothing


def test_checkpoints_describe_and_selfcheck(ckpt_dirs):
    """``describe`` on the saved topology: identical, 0 bytes moved, every
    recorded array counted; against another topology it is item 8's; the
    selfcheck passes; sarif goes through the port's reporter."""
    base = str(ckpt_dirs["clean"])
    args = types.SimpleNamespace(path=base, mesh=None, processes=None, dcn_axes=None, format="json")
    rc, out = _stdout(port_ckpt.describe_command, args)
    info = json.loads(out)
    assert rc == 0 and info["name"] == "checkpoint_1" and info["compatibility"] == "identical"
    assert info["saved_topology"]["process_count"] == 1 and info["reshard"]["total_bytes"] == 0
    assert info["reshard"]["array_count"] == len(info["saved_topology"]["arrays"]) > 0
    rc, out = _stdout(port_ckpt.describe_command, types.SimpleNamespace(**{**vars(args), "format": "sarif"}))
    assert rc == 0 and json.loads(out)["runs"][0]["results"][0]["ruleId"] == "CKPT002"
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port_ckpt.describe_command(types.SimpleNamespace(**{**vars(args), "processes": 2}))
    assert _stdout(port_ckpt.selfcheck_command, None)[0] == 0


# --------------------------------------------------------------------------- #
# tpu-config and the menu
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("extra", [[], ["--install_accelerate"], ["--install_accelerate", "--accelerate_version",
                                                                   "0.1.0", "--ssh_user", "me"]])
def test_tpu_config_debug_prints_the_jax_command(extra):
    argv = ["--hosts", "h1,h2", "--command", "echo hello", "--command", "echo world", "--debug", *extra]
    port = _stdout(port_tpu.tpu_command_launcher, port_tpu.tpu_command_parser().parse_args(argv))
    assert port == _stdout(jax_tpu.tpu_command_launcher, jax_tpu.tpu_command_parser().parse_args(argv))
    assert port[1].count("Running: ssh") == 2 and "echo hello; echo world" in port[1]
    with pytest.raises(ValueError, match="TPU"):
        port_tpu.tpu_command_launcher(port_tpu.tpu_command_parser().parse_args(
            ["--tpu_name", "mypod", "--command", "pip list", "--debug"]))


FALLBACK_CASES = [  # tests/test_menu.py's inputs: (choices, default index, typed)
    (["a", "b", "c"], 1, ""),
    (["a", "b", "c"], 0, "2"),
    (["no", "bf16", "fp16", "fp8"], 0, "b"),
    (["fp16", "fp8"], 0, "fp"),
    (["a", "b"], 0, "7"),
]


def _outcome(fn, *args, **kwargs):
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)
    except (ValueError, KeyboardInterrupt) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("choices,default,typed", FALLBACK_CASES)
def test_menu_fallback_matches(choices, default, typed):
    got = [_outcome(m._fallback_select, "pick", choices, default, input_fn=lambda _: typed)
           for m in (port_menu, jax_menu)]
    assert got[0] == got[1]


KEY_CASES = [  # (choices, default, keys)
    (["a", "b", "c"], 0, ["down", "down", "up", "enter"]),
    (["a", "b", "c"], 0, ["up", "enter"]),
    (["a", "b", "c"], 0, ["2", "enter"]),
    (["a", "b", "c"], 0, ["j", "j", "k", "enter"]),
    (["a", "b"], 0, ["interrupt"]),
]


@pytest.mark.parametrize("choices,default,keys", KEY_CASES)
def test_menu_keys_match(choices, default, keys, monkeypatch):
    got = []
    for m in (port_menu, jax_menu):
        it = iter(keys)
        monkeypatch.setattr(m, "_read_key", lambda stdin=None, it=it: next(it))
        got.append(_outcome(m._interactive_select, "pick", choices, default))
    assert got[0] == got[1]


def test_menu_select_non_tty_and_keymap(monkeypatch):
    assert port_menu._ESCAPE_SEQUENCES == jax_menu._ESCAPE_SEQUENCES
    outs = []
    for m in (port_menu, jax_menu):
        monkeypatch.setattr("sys.stdin", io.StringIO("1\n"))
        outs.append(_stdout(m.select, "pick", ["x", "y"]))
    assert outs[0] == outs[1] and outs[0][0] == "y" and "[0] x\n  [1] y" in outs[0][1]
    with pytest.raises(ValueError):
        port_menu.select("pick", [])


# --------------------------------------------------------------------------- #
# the small utilities
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("value", ["1", "yes", "On", "t", "0", "no", "", "off", "maybe"])
def test_str_to_bool_matches(value):
    assert _outcome(port_environment.str_to_bool, value) == _outcome(jax_environment.str_to_bool, value)


def test_environment_helpers_match(monkeypatch):
    monkeypatch.setenv("ACCELERATE_X", "7")
    monkeypatch.setenv("ACCELERATE_FLAG", "yes")
    for mod in (port_environment, jax_environment):
        assert mod.get_int_from_env(["UNSET_Y", "ACCELERATE_X"], 3) == 7
        assert mod.get_int_from_env(["UNSET_Y"], 3) == 3
        assert mod.parse_flag_from_env("ACCELERATE_FLAG") is True
        assert mod.parse_choice_from_env("UNSET_Y", "bf16") == "bf16"
        with mod.patch_environment(accelerate_x="9", new_key="1"):
            assert os.environ["ACCELERATE_X"] == "9" and os.environ["NEW_KEY"] == "1"
        assert os.environ["ACCELERATE_X"] == "7" and "NEW_KEY" not in os.environ
        assert mod.purge_accelerate_environment(lambda: "ACCELERATE_X" in os.environ)() is False
        with mod.clear_environment():
            assert not os.environ
        assert os.environ["ACCELERATE_X"] == "7"
        assert 0 < mod.get_free_port() < 65536


@pytest.mark.parametrize("args", [("2.11.0", ">=", "2.11"), ("2.11.0+cu128", "<", "2.11.1"), ("0.9", "==", "0.9.0"),
                                  ("1.2", "!=", "1.2"), ("numpy", ">", "1.0"), ("1.0", "~", "1.0")])
def test_compare_versions_matches(args):
    assert _outcome(port_versions.compare_versions, *args) == _outcome(jax_versions.compare_versions, *args)
    assert port_versions.is_torch_version(">=", "2.0")


def test_console_and_tqdm(capsys, monkeypatch):
    from accelerate_tpu_torch.utils import console
    from accelerate_tpu_torch.utils.tqdm import tqdm

    monkeypatch.setattr(console, "_console", console._PlainConsole())
    console.print_launch_failure(17, attempt=1)
    err = capsys.readouterr().err
    assert "launch failed" in err and "child process exited with code 17 (attempt 1)" in err
    pytest.importorskip("tqdm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ACCELERATE_USE_CPU", "1")
    assert list(tqdm(range(3))) == [0, 1, 2]
    with pytest.raises(ValueError, match="main_process_only"):
        tqdm(True, range(3))


# --------------------------------------------------------------------------- #
# the port's own: merge-weights, test, env, and the environment a script reads
# --------------------------------------------------------------------------- #


def test_merge_weights_round_trip(tmp_path):
    """A saved tiny Llama's model merged into shards of at most 100 KB: more
    than one shard and an index, every tensor bit-equal to the checkpoint's;
    ``estimate-memory`` on the merged directory counts the model's
    parameters; a directory without a model is refused."""
    from accelerate_tpu_torch.commands import merge

    acc = Accelerator(cpu=True)
    model = acc.prepare_model(create_llama_model(LlamaConfig.tiny(), seed=0, device="cpu"))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters()))
    acc.save_state(str(tmp_path / "ckpt"))
    out = tmp_path / "merged"
    rc, _ = _stdout(merge.merge_command, merge.merge_parser().parse_args([str(tmp_path / "ckpt"), str(out),
                                                                         "--max_shard_size", "100KB"]))
    assert rc == 0
    index = json.loads((out / "model.safetensors.index.json").read_text())
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 1
    merged = {}
    for name in shards:
        merged.update(safetensors_io.load_file(str(out / name)))
    saved = safetensors_io.load_file(str(tmp_path / "ckpt" / "model" / "model.safetensors"))
    assert merged.keys() == saved.keys() and all(torch.equal(merged[k], saved[k]) for k in saved)
    n = sum(p.numel() for p in model.module.parameters())
    rc, text = _stdout(port_estimate.estimate_command, port_estimate.estimate_parser().parse_args([str(out)]))
    assert rc == 0 and f"Memory estimate for {n:,} parameters" in text
    with pytest.raises(FileNotFoundError, match="no model checkpoint"):
        merge.merge_command(merge.merge_parser().parse_args([str(tmp_path), str(tmp_path / "x")]))


def test_test_command_on_the_cpu(capfd):
    """``test --cpu`` runs the self-checking script through the launcher."""
    from accelerate_tpu_torch.commands.test import test_command, test_parser

    assert test_command(test_parser().parse_args(["--cpu"])) == 0
    out = capfd.readouterr().out
    assert "ALL CHECKS PASSED" in out and "training parity [fp16] OK" in out and "Test is a success" in out


def test_launched_mesh_above_one_card_is_refused(tmp_path, capfd):
    """``--mesh_fsdp 4``: the script's ``Accelerator()`` refuses the mesh
    with item 8's message and the launch exits non-zero."""
    script = tmp_path / "script.py"
    script.write_text("from accelerate_tpu_torch import Accelerator\nAccelerator()\n")
    rc = port_launch.launch_command(port_launch.launch_parser().parse_args(["--cpu", "--mesh_fsdp", "4",
                                                                            str(script)]))
    err = capfd.readouterr().err
    assert rc != 0
    assert "NotImplementedError" in err and "'fsdp': 4" in err and "Queue 1 item 8" in err
    assert "launch failed" in err  # print_launch_failure's banner


def test_env_command_without_a_card(monkeypatch):
    from accelerate_tpu_torch.commands import env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _stdout(env.env_command)
    assert rc == 0 and f"`torch version`: {torch.__version__}" in out and "no CUDA card" in out


def test_accelerator_reads_the_launchers_environment(monkeypatch):
    """What the launcher sets, read as the JAX package reads it: the
    gradient accumulation (the fault fixed with this test), mixed precision
    and the CPU; a world or a mesh axis above 1 is refused with item 8's
    message, as ``WORLD_SIZE`` and ``MeshConfig`` are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", "3")
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "bf16")
    monkeypatch.setenv("ACCELERATE_USE_CPU", "1")
    acc = Accelerator()
    assert (acc.gradient_accumulation_steps, acc.mixed_precision, acc.device.type) == (3, "bf16", "cpu")
    for key, value, match in (("ACCELERATE_NUM_PROCESSES", "2", "ACCELERATE_NUM_PROCESSES=2"),
                              ("ACCELERATE_MESH_TENSOR", "2", "'tensor': 2"),
                              ("ACCELERATE_MESH_NUM_DEVICES", "4", "num_devices=4")):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        with monkeypatch.context() as m:
            m.setenv(key, value)
            with pytest.raises(NotImplementedError, match=match) as ei:
                Accelerator()
            assert "Queue 1 item 8" in str(ei.value)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    monkeypatch.setenv("ACCELERATE_MESH_DATA", "-1")
    monkeypatch.setenv("ACCELERATE_MESH_FSDP", "1")
    assert Accelerator().device.type == "cpu"  # axes of 1 or -1 are one card's


def test_get_launch_command_starts_the_ports_launcher():
    from accelerate_tpu.test_utils.testing import get_launch_command as jax_command
    from accelerate_tpu_torch.test_utils.testing import get_launch_command

    assert get_launch_command(2) == [sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
                                     "--num_processes", "2"]
    assert [a.replace("accelerate_tpu_torch", "accelerate_tpu") for a in get_launch_command(2)] == jax_command(2)
