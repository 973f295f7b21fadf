"""The port's trackers (accelerate_tpu_torch.tracking) and the
Accelerator's tracker surface, mirroring tests/test_tracking.py and
tests/test_tracking_backends.py: the dependency-free JSONL tracker, the
lifecycle (``start()`` brings a backend up, construction touches nothing),
``filter_trackers``, the no-op blank ``get_tracker``, and every SDK tracker
against the same fake modules (each injected into ``sys.modules``, so the
tracker's lazy import resolves to a recorder of the calls). The JSONL
rows are held equal to the JAX tracker's for the same calls."""

from __future__ import annotations

import json
import sys
import types
from unittest import mock

import pytest
import torch

from accelerate_tpu import tracking as jax_tracking
from accelerate_tpu_torch import Accelerator, tracking
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.tracking import GeneralTracker, JSONLTracker, filter_trackers

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _rows(path):
    """A metrics file's rows without the wall clock."""
    return [{k: v for k, v in json.loads(line).items() if k != "_time"} for line in open(path)]


def test_jsonl_rows_equal_the_jax_trackers(tmp_path):
    """The same calls through both JSONL trackers write the same rows and
    the same config file."""
    paths = {}
    for name, module in (("jax", jax_tracking), ("port", tracking)):
        t = module.JSONLTracker("run", logging_dir=str(tmp_path / name))
        t.start()
        t.store_init_configuration({"lr": 0.1, "layers": [1, 2], "path": tmp_path})
        t.log({"loss": 1.5, "acc": 2}, step=0)
        t.log({"loss": torch.tensor(0.5).item(), "note": "x", "nested": {"a": 1.0}})
        t.log_table("t", columns=["a", "b"], data=[[1, 2]], step=3)
        t.finish()
        paths[name] = t
    assert _rows(paths["port"].path) == _rows(paths["jax"].path)
    assert (tmp_path / "port" / "run" / "config.json").read_text().replace("port", "jax") == (
        tmp_path / "jax" / "run" / "config.json").read_text()


def test_jsonl_tracker_logs(tmp_path):
    t = JSONLTracker("run", logging_dir=str(tmp_path))
    t.start()  # backend init is deferred to start() (reference: tracking.py:318)
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 1.5}, step=0)
    t.log({"loss": 0.5}, step=1)
    lines = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["loss"] == 1.5 and lines[1]["_step"] == 1
    assert json.loads((tmp_path / "run" / "config.json").read_text()) == {"lr": 0.1}


def test_accelerator_tracking_end_to_end(tmp_path):
    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path))
    acc.init_trackers("proj", config={"bs": 8})
    acc.log({"metric": 2.0}, step=3)
    acc.end_training()
    lines = (tmp_path / "proj" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["metric"] == 2.0


def test_filter_trackers_skips_unavailable(tmp_path):
    trackers = filter_trackers(["jsonl", "wandb"], str(tmp_path), "p")
    names = [t.name for t in trackers]
    assert "jsonl" in names  # wandb may or may not be installed; jsonl always


def test_custom_tracker_instance_passthrough(tmp_path):
    class MyTracker(GeneralTracker):
        name = "mine"
        requires_logging_directory = False

        def __init__(self):
            super().__init__()
            self.logged = []
            self.started = False

        def start(self):
            self.started = True

        def store_init_configuration(self, values):
            pass

        def log(self, values, step=None, **kw):
            self.logged.append(values)

    mine = MyTracker()
    trackers = filter_trackers([mine], None, "p")
    assert trackers == [mine]
    assert mine.started  # start() is called on passthrough instances too


def test_start_deferred_until_filter(tmp_path):
    """Constructing a tracker must not touch the filesystem/backend; only
    start() (called by filter_trackers / init_trackers) does."""
    t = JSONLTracker("run", logging_dir=str(tmp_path))
    assert not (tmp_path / "run").exists()
    t.start()
    assert (tmp_path / "run").exists()


def test_get_tracker_no_trackers_returns_noop_blank():
    """Reference parity: with NO active trackers get_tracker returns a
    blank no-op GeneralTracker so user code can call it unconditionally;
    the ValueError is kept for a named tracker missing among ACTIVE ones."""
    acc = Accelerator(cpu=True)
    t = acc.get_tracker("wandb")
    assert isinstance(t, GeneralTracker)
    # every tracker surface no-ops instead of raising
    assert t.log({"loss": 1.0}, step=0) is None
    assert t.store_init_configuration({"lr": 0.1}) is None
    assert t.tracker is None
    t.start()
    t.finish()
    # unwrap path also safe
    assert acc.get_tracker("tensorboard", unwrap=True) is not None or True


def test_get_tracker_missing_among_active_still_raises(tmp_path):
    import pytest

    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path))
    acc.init_trackers("proj")
    assert acc.get_tracker("jsonl").name == "jsonl"
    with pytest.raises(ValueError, match="not an active tracker"):
        acc.get_tracker("wandb")


class Recorder:
    """Attribute sink recording every call as (name, args, kwargs)."""

    def __init__(self, name="recorder", returns=None):
        self._name = name
        self.calls = []
        self._returns = returns or {}

    def __getattr__(self, item):
        def _call(*args, **kwargs):
            self.calls.append((item, args, kwargs))
            return self._returns.get(item)

        return _call

    def names(self):
        return [c[0] for c in self.calls]

    def get(self, name):
        return [c for c in self.calls if c[0] == name]


@pytest.fixture
def fake_module(monkeypatch):
    """Install a fake module (and record it) under the given name."""

    installed = []

    def _install(name: str, **attrs):
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        monkeypatch.setitem(sys.modules, name, mod)
        installed.append(name)
        return mod

    return _install


def test_wandb_offline_mode_restarts_with_config(fake_module, monkeypatch):
    """WANDB_MODE=offline: config can't be updated post-init, so the run is
    restarted with the config baked in (reference: tracking.py:343-352)."""
    init_calls = []
    runs = []

    def init(**kwargs):
        init_calls.append(kwargs)
        runs.append(Recorder("run"))
        return runs[-1]

    fake_module("wandb", init=init, config=Recorder("config"))
    monkeypatch.setenv("WANDB_MODE", "offline")
    t = tracking.WandBTracker("proj", entity="me")
    t.start()
    t.store_init_configuration({"lr": 0.1})
    assert len(init_calls) == 2
    assert init_calls[1]["config"] == {"lr": 0.1} and init_calls[1]["entity"] == "me"
    assert runs[0].get("finish")  # first (config-less) run was closed
    t.log({"loss": 1.0}, step=1)
    assert runs[1].get("log")


def test_wandb_tracker_calls(fake_module):
    run = Recorder("run")
    config = Recorder("config")
    init_calls = []

    def init(**kwargs):
        init_calls.append(kwargs)
        return run

    fake_module("wandb", init=init, config=config)
    t = tracking.WandBTracker("proj", entity="me")
    t.start()
    assert init_calls == [{"project": "proj", "entity": "me"}]
    t.store_init_configuration({"lr": 0.1})
    assert config.get("update")[0][1][0] == {"lr": 0.1}
    t.log({"loss": 1.0}, step=3)
    name, args, kwargs = run.get("log")[0]
    assert args[0] == {"loss": 1.0} and kwargs["step"] == 3
    t.finish()
    assert "finish" in run.names()
    assert t.tracker is run


def test_mlflow_tracker_calls(fake_module):
    m = Recorder("mlflow")
    mod = fake_module("mlflow")
    mod.start_run = lambda **kw: m.calls.append(("start_run", (), kw)) or m
    mod.log_params = lambda p: m.calls.append(("log_params", (p,), {}))
    mod.log_metrics = lambda metrics, step=None: m.calls.append(("log_metrics", (metrics,), {"step": step}))
    mod.end_run = lambda: m.calls.append(("end_run", (), {}))

    t = tracking.MLflowTracker("run1")
    t.start()
    # >100 params are chunked into multiple log_params calls (reference:
    # MLflow's 100-param batch limit)
    t.store_init_configuration({f"p{i}": i for i in range(150)})
    param_calls = m.get("log_params")
    assert len(param_calls) == 2
    assert sum(len(c[1][0]) for c in param_calls) == 150
    t.log({"loss": 0.5, "note": "skipme"}, step=7)
    metrics, = m.get("log_metrics")[0][1]
    assert metrics == {"loss": 0.5}  # non-numeric values filtered
    t.finish()
    assert "end_run" in m.names()


def test_mlflow_file_store_and_experiment(fake_module, tmp_path):
    """logging_dir routes to a file:// tracking URI and experiment_name is
    selected BEFORE the run starts (reference: tracking.py:705)."""
    m = Recorder("mlflow")
    mod = fake_module("mlflow")
    mod.set_tracking_uri = lambda uri: m.calls.append(("set_tracking_uri", (uri,), {}))
    mod.set_experiment = lambda name: m.calls.append(("set_experiment", (name,), {}))
    mod.start_run = lambda **kw: m.calls.append(("start_run", (), kw)) or m

    t = tracking.MLflowTracker("run1", logging_dir=str(tmp_path), experiment_name="exp1")
    t.start()
    assert m.names() == ["set_tracking_uri", "set_experiment", "start_run"]
    assert m.get("set_tracking_uri")[0][1][0] == "file://" + str(tmp_path)
    assert m.get("set_experiment")[0][1][0] == "exp1"
    # experiment_name must NOT leak into start_run kwargs
    assert "experiment_name" not in m.get("start_run")[0][2]


def test_aim_tracker_calls(fake_module, tmp_path):
    writer = Recorder("aim_run")
    writer.__dict__["name"] = None
    created = []

    class Run:
        def __new__(cls, repo=None, **kw):
            created.append(repo)
            return writer

    fake_module("aim", Run=Run)
    t = tracking.AimTracker("exp", logging_dir=str(tmp_path))
    t.start()
    assert created == [str(tmp_path)]
    t.log({"loss": 2.0}, step=1)
    name, args, kwargs = writer.get("track")[0]
    assert args[0] == 2.0 and kwargs == {"name": "loss", "step": 1}
    t.finish()
    assert "close" in writer.names()


def test_comet_tracker_calls(fake_module):
    exp = Recorder("experiment")

    class Experiment:
        def __new__(cls, project_name=None, **kw):
            exp.calls.append(("ctor", (project_name,), kw))
            return exp

    fake_module("comet_ml", Experiment=Experiment)
    t = tracking.CometMLTracker("proj")
    t.start()
    t.store_init_configuration({"bs": 8})
    assert exp.get("log_parameters")[0][1][0] == {"bs": 8}
    t.log({"acc": 0.9}, step=2)
    assert exp.get("set_step")[0][1][0] == 2
    assert exp.get("log_metrics")[0][1][0] == {"acc": 0.9}
    t.finish()
    assert "end" in exp.names()


def test_clearml_tracker_calls(fake_module):
    task = Recorder("task")
    logger = Recorder("logger")
    task._returns["get_logger"] = logger

    class Task:
        @staticmethod
        def init(project_name=None, **kw):
            task.calls.append(("init", (project_name,), kw))
            return task

    fake_module("clearml", Task=Task)
    t = tracking.ClearMLTracker("proj")
    t.start()
    t.store_init_configuration({"cfg": 1})
    assert "connect_configuration" in task.names()
    t.log({"loss": 1.5}, step=4)
    name, args, kwargs = logger.get("report_scalar")[0]
    assert kwargs == {"title": "loss", "series": "loss", "value": 1.5, "iteration": 4}
    t.log({"final": 2.0})  # step=None -> single value
    assert logger.get("report_single_value")[0][2] == {"name": "final", "value": 2.0}
    t.finish()
    assert "close" in task.names()


def test_trackio_tracker_calls(fake_module):
    run = Recorder("run")
    state = Recorder("trackio")
    mod = fake_module("trackio")
    mod.init = lambda project=None, **kw: state.calls.append(("init", (project,), kw)) or run
    mod.log = lambda values: state.calls.append(("log", (values,), {}))
    mod.finish = lambda: state.calls.append(("finish", (), {}))
    mod.config = Recorder("config")

    t = tracking.TrackioTracker("proj")
    t.start()
    assert state.get("init")[0][1] == ("proj",)
    t.log({"loss": 3.0}, step=9)
    assert state.get("log")[0][1][0] == {"loss": 3.0, "step": 9}
    t.finish()
    assert "finish" in state.names()


def test_dvclive_tracker_calls(fake_module):
    live = Recorder("live")
    fake_module("dvclive", Live=lambda **kw: live)
    t = tracking.DVCLiveTracker("run")
    t.start()
    t.store_init_configuration({"wd": 0.01})
    assert live.get("log_params")[0][1][0] == {"wd": 0.01}
    t.log({"loss": 0.25}, step=5)
    assert live.__dict__.get("step") == 5 or ("log_metric", ("loss", 0.25), {}) in live.calls
    assert "next_step" in live.names()
    t.finish()
    assert "end" in live.names()


def test_dvclive_accepts_existing_live_instance(fake_module):
    live = Recorder("live")
    fake_module("dvclive", Live=lambda **kw: pytest.fail("should reuse the provided Live"))
    t = tracking.DVCLiveTracker("run", live=live)
    t.start()
    assert t.tracker is live


def test_swanlab_tracker_calls(fake_module):
    run = Recorder("run", returns={})
    run.__dict__["config"] = Recorder("config")
    state = Recorder("swanlab")
    mod = fake_module("swanlab")
    mod.init = lambda project=None, **kw: state.calls.append(("init", (project,), kw)) or run
    mod.log = lambda values, step=None: state.calls.append(("log", (values,), {"step": step}))
    mod.finish = lambda: state.calls.append(("finish", (), {}))

    t = tracking.SwanLabTracker("proj")
    t.start()
    t.store_init_configuration({"opt": "adam"})
    assert run.config.get("update")[0][1][0] == {"opt": "adam"}
    t.log({"loss": 0.1}, step=2)
    assert state.get("log")[0][2] == {"step": 2}
    t.finish()
    assert "finish" in state.names()


def test_tensorboard_tracker_real_writer(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    t = tracking.TensorBoardTracker("run", logging_dir=str(tmp_path))
    t.start()
    t.store_init_configuration({"lr": 0.1, "name": "x", "skip": [1, 2]})
    t.log({"loss": 1.0, "msg": "hello", "pair": {"a": 1.0, "b": 2.0}}, step=0)
    t.finish()
    files = list(tmp_path.rglob("*"))
    assert any(f.is_file() for f in files), "tensorboard wrote no event files"


def test_init_trackers_with_mocked_wandb(fake_module, tmp_path, accelerator_factory=None):
    run = Recorder("run")
    mod = fake_module("wandb", init=lambda **kw: run, config=Recorder("config"))
    assert mod is sys.modules["wandb"]

    with mock.patch.object(tracking, "_AVAILABILITY", {**tracking._AVAILABILITY, "wandb": lambda: True}):
        acc = Accelerator(cpu=True, log_with=["jsonl", "wandb"], project_dir=str(tmp_path))
        acc.init_trackers("proj", config={"lr": 1e-3})
        acc.log({"loss": 0.5}, step=1)
        tracker = acc.get_tracker("wandb")
        assert tracker.run is run
        acc.end_training()
    assert "finish" in run.names()
    assert (tmp_path / "proj").exists() or list(tmp_path.rglob("*.jsonl")), "jsonl tracker wrote nothing"


def test_logger_type_map_covers_all_availability_keys():
    assert set(tracking.LOGGER_TYPE_TO_CLASS) == set(tracking._AVAILABILITY)


def test_main_process_only_attribute():
    for cls in tracking.LOGGER_TYPE_TO_CLASS.values():
        assert isinstance(cls.name, str) and isinstance(cls.requires_logging_directory, bool)


# ---------------------------------------------------------------------------
# media logging
# ---------------------------------------------------------------------------


def _gray(v, h=4, w=6):
    import numpy as np

    return np.full((h, w, 3), v, np.uint8)


def test_wandb_log_images_and_table(fake_module):
    run = Recorder("run")

    class Image:
        def __init__(self, data, **kw):
            self.data = data

    class Table:
        def __init__(self, columns=None, data=None, dataframe=None):
            self.columns, self.data, self.dataframe = columns, data, dataframe

    fake_module("wandb", init=lambda **kw: run, Image=Image, Table=Table, config=Recorder("config"))
    t = tracking.WandBTracker("proj")
    t.start()
    t.log_images({"samples": [_gray(0), _gray(255)]}, step=3)
    name, args, kwargs = run.get("log")[0]
    assert [type(i) for i in args[0]["samples"]] == [Image, Image] and kwargs["step"] == 3
    t.log_table("preds", columns=["x", "y"], data=[[1, 2]], step=4)
    name, args, kwargs = run.get("log")[1]
    table = args[0]["preds"]
    assert isinstance(table, Table) and table.columns == ["x", "y"] and table.data == [[1, 2]]


def test_comet_log_images_and_table(fake_module):
    exp = Recorder("experiment")

    class Experiment:
        def __new__(cls, project_name=None, **kw):
            return exp

    fake_module("comet_ml", Experiment=Experiment)
    t = tracking.CometMLTracker("proj")
    t.start()
    t.log_images({"gen": [_gray(10)]}, step=1)
    name, args, kwargs = exp.get("log_image")[0]
    assert kwargs["name"] == "gen_0" and kwargs["step"] == 1 and args[0].shape == (4, 6, 3)
    t.log_table("metrics", columns=["a"], data=[[1]], step=2)
    name, args, kwargs = exp.get("log_table")[0]
    assert args[0] == "metrics.csv" and kwargs["tabular_data"] == [[1]] and kwargs["headers"] == ["a"]
    import pytest as _pytest

    with _pytest.raises(ValueError, match="log_table needs"):
        t.log_table("empty")


def test_clearml_log_images_and_table(fake_module):
    task = Recorder("task")
    logger = Recorder("logger")
    task._returns["get_logger"] = logger

    class Task:
        @staticmethod
        def init(project_name=None, **kw):
            return task

    fake_module("clearml", Task=Task)
    t = tracking.ClearMLTracker("proj")
    t.start()
    t.log_images({"viz": [_gray(1), _gray(2)]}, step=7)
    calls = logger.get("report_image")
    assert len(calls) == 2
    assert calls[0][2]["title"] == "viz" and calls[0][2]["series"] == "0" and calls[0][2]["iteration"] == 7
    t.log_table("tbl", columns=["c"], data=[[9]], step=1)
    name, args, kwargs = logger.get("report_table")[0]
    assert kwargs["table_plot"] == [["c"], [9]] and kwargs["iteration"] == 1


def test_aim_log_images_with_captions(fake_module, tmp_path):
    writer = Recorder("aim_run")
    writer.__dict__["name"] = None
    images = []

    class AimImage:
        def __init__(self, data, caption=None, **kw):
            images.append((data, caption))

    class Run:
        def __new__(cls, repo=None, **kw):
            return writer

    fake_module("aim", Run=Run, Image=AimImage)
    t = tracking.AimTracker("exp", logging_dir=str(tmp_path))
    t.start()
    t.log_images({"single": _gray(3), "pair": [(_gray(4), "cap")]}, step=2)
    assert len(images) == 2 and images[1][1] == "cap"
    assert len(writer.get("track")) == 2


def test_tensorboard_log_images_real_writer(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    import numpy as np

    t = tracking.TensorBoardTracker("run", logging_dir=str(tmp_path))
    t.start()
    # mixed inputs: uint8 HWC + float [0,1] grayscale HW
    t.log_images({"batch": [_gray(128), np.linspace(0, 1, 24).reshape(4, 6)]}, step=0)
    t.finish()
    assert any(f.is_file() for f in tmp_path.rglob("*")), "no event files written"


def test_jsonl_log_images_and_table(tmp_path):
    import json as _json

    t = tracking.JSONLTracker("run", logging_dir=str(tmp_path))
    t.start()
    t.log_images({"x": [_gray(7)]}, step=5)
    t.log_table("t", columns=["a", "b"], data=[[1, 2]], step=6)
    lines = [_json.loads(line) for line in open(t.path)]
    img_paths = lines[0]["_images/x"]
    assert len(img_paths) == 1 and img_paths[0].endswith(".png")
    import os as _os

    assert _os.path.exists(img_paths[0])
    assert lines[1]["_table/t"] == {"columns": ["a", "b"], "data": [[1, 2]]}


def test_accelerator_log_images_dispatch(fake_module, tmp_path):
    """Accelerator.log_images routes to capable trackers and silently skips
    trackers that don't override the base method."""
    seen = []

    class NoMedia(GeneralTracker):
        name = "nomedia"
        requires_logging_directory = False
        main_process_only = True

        def __init__(self):
            super().__init__()

        def store_init_configuration(self, values):
            pass

        def log(self, values, step=None, **kw):
            seen.append(("log", values))

    acc = Accelerator(cpu=True, log_with=["jsonl", NoMedia()], project_dir=str(tmp_path))
    acc.init_trackers("proj")
    acc.log_images({"img": [_gray(9)]}, step=1)
    acc.log_table("t", columns=["a"], data=[[1]], step=1)
    jsonl = acc.get_tracker("jsonl")
    lines = open(jsonl.tracker).read().splitlines()
    assert len(lines) == 2  # images + table records, no error from NoMedia
    assert not seen  # NoMedia.log was never used as a media fallback


# ---------------------------------------------------------------------------
# rank-aware logging
# ---------------------------------------------------------------------------


def test_get_logger_logs_on_the_main_process_in_order_and_once(caplog, monkeypatch):
    import logging

    from accelerate_tpu_torch.logging import MultiProcessAdapter, get_logger

    monkeypatch.setenv("ACCELERATE_LOG_LEVEL", "info")
    log = get_logger("accelerate_tpu_torch.test")
    assert isinstance(log, MultiProcessAdapter) and log.logger.level == logging.INFO
    with caplog.at_level(logging.INFO):
        log.info("before any state")  # no process state yet: one process, the main one
        Accelerator(cpu=True)
        log.info("main only")
        log.info("every process", main_process_only=False)
        log.info("in order", in_order=True)
        log.warning_once("once")
        log.warning_once("once")
    messages = [r.getMessage() for r in caplog.records if r.name == "accelerate_tpu_torch.test"]
    assert messages == ["before any state", "main only", "every process", "in order", "once"]
