"""Experiment trackers.

Counterpart of :mod:`accelerate_tpu.tracking`: the ``GeneralTracker`` base
(``name`` / ``requires_logging_directory`` / ``start`` /
``store_init_configuration`` / ``log`` / ``finish``, main-process gating
through :func:`on_main_process`, a no-op blank), the dependency-free
``JSONLTracker`` (one JSON object a ``log`` call in
``{logging_dir}/{run_name}/metrics.jsonl``), and the SDK trackers
(TensorBoard, WandB, MLflow, Aim, CometML, ClearML, Trackio, DVCLive,
SwanLab), each importing its package only in ``start()`` / ``log()`` and
offered by :func:`filter_trackers` only where the package is installed.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Optional

from .logging import get_logger
from .state import PartialState
from .utils.dataclasses import LoggerType
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_swanlab_available,
    is_tensorboard_available,
    is_trackio_available,
    is_wandb_available,
)

logger = get_logger(__name__)


def _is_main_process() -> bool:
    """The process state's answer, or True where no state exists yet (one
    process; a tracker never creates the state, which would pick a
    device)."""
    return not PartialState._shared_state.get("_initialized") or PartialState().is_main_process


def on_main_process(function):
    """Method decorator: run only on the main process (upstream Accelerate:
    tracking.py:77)."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True) and not _is_main_process():
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """(upstream Accelerate: tracking.py:101). Subclass contract: class attrs ``name``
    and ``requires_logging_directory``; methods ``store_init_configuration``
    and ``log``; optionally ``start``, ``finish`` and a ``tracker`` property.

    Lifecycle (upstream Accelerate: tracking.py:318): ``__init__`` only records
    arguments; the backend (wandb run, SummaryWriter, ...) is created in
    ``start()``, which ``Accelerator.init_trackers`` calls on the main
    process. Constructing a tracker on a worker rank is therefore free and
    side-effect-less."""

    main_process_only = True

    def __init__(self, _blank: bool = False):
        """``_blank=True`` builds a NO-OP tracker (upstream Accelerate:
        tracking.py:110 + ``Accelerator.get_tracker`` with no active
        trackers) — every method accepts its arguments and does nothing,
        so user code can call ``get_tracker(...).log(...)``
        unconditionally."""
        self._blank = _blank
        if _blank:
            self.name = ""
            self.requires_logging_directory = False
            return
        for attr in ("name", "requires_logging_directory"):
            if not hasattr(self, attr):
                raise NotImplementedError(f"Tracker subclass must define `{attr}`")

    def start(self):
        """Initialise the tracking backend. Idempotence is the subclass's
        concern; ``filter_trackers``/``init_trackers`` call it exactly once."""

    @property
    def tracker(self):
        if getattr(self, "_blank", False):
            return None
        raise NotImplementedError

    def store_init_configuration(self, values: dict):
        if getattr(self, "_blank", False):
            return None
        raise NotImplementedError

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if getattr(self, "_blank", False):
            return None
        raise NotImplementedError

    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """Log ``{name: [HWC uint8/float arrays or PIL images]}`` media
        (upstream Accelerate: tracking.py:272/:373/:666/:998 — per-tracker
        ``log_images``). Base raises: ``Accelerator.log_images`` dispatches
        only to trackers that override this."""
        raise NotImplementedError(f"{type(self).__name__} does not support image logging")

    def log_table(
        self,
        table_name: str,
        columns: Optional[list] = None,
        data: Optional[list] = None,
        dataframe=None,
        step: Optional[int] = None,
        **kwargs,
    ):
        """Log a table from ``columns``+``data`` rows or a ``dataframe``
        (upstream Accelerate: tracking.py:392/:1016)."""
        raise NotImplementedError(f"{type(self).__name__} does not support table logging")

    def finish(self):
        pass


def _as_hwc_uint8(image):
    """Normalise one image (PIL / [H,W] / [H,W,C] float-or-int array) to an
    HWC uint8 numpy array — the common currency every media sink accepts.
    Floats are assumed in [0, 1] (the diffusion example's output range)."""
    import numpy as np

    if hasattr(image, "mode"):  # PIL.Image duck-type
        return np.asarray(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if np.issubdtype(arr.dtype, np.floating):
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    elif arr.dtype != np.uint8:  # int16/32/64 pixels are already 0-255
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


class JSONLTracker(GeneralTracker):
    """Dependency-free default: one JSON object per log call, appended to
    ``{logging_dir}/{run_name}/metrics.jsonl``, so a machine without any
    tracker package always has one."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        self.run_name = run_name
        self.dir = os.path.join(logging_dir, run_name)
        self.path = os.path.join(self.dir, "metrics.jsonl")

    @on_main_process
    def start(self):
        os.makedirs(self.dir, exist_ok=True)

    @property
    def tracker(self):
        return self.path

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(values, f, indent=2, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = step
        record.update(values)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """PNGs under ``{run}/media/`` (PIL; falls back to .npy without it),
        with their paths appended to the metrics stream."""
        media_dir = os.path.join(self.dir, "media")
        os.makedirs(media_dir, exist_ok=True)
        paths = {}
        for k, images in values.items():
            paths[k] = []
            for i, image in enumerate(images):
                arr = _as_hwc_uint8(image)
                stem = f"{k.replace('/', '_')}_{step if step is not None else 'x'}_{i}"
                try:
                    from PIL import Image

                    path = os.path.join(media_dir, stem + ".png")
                    Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr).save(path)
                except ImportError:
                    import numpy as np

                    path = os.path.join(media_dir, stem + ".npy")
                    np.save(path, arr)
                paths[k].append(path)
        self.log({f"_images/{k}": v for k, v in paths.items()}, step=step)

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None, step=None, **kwargs):
        if dataframe is not None:
            columns = list(dataframe.columns)
            data = dataframe.values.tolist()
        elif data is None:
            raise ValueError("log_table needs `data` (with optional `columns`) or `dataframe`")
        self.log({f"_table/{table_name}": {"columns": columns, "data": data}}, step=step)


class TensorBoardTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:182). Uses tensorboardX or
    torch.utils.tensorboard, whichever is importable."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(self.logging_dir, **self._init_kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(
            {k: v for k, v in values.items() if isinstance(v, (int, float, str, bool))}, metric_dict={}
        )
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """Accepts ``{name: [images]}``; images are normalised to a stacked
        NHWC uint8 batch, as the JAX package stacks them."""
        import numpy as np

        for k, v in values.items():
            imgs = [_as_hwc_uint8(image) for image in v]
            # a batch may mix grayscale/RGB/RGBA inputs — stack needs one
            # depth: drop alpha, broadcast grayscale
            imgs = [
                i[..., :3] if i.shape[-1] >= 3 else np.repeat(i[..., :1], 3, axis=-1)
                for i in imgs
            ]
            self.writer.add_images(k, np.stack(imgs), global_step=step, dataformats="NHWC", **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:297)."""

    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        import wandb

        self.run = wandb.init(project=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import os

        import wandb

        offline = os.environ.get("WANDB_MODE") == "offline" or self._init_kwargs.get("mode") == "offline"
        if offline:
            # offline runs can't mutate config after init — restart the run
            # with the config baked in (upstream Accelerate: tracking.py:343-352);
            # merge over any config the tracker was constructed with
            if getattr(self, "run", None):
                self.run.finish()
            init_kwargs = dict(self._init_kwargs)
            base = init_kwargs.pop("config", None)
            config = {**base, **values} if isinstance(base, dict) else values
            self.run = wandb.init(project=self.run_name, config=config, **init_kwargs)
            return
        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """(upstream Accelerate: tracking.py:373)."""
        import wandb

        for k, v in values.items():
            self.log({k: [wandb.Image(image) for image in v]}, step=step, **kwargs)

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None, step=None, **kwargs):
        """(upstream Accelerate: tracking.py:392)."""
        import wandb

        if data is None and dataframe is None:
            raise ValueError("log_table needs `data` (with optional `columns`) or `dataframe`")
        self.log({table_name: wandb.Table(columns=columns, data=data, dataframe=dataframe)}, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:705)."""

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__()
        self.run_name = run_name
        self.logging_dir = logging_dir
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        import mlflow

        # file-store support (upstream Accelerate: tracking.py:705 MLflowTracker uses
        # MLFLOW_TRACKING_URI / the logging dir): a logging_dir routes runs
        # to a local file store; ``experiment_name`` selects/creates the
        # experiment before the run starts.
        if self.logging_dir:
            mlflow.set_tracking_uri("file://" + os.path.abspath(self.logging_dir))
        init_kwargs = dict(self._init_kwargs)
        experiment = init_kwargs.pop("experiment_name", None)
        if experiment:
            mlflow.set_experiment(experiment)
        self.active_run = mlflow.start_run(run_name=self.run_name, **init_kwargs)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for chunk_start in range(0, len(values), 100):
            mlflow.log_params(dict(list(values.items())[chunk_start : chunk_start + 100]))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        mlflow.log_metrics({k: v for k, v in values.items() if isinstance(v, (int, float))}, step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class AimTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:602)."""

    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        self.run_name = run_name
        self.logging_dir = logging_dir
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        from aim import Run

        self.writer = Run(repo=self.logging_dir, **self._init_kwargs)
        self.writer.name = self.run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """(upstream Accelerate: tracking.py:666). Values may be ``(image, caption)``
        tuples; ``kwargs`` may carry ``aim_image`` / ``track`` sub-dicts."""
        import aim

        aim_image_kw = (kwargs or {}).get("aim_image", {})
        track_kw = (kwargs or {}).get("track", {})
        for k, v in values.items():
            # a key maps to one image, one (image, caption) tuple, or a list
            for image in (v if isinstance(v, list) else [v]):
                if isinstance(image, tuple):
                    img, caption = image
                    aim_img = aim.Image(img, caption=caption, **aim_image_kw)
                else:
                    aim_img = aim.Image(image, **aim_image_kw)
                self.writer.track(aim_img, name=k, step=step, **track_kw)

    @on_main_process
    def finish(self):
        self.writer.close()


class CometMLTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:508)."""

    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        from comet_ml import Experiment

        self.writer = Experiment(project_name=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.writer.set_step(step)
        self.writer.log_metrics(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """comet_ml ``Experiment.log_image`` per image (named ``{key}_{i}``)."""
        for k, v in values.items():
            for i, image in enumerate(v):
                self.writer.log_image(_as_hwc_uint8(image), name=f"{k}_{i}", step=step, **kwargs)

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None, step=None, **kwargs):
        """comet_ml ``Experiment.log_table`` (csv filename + tabular data)."""
        if step is not None:
            self.writer.set_step(step)
        filename = table_name if table_name.endswith((".csv", ".tsv")) else f"{table_name}.csv"
        if dataframe is not None:
            self.writer.log_table(filename, tabular_data=dataframe, **kwargs)
        else:
            if data is None:
                raise ValueError("log_table needs `data` (with optional `columns`) or `dataframe`")
            self.writer.log_table(filename, tabular_data=data, headers=columns if columns is not None else False, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.end()


class ClearMLTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:912)."""

    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        from clearml import Task

        self.task = Task.init(project_name=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            if isinstance(v, (int, float)):
                clearml_logger.report_single_value(name=k, value=v) if step is None else clearml_logger.report_scalar(
                    title=k, series=k, value=v, iteration=step
                )

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        """(upstream Accelerate: tracking.py:998) ``Logger.report_image`` per image."""
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            for i, image in enumerate(v):
                clearml_logger.report_image(
                    title=k, series=str(i), iteration=step, image=_as_hwc_uint8(image), **kwargs
                )

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None, step=None, **kwargs):
        """(upstream Accelerate: tracking.py:1016) ``Logger.report_table``. Reference
        semantics when ``columns`` is omitted: the FIRST data row is the
        header row (unlike wandb/comet, which treat every row as data)."""
        to_report = dataframe
        if dataframe is None:
            if data is None:
                raise ValueError("log_table needs `data` (with optional `columns`) or `dataframe`")
            to_report = [columns] + list(data) if columns else data
        self.task.get_logger().report_table(
            title=table_name, series=table_name, table_plot=to_report, iteration=step, **kwargs
        )

    @on_main_process
    def finish(self):
        self.task.close()


class TrackioTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:431). HF trackio — wandb-compatible API."""

    name = "trackio"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        import trackio

        self.run = trackio.init(project=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import trackio

        trackio.config.update(values) if hasattr(trackio, "config") else self.run.config.update(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import trackio

        trackio.log({**values, **({"step": step} if step is not None else {})})

    @on_main_process
    def finish(self):
        import trackio

        trackio.finish()


class DVCLiveTracker(GeneralTracker):
    """(upstream Accelerate: tracking.py:1045)."""

    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, live=None, **kwargs):
        super().__init__()
        self._live = live
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        from dvclive import Live

        self.live = self._live if self._live is not None else Live(**self._init_kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


class SwanLabTracker(GeneralTracker):
    """(upstream Accelerate: LoggerType dataclasses.py:696-721 swanlab entry)."""

    name = "swanlab"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self._init_kwargs = kwargs

    @on_main_process
    def start(self):
        import swanlab

        self.run = swanlab.init(project=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.run.config.update(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import swanlab

        swanlab.log(values, step=step)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        import swanlab

        swanlab.log({k: [swanlab.Image(image, **kwargs) for image in v] for k, v in values.items()}, step=step)

    @on_main_process
    def finish(self):
        import swanlab

        swanlab.finish()


LOGGER_TYPE_TO_CLASS = {
    "jsonl": JSONLTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "aim": AimTracker,
    "comet_ml": CometMLTracker,
    "clearml": ClearMLTracker,
    "trackio": TrackioTracker,
    "dvclive": DVCLiveTracker,
    "swanlab": SwanLabTracker,
}

_AVAILABILITY = {
    "jsonl": lambda: True,
    "tensorboard": is_tensorboard_available,
    "wandb": is_wandb_available,
    "mlflow": is_mlflow_available,
    "aim": is_aim_available,
    "comet_ml": is_comet_ml_available,
    "clearml": is_clearml_available,
    "trackio": is_trackio_available,
    "dvclive": is_dvclive_available,
    "swanlab": is_swanlab_available,
}


def filter_trackers(log_with, logging_dir=None, project_name: str = "accelerate_tpu_torch", config=None, init_kwargs=None):
    """Resolve requested trackers to instantiated, available ones
    (upstream Accelerate: tracking.py:1271 + Accelerator.init_trackers
    accelerator.py:3002)."""
    init_kwargs = init_kwargs or {}
    if log_with is None:
        requested = ["jsonl"]
    elif not isinstance(log_with, (list, tuple)):
        requested = [log_with]
    else:
        requested = list(log_with)

    names = []
    for item in requested:
        if isinstance(item, GeneralTracker):
            names.append(item)
            continue
        value = str(LoggerType(item) if not isinstance(item, LoggerType) else item)
        if value == "all":
            names.extend([n for n, avail in _AVAILABILITY.items() if avail()])
        else:
            names.append(value)

    trackers = []
    def main_process_event(tracker, method, *event_args):
        # start()/store_init_configuration() are main-process-only events
        # for main_process_only trackers — enforced here so custom
        # subclasses get the guarantee without decorating their methods
        if getattr(tracker, "main_process_only", True) and not _is_main_process():
            return
        getattr(tracker, method)(*event_args)

    seen = set()
    for item in names:
        if isinstance(item, GeneralTracker):
            main_process_event(item, "start")
            if config:
                main_process_event(item, "store_init_configuration", config)
            trackers.append(item)
            continue
        if item in seen:
            continue
        seen.add(item)
        if not _AVAILABILITY.get(item, lambda: False)():
            logger.warning(f"Tracker {item!r} requested but its package is not installed; skipping.")
            continue
        cls = LOGGER_TYPE_TO_CLASS[item]
        kwargs = dict(init_kwargs.get(item, {}))
        if cls.requires_logging_directory:
            kwargs.setdefault("logging_dir", logging_dir or ".")
        tracker = cls(project_name, **kwargs)
        # upstream Accelerate's lifecycle (tracking.py:318): backend comes up in start(),
        # not __init__ — so worker-rank construction stays side-effect-free
        main_process_event(tracker, "start")
        if config:
            main_process_event(tracker, "store_init_configuration", config)
        trackers.append(tracker)
    return trackers
