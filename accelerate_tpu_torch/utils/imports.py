"""Availability probes for optional packages.

Counterpart of :mod:`accelerate_tpu.utils.imports`, the probes the trackers
need (:mod:`..tracking`): cheap, cached ``is_*_available()`` checks that
look a package up without importing it. TensorBoard counts as available
with ``tensorboardX``, ``tensorboard`` or torch, which ships
``torch.utils.tensorboard``.
"""

from __future__ import annotations

import functools
import importlib.util


@functools.lru_cache(maxsize=None)
def _package_available(pkg_name: str) -> bool:
    return importlib.util.find_spec(pkg_name) is not None


def is_tensorboard_available() -> bool:
    return _package_available("tensorboardX") or _package_available("tensorboard") or _package_available("torch")


def is_wandb_available() -> bool:
    return _package_available("wandb")


def is_mlflow_available() -> bool:
    return _package_available("mlflow")


def is_comet_ml_available() -> bool:
    return _package_available("comet_ml")


def is_aim_available() -> bool:
    return _package_available("aim")


def is_clearml_available() -> bool:
    return _package_available("clearml")


def is_dvclive_available() -> bool:
    return _package_available("dvclive")


def is_swanlab_available() -> bool:
    return _package_available("swanlab")


def is_trackio_available() -> bool:
    return _package_available("trackio")
