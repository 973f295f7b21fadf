"""Tiny fixtures for training tests, as :mod:`accelerate_tpu.test_utils.training`
has them: ``y = a x + b`` regression, a two-parameter model and its loss.
The dataset draws the same numbers from the same seed, so the two
packages train on the same rows."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..modeling import Model


class RegressionDataset:
    """``y = a x + b + noise`` (``N(0, 0.1)``), ``length`` rows from ``seed``."""

    def __init__(self, a=2.0, b=3.0, length=64, seed=42):
        rng = np.random.default_rng(seed)
        self.length = length
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b + rng.normal(scale=0.1, size=(length,))).astype(np.float32)

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def regression_apply(params, x):
    return params["a"] * x + params["b"]


class _Regression(nn.Module):
    def __init__(self, a: float, b: float):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(float(a)))
        self.b = nn.Parameter(torch.tensor(float(b)))

    def forward(self, x):
        return regression_apply({"a": self.a, "b": self.b}, x)


def RegressionModel(a=0.0, b=0.0) -> Model:
    """Scalar ``a`` and ``b`` on the CPU (``prepare`` moves them)."""
    return Model(_Regression(a, b), config=None, name="RegressionModel")


def linear_loss_fn(params, batch):
    pred = regression_apply(params, batch["x"])
    return ((pred - batch["y"]) ** 2).mean()
