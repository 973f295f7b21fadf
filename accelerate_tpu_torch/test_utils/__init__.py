"""Test helpers of the port: regression fixtures, skip decorators and test
cases, fault injection for the checkpoint paths and the serving fleet."""

from .fault_injection import CrashPoint, ReplicaChaos, SimulatedCrash, corrupt_file
from .testing import (
    AccelerateTestCase,
    TempDirTestCase,
    execute_subprocess_async,
    require_cpu_only,
    require_cuda,
    require_device_count,
    require_package,
    slow,
)
from .training import RegressionDataset, RegressionModel, linear_loss_fn, regression_apply

__all__ = [
    "AccelerateTestCase",
    "CrashPoint",
    "RegressionDataset",
    "RegressionModel",
    "ReplicaChaos",
    "SimulatedCrash",
    "TempDirTestCase",
    "corrupt_file",
    "execute_subprocess_async",
    "linear_loss_fn",
    "regression_apply",
    "require_cpu_only",
    "require_cuda",
    "require_device_count",
    "require_package",
    "slow",
]
