"""Test harness helpers, as :mod:`accelerate_tpu.test_utils.testing` has
them: skip decorators (``require_cuda`` in place of ``require_tpu``),
test cases that reset the state singletons, and a subprocess runner."""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import unittest
from pathlib import Path

import torch


def skip(reason="Test was skipped"):
    return unittest.skip(reason)


def require_cuda(test_case):
    """Skip without a CUDA card."""
    return unittest.skipUnless(torch.cuda.is_available(), "test requires a CUDA card")(test_case)


def require_cpu_only(test_case):
    """Skip where a CUDA card is present."""
    return unittest.skipUnless(not torch.cuda.is_available(), "test requires a machine without a CUDA card")(
        test_case
    )


def require_device_count(n: int):
    """Skip unless at least ``n`` CUDA cards are attached."""

    def decorator(test_case):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return unittest.skipUnless(count >= n, f"test requires >= {n} CUDA cards")(test_case)

    return decorator


def require_package(name: str, import_name: str | None = None):
    """Skip unless ``name`` (imported as ``import_name``) is installed."""

    def decorator(test_case):
        found = importlib.util.find_spec(import_name or name) is not None
        return unittest.skipUnless(found, f"test requires {name}")(test_case)

    return decorator


def slow(test_case):
    """Run only with ``ACCELERATE_RUN_SLOW=1``."""
    flag = os.environ.get("ACCELERATE_RUN_SLOW", "").lower() in ("1", "true", "yes", "on")
    return unittest.skipUnless(flag, "slow test; set ACCELERATE_RUN_SLOW=1")(test_case)


class AccelerateTestCase(unittest.TestCase):
    """Resets the state singletons after each test."""

    def tearDown(self):
        super().tearDown()
        from ..state import AcceleratorState, GradientState, PartialState

        AcceleratorState._reset_state()
        GradientState._reset_state()
        PartialState._reset_state()


class TempDirTestCase(AccelerateTestCase):
    """A temporary directory for the class (``self.tmpdir``), emptied before
    each test."""

    clear_on_setup = True

    @classmethod
    def setUpClass(cls):
        cls.tmpdir = Path(tempfile.mkdtemp())

    @classmethod
    def tearDownClass(cls):
        if cls.tmpdir.exists():
            shutil.rmtree(cls.tmpdir, ignore_errors=True)

    def setUp(self):
        super().setUp()
        if self.clear_on_setup:
            for path in self.tmpdir.glob("**/*"):
                if path.is_file():
                    path.unlink()
                elif path.is_dir():
                    shutil.rmtree(path, ignore_errors=True)


def execute_subprocess_async(cmd: list, env=None, timeout: int = 600) -> subprocess.CompletedProcess:
    """Run ``cmd``, capture its output, raise with both streams when it
    fails."""
    env = env if env is not None else os.environ.copy()
    result = subprocess.run([str(c) for c in cmd], capture_output=True, text=True, env=env, timeout=timeout)
    if result.returncode != 0:
        raise RuntimeError(
            f"command {' '.join(map(str, cmd))!r} failed (rc={result.returncode})\n"
            f"stdout:\n{result.stdout}\nstderr:\n{result.stderr}"
        )
    return result


def get_launch_command(num_processes: int = 1) -> list:
    """The command that starts a script (appended to it) on
    ``num_processes`` processes through the port's launcher."""
    return [sys.executable, "-m", "accelerate_tpu_torch.commands.launch", "--num_processes", str(num_processes)]
