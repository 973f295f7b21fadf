"""Device resolution and the kernel build directory.

The port runs on a CUDA card by default: every entry point resolves its
``device`` argument here, and only an explicit ``"cpu"`` (what the tests
pass) runs without one. There is no quiet fall back to the CPU when the
card is missing. Also the helpers that read and patch the environment the
launcher hands a script (``ACCELERATE_*``).
"""

from __future__ import annotations

import functools
import os
from contextlib import contextmanager
from pathlib import Path
from typing import Optional, Union

import torch

# Where ``kernels.build`` puts the compiled CUDA libraries. Inside the
# checkout (and listed in .gitignore) unless the environment says otherwise.
BUILD_DIR_ENV = "ACCELERATE_TPU_TORCH_BUILD_DIR"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when the
    resolved device is a CUDA device and no CUDA card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; accelerate_tpu_torch runs on the GPU "
            "unless device='cpu' is passed explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# the process's own choice of that directory (set_kernel_build_dir); the
# environment variable, when set, wins over it
_build_dir_override: Optional[Path] = None


def set_kernel_build_dir(path) -> bool:
    """Point this process's kernel library directory at ``path`` unless
    ``ACCELERATE_TPU_TORCH_BUILD_DIR`` or an earlier call already chose one
    (re-pointing mid-process would split the built set); returns whether
    this call chose it."""
    global _build_dir_override
    if os.environ.get(BUILD_DIR_ENV) or _build_dir_override is not None:
        return False
    _build_dir_override = Path(path)
    return True


def kernel_build_dir() -> Path:
    """Directory for compiled kernel libraries (created on first use):
    ``ACCELERATE_TPU_TORCH_BUILD_DIR``, else the one
    :func:`set_kernel_build_dir` chose, else ``build/cuda`` in the checkout."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        root = Path(env)
    elif _build_dir_override is not None:
        root = _build_dir_override
    else:
        root = Path(__file__).resolve().parents[2] / "build" / "cuda"
    root.mkdir(parents=True, exist_ok=True)
    return root


# --------------------------------------------------------------------------- #
# the launcher -> script environment protocol: parsing and patching helpers
# (the port's copies of accelerate_tpu/utils/environment.py:20-140)
# --------------------------------------------------------------------------- #

_TRUE = {"1", "true", "yes", "on", "y", "t"}
_FALSE = {"0", "false", "no", "off", "n", "f", ""}


def str_to_bool(value: str) -> int:
    """``"yes"`` / ``"1"`` / ``"on"`` ... -> 1, ``"no"`` / ``"0"`` / ``""`` ... -> 0;
    anything else raises ``ValueError``."""
    value = str(value).lower().strip()
    if value in _TRUE:
        return 1
    if value in _FALSE:
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def get_int_from_env(env_keys, default: int) -> int:
    """The first set variable among ``env_keys`` parsed as an int, else ``default``."""
    for key in env_keys:
        val = os.environ.get(key)
        if val is not None and val != "":
            return int(val)
    return default


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    """A boolean flag from the environment (:func:`str_to_bool`'s spellings)."""
    value = os.environ.get(key)
    if value is None:
        return default
    return bool(str_to_bool(value))


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, default)


@contextmanager
def clear_environment():
    """Empty ``os.environ`` for the body; restore it after."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@contextmanager
def patch_environment(**kwargs):
    """Set environment variables for the body (keys upper-cased); restore
    the previous values, or their absence, after."""
    saved = {}
    missing = object()
    for key, value in kwargs.items():
        key = key.upper()
        saved[key] = os.environ.get(key, missing)
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is missing:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def purge_accelerate_environment(func):
    """Decorator: run ``func`` with every ``ACCELERATE_*`` variable removed,
    so no state leaks between tests through the launcher's protocol."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        saved = {k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_")}
        for k in saved:
            del os.environ[k]
        try:
            return func(*args, **kwargs)
        finally:
            os.environ.update(saved)

    return wrapper


def get_free_port() -> int:
    """An OS-assigned free TCP port on the loopback interface: the launcher
    takes one so that concurrent local process groups do not collide on a
    fixed rendezvous port."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
