"""Device resolution and the kernel build directory.

The port runs on a CUDA card by default: every entry point resolves its
``device`` argument here, and only an explicit ``"cpu"`` (what the tests
pass) runs without one. There is no quiet fall back to the CPU when the
card is missing.
"""

from __future__ import annotations

import os
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
