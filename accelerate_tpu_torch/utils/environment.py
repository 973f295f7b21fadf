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


def kernel_build_dir() -> Path:
    """Directory for compiled kernel libraries (created on first use)."""
    env = os.environ.get(BUILD_DIR_ENV)
    root = Path(env) if env else Path(__file__).resolve().parents[2] / "build" / "cuda"
    root.mkdir(parents=True, exist_ok=True)
    return root
