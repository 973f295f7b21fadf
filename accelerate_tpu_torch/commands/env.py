"""``env``: what to paste into a bug report.

Counterpart of :mod:`accelerate_tpu.commands.env`: the port's version,
Python, torch, the CUDA build torch was made with, the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (a card may be set below its rated
power, and then runs slower), and the ``ACCELERATE_*`` environment.
Without a card it says there is none.

Example::

    python -m accelerate_tpu_torch.commands.cli env
"""

from __future__ import annotations

import argparse
import os
import platform
import subprocess


def env_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("env", help="Print environment diagnostics")
        parser.set_defaults(func=env_command)
        return parser
    return argparse.ArgumentParser("accelerate-tpu-torch env")


def card_name_and_power_limit() -> str | None:
    """``nvidia-smi``'s ``name, power.limit`` line for each card, or None
    where there is no ``nvidia-smi`` or it fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def env_command(args=None) -> int:
    import numpy
    import torch

    import accelerate_tpu_torch

    info = {
        "accelerate_tpu_torch version": accelerate_tpu_torch.__version__,
        "Platform": platform.platform(),
        "Python version": platform.python_version(),
        "torch version": torch.__version__,
        "torch CUDA build": torch.version.cuda or "none (a CPU build)",
        "numpy version": numpy.__version__,
    }
    if torch.cuda.is_available():
        info["CUDA cards"] = ", ".join(torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count()))
        info["Card name, power limit"] = card_name_and_power_limit() or "nvidia-smi unavailable"
    else:
        info["CUDA cards"] = "none: no CUDA card is available (the port runs on the CPU only where asked)"
    info["ACCELERATE_* env"] = {k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_")} or "none"

    print("\nCopy-and-paste the text below in your GitHub issue\n")
    for key, value in info.items():
        print(f"- `{key}`: {value}")
    return 0


def main():
    env_parser().parse_args()
    raise SystemExit(env_command())


if __name__ == "__main__":
    main()
