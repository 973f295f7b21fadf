"""The port's command-line front: one entry point over the commands it has.

Counterpart of ``accelerate-tpu`` (:mod:`accelerate_tpu.commands.cli`), run
as ``python -m accelerate_tpu_torch.commands.cli <command> ...`` (or the
``accelerate-tpu-torch`` console script). It registers the ported
commands, in the JAX front's order, and no others: ``launch``, ``config``,
``env``, ``test``, ``estimate-memory``, ``kernel-check``,
``merge-weights``, ``migrate``, ``telemetry``, ``trace``, ``checkpoints``,
``compile-cache``, ``fleet``, ``serve`` and ``tpu-config``. The analysis
commands (``lint``, ``flight-check`` and the rest) are ROADMAP.md Queue 1
item 11.

Example::

    python -m accelerate_tpu_torch.commands.cli launch --mixed_precision bf16 train.py
    python -m accelerate_tpu_torch.commands.cli serve --workers 2 --http-port 8799
    python -m accelerate_tpu_torch.commands.cli trace summarize "${TMPDIR:-/tmp}/accelerate_tpu_torch_serve"
"""

from __future__ import annotations

import argparse

from .checkpoints import checkpoints_parser
from .compile_cache import compile_cache_parser
from .config import config_parser
from .env import env_parser
from .estimate import estimate_parser
from .fleet import fleet_parser
from .kernelcheck import kernelcheck_parser
from .launch import launch_parser
from .merge import merge_parser
from .migrate import migrate_parser
from .serve import serve_parser
from .telemetry import telemetry_parser
from .test import test_parser
from .tpu import tpu_command_parser
from .trace import trace_parser

#: the registered commands, in help order (the JAX front's, less the analysis commands)
COMMANDS = ("launch", "config", "env", "test", "estimate-memory", "kernel-check", "merge-weights", "migrate",
            "telemetry", "trace", "checkpoints", "compile-cache", "fleet", "serve", "tpu-config")


def cli_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "accelerate-tpu-torch", usage="accelerate-tpu-torch <command> [<args>]", allow_abbrev=False
    )
    subparsers = parser.add_subparsers(dest="command", required=True)
    launch_parser(subparsers)
    config_parser(subparsers)
    env_parser(subparsers)
    test_parser(subparsers)
    estimate_parser(subparsers)
    kernelcheck_parser(subparsers)
    merge_parser(subparsers)
    migrate_parser(subparsers)
    telemetry_parser(subparsers)
    trace_parser(subparsers)
    checkpoints_parser(subparsers)
    compile_cache_parser(subparsers)
    fleet_parser(subparsers)
    serve_parser(subparsers)
    tpu_command_parser(subparsers)
    return parser


def main(argv=None):
    args = cli_parser().parse_args(argv)
    raise SystemExit(args.func(args) or 0)


if __name__ == "__main__":
    main()
