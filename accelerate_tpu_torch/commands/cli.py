"""The port's command-line front: one entry point over the commands it has.

Counterpart of ``accelerate-tpu`` (:mod:`accelerate_tpu.commands.cli`), run
as ``python -m accelerate_tpu_torch.commands.cli <command> ...`` (or the
``accelerate-tpu-torch`` console script). It registers the ported
commands and no others: ``serve``, ``fleet``, ``trace``, ``telemetry``,
``kernel-check`` and ``compile-cache``.

Example::

    python -m accelerate_tpu_torch.commands.cli serve --workers 2 --http-port 8799
    python -m accelerate_tpu_torch.commands.cli trace summarize "${TMPDIR:-/tmp}/accelerate_tpu_torch_serve"
"""

from __future__ import annotations

import argparse

from .compile_cache import compile_cache_parser
from .fleet import fleet_parser
from .kernelcheck import kernelcheck_parser
from .serve import serve_parser
from .telemetry import telemetry_parser
from .trace import trace_parser

#: the registered commands, in help order
COMMANDS = ("serve", "fleet", "trace", "telemetry", "kernel-check", "compile-cache")


def cli_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "accelerate-tpu-torch", usage="accelerate-tpu-torch <command> [<args>]", allow_abbrev=False
    )
    subparsers = parser.add_subparsers(dest="command", required=True)
    serve_parser(subparsers)
    fleet_parser(subparsers)
    trace_parser(subparsers)
    telemetry_parser(subparsers)
    kernelcheck_parser(subparsers)
    compile_cache_parser(subparsers)
    return parser


def main(argv=None):
    args = cli_parser().parse_args(argv)
    raise SystemExit(args.func(args) or 0)


if __name__ == "__main__":
    main()
