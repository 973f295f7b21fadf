"""``test``: run the self-checking script
(:mod:`accelerate_tpu_torch.test_utils.scripts.test_script`) through the
launcher, as :mod:`accelerate_tpu.commands.test` does. On the card by
default; ``--cpu`` runs it on the CPU (the JAX package's
``--fake_devices`` mesh has no counterpart here).

Example::

    python -m accelerate_tpu_torch.commands.cli test --cpu
"""

from __future__ import annotations

import argparse


def test_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("test", help="Verify the install with a self-checking run")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch test")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    if subparsers is not None:
        parser.set_defaults(func=test_command)
    return parser


def test_command(args) -> int:
    import accelerate_tpu_torch.test_utils.scripts.test_script as _script

    from .launch import launch_command, launch_parser

    largs = launch_parser().parse_args((["--cpu"] if args.cpu else []) + [_script.__file__])
    rc = launch_command(largs)
    print("Test is a success! You are ready for distributed training." if rc == 0 else "Test FAILED.")
    return rc


def main():
    raise SystemExit(test_command(test_parser().parse_args()))


if __name__ == "__main__":
    main()
