"""``tpu-config``: run setup commands on every host of a cluster.

Counterpart of :mod:`accelerate_tpu.commands.tpu`, under the same command
name so scripts written for the JAX package's command line carry over:
``--hosts`` fans ``--command`` (repeatable, joined with ``; ``) out over
plain SSH, ``--install_accelerate`` prepends an editable install of this
checkout (or a pinned version), and ``--debug`` prints each SSH command
instead of running it. The JAX package's ``--tpu_name`` / ``--tpu_zone``
route (``gcloud compute tpus tpu-vm ssh``) reaches a TPU VM, which an H100
machine does not have: it raises ``ValueError``.

Example::

    python -m accelerate_tpu_torch.commands.cli tpu-config --hosts h1,h2 --command "nvidia-smi" --debug
"""

from __future__ import annotations

import argparse
import subprocess


def tpu_command_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("tpu-config", help="Run commands on every host of a cluster")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch tpu-config")
    parser.add_argument("--tpu_name", default=None, help="a GCP TPU's name: refused here (a TPU VM's route)")
    parser.add_argument("--tpu_zone", default=None, help="the GCP zone of that TPU: refused here")
    parser.add_argument("--hosts", default=None, help="comma-separated host list (plain SSH)")
    parser.add_argument("--ssh_user", default=None)
    parser.add_argument("--command", action="append", required=True, help="command to run (repeatable)")
    parser.add_argument(
        "--install_accelerate", action="store_true",
        help="prepend an editable install of this checkout on each host",
    )
    parser.add_argument("--accelerate_version", default="latest")
    parser.add_argument("--debug", action="store_true", help="print the fan-out command, do not run it")
    if subparsers is not None:
        parser.set_defaults(func=tpu_command_launcher)
    return parser


def _build_remote_command(args) -> str:
    cmds = list(args.command)
    if args.install_accelerate:
        if args.accelerate_version == "latest":
            # the checkout sits at the same path on every host (NFS, a shared image); a subshell keeps the
            # user's commands in their own directory
            from .launch import _pkg_root

            install = f"(cd {_pkg_root()} && pip install -e . --no-deps --no-build-isolation)"
        else:
            install = f"pip install accelerate-tpu=={args.accelerate_version}"
        cmds.insert(0, install)
    return "; ".join(cmds)


def tpu_command_launcher(args) -> int:
    if args.tpu_name or args.tpu_zone:
        raise ValueError(
            "--tpu_name/--tpu_zone reach a Google Cloud TPU VM through `gcloud compute tpus tpu-vm ssh`, "
            "a TPU's facility with no counterpart on a CUDA machine; pass --hosts for plain SSH"
        )
    if not args.hosts:
        raise SystemExit("tpu-config needs --hosts (plain SSH)")
    remote = _build_remote_command(args)
    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    rc = 0
    procs = []
    for host in hosts:
        target = f"{args.ssh_user}@{host}" if args.ssh_user else host
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no", target, remote]
        if args.debug:
            print("Running:", " ".join(cmd))
            continue
        procs.append(subprocess.Popen(cmd))
    for p in procs:
        rc = p.wait() or rc
    return rc


def main():
    args = tpu_command_parser().parse_args()
    raise SystemExit(tpu_command_launcher(args))


if __name__ == "__main__":
    main()
