"""``launch``: start a training script with the launcher's environment.

Counterpart of :mod:`accelerate_tpu.commands.launch`, with the same flags,
the same configuration precedence (command line > YAML > defaults) and the
same routes:

* one process: run the script with the environment protocol set, and
  restart it up to ``--max_restarts`` times when it fails
  (``ACCELERATE_RESTART_COUNT`` tells the script which attempt it is; a
  script resumes from its checkpoint with ``load_state()``);
* ``--num_processes N`` on one machine (or this machine's share of a
  manual multi-machine job, ``--machine_rank``): N processes, restarted as
  a group when one fails;
* ``--tpu_hosts h1,h2,...``: one process a host over SSH, each started
  with its rank.

The channel to the script is the environment: the JAX package's
``ACCELERATE_*`` names, and for more than one process also torch's own
protocol (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``), so that a child can
``torch.distributed.init_process_group("gloo")`` from ``env://``. The
port's ``PartialState`` runs one process on one card: it refuses a world
above 1 and a mesh axis above 1 (ROADMAP.md Queue 1 item 8), so for now a
multi-process launch suits scripts that drive ``torch.distributed``
themselves. ``--cpu`` sets ``ACCELERATE_USE_CPU=1``, which makes
``PartialState`` take the CPU.

What is a TPU's and has no counterpart here: the TPU pod's host discovery
(the TPU runtime's worker list and the GCE metadata server; pass
``--tpu_hosts``), and ``--fake_devices`` (an XLA flag for a fake CPU mesh),
which raises.

Example::

    python -m accelerate_tpu_torch.commands.cli launch --mixed_precision bf16 train.py --lr 3e-4
    python -m accelerate_tpu_torch.commands.cli launch --cpu --num_processes 2 gloo_script.py
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def _pkg_root() -> str:
    """The directory holding the ``accelerate_tpu_torch`` package (the
    checkout's root when it is not installed)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("launch", help="Launch a training script on this machine")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch launch")
    parser.add_argument("--num_processes", type=int, default=1, help="processes to start (in all machines)")
    parser.add_argument("--num_machines", type=int, default=1)
    parser.add_argument("--machine_rank", type=int, default=0)
    parser.add_argument("--main_process_ip", default="127.0.0.1")
    parser.add_argument("--main_process_port", type=int, default=None)
    parser.add_argument("--mixed_precision", default=None, choices=["no", "bf16", "fp16", "fp8"])
    parser.add_argument("--gradient_accumulation_steps", type=int, default=None)
    parser.add_argument("--mesh_data", type=int, default=None)
    parser.add_argument("--mesh_fsdp", type=int, default=None)
    parser.add_argument("--mesh_tensor", type=int, default=None)
    parser.add_argument("--mesh_seq", type=int, default=None)
    parser.add_argument("--mesh_pipe", type=int, default=None)
    parser.add_argument("--mesh_expert", type=int, default=None)
    parser.add_argument(
        "--debug", action="store_true", help="ACCELERATE_DEBUG_MODE=1: collective shape verification (item 8)"
    )
    parser.add_argument(
        "--max_restarts",
        type=int,
        default=0,
        help="restart the run this many times on a crash (the script resumes from its checkpoint)",
    )
    parser.add_argument(
        "--monitor_interval",
        type=float,
        default=5,
        help="seconds between process-group health polls / before a restart",
    )
    parser.add_argument("--cpu", action="store_true", help="run the script on the CPU (ACCELERATE_USE_CPU=1)")
    parser.add_argument(
        "--fake_devices", type=int, default=None,
        help="the JAX package's CPU fake mesh (an XLA flag): refused here",
    )
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--tpu_hosts", default=None, help="comma-separated host list for SSH fan-out")
    parser.add_argument("--ssh_user", default=None)
    parser.add_argument(
        "-m",
        "--module",
        action="store_true",
        help="interpret training_script as a python module path (python -m)",
    )
    parser.add_argument("training_script", help="script (or module with -m) to launch")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER, default=[])
    if subparsers is not None:
        parser.set_defaults(func=launch_command)
    return _track_explicit(parser)


def _track_explicit(parser):
    """Record which options were given on the command line, in
    ``namespace._explicit``. argparse calls an option's Action only when the
    flag is present, so this is exact: unlike a scan of ``sys.argv`` it
    ignores the training script's own arguments and handles ``--flag=value``
    and prefix abbreviations."""

    def tracked(cls):
        class Tracked(cls):
            def __call__(self, p, ns, values, option_string=None):
                if getattr(ns, "_explicit", None) is None:
                    ns._explicit = set()
                ns._explicit.add(self.dest)
                super().__call__(p, ns, values, option_string)

        return Tracked

    for action in parser._actions:
        if action.option_strings and not isinstance(action, argparse._HelpAction):
            action.__class__ = tracked(type(action))
    return parser


def build_env(args, process_id: int = 0, num_processes: int = 1) -> dict:
    """The environment a launched script starts with: the JAX package's
    ``ACCELERATE_*`` names, torch's rendezvous names above one process, and
    ``ACCELERATE_USE_CPU`` under ``--cpu``."""
    env = os.environ.copy()
    # the package may run straight from a checkout: the child's sys.path[0] is its script's directory, so
    # put this checkout first
    env["PYTHONPATH"] = _pkg_root() + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else _pkg_root()
    if args.mixed_precision:
        env["ACCELERATE_MIXED_PRECISION"] = args.mixed_precision
    if args.gradient_accumulation_steps:
        env["ACCELERATE_GRADIENT_ACCUMULATION_STEPS"] = str(args.gradient_accumulation_steps)
    for axis in ("data", "fsdp", "tensor", "seq", "pipe", "expert"):
        val = getattr(args, f"mesh_{axis}")
        if val is not None:
            env[f"ACCELERATE_MESH_{axis.upper()}"] = str(val)
    if args.debug:
        env["ACCELERATE_DEBUG_MODE"] = "1"
    if num_processes > 1:
        port = args.main_process_port or 7777
        # the local rank within this machine (the local test launcher would otherwise make every process the
        # local main one)
        procs_per_machine = max(1, num_processes // max(1, getattr(args, "num_machines", 1) or 1))
        env["ACCELERATE_COORDINATOR_ADDRESS"] = f"{args.main_process_ip}:{port}"
        env["ACCELERATE_NUM_PROCESSES"] = str(num_processes)
        env["ACCELERATE_PROCESS_ID"] = str(process_id)
        env["ACCELERATE_LOCAL_PROCESS_ID"] = str(process_id % procs_per_machine)
        env.update(MASTER_ADDR=args.main_process_ip, MASTER_PORT=str(port), RANK=str(process_id),
                   LOCAL_RANK=str(process_id % procs_per_machine), WORLD_SIZE=str(num_processes))
    if args.cpu:
        env["ACCELERATE_USE_CPU"] = "1"
    return env


def _load_config_into_args(args):
    """Command line > YAML > parser defaults: the configuration file
    (``--config_file``, else the default one when it exists) fills every
    option the command line did not give (``args._explicit``)."""
    from .config import default_config_path, load_config

    if args.config_file is None:
        if not os.path.isfile(default_config_path()):
            return args
        args.config_file = default_config_path()
    explicit = getattr(args, "_explicit", None) or set()
    for key, value in load_config(args.config_file).items():
        if hasattr(args, key) and key not in explicit:
            setattr(args, key, value)
    return args


def _supervised(run_once, args) -> int:
    """Run ``run_once(attempt)`` and restart it on failure up to
    ``--max_restarts`` times, ``--monitor_interval`` seconds apart.
    Recovery is the script's own: the restarted attempt sees
    ``ACCELERATE_RESTART_COUNT`` and resumes with ``load_state()``."""
    max_restarts = getattr(args, "max_restarts", 0) or 0
    attempt = 0
    while True:
        rc = run_once(attempt)
        if rc == 0 or attempt >= max_restarts:
            if rc != 0:
                from ..utils.console import print_launch_failure

                print_launch_failure(rc, attempt if max_restarts else None)
            return rc
        attempt += 1
        delay = getattr(args, "monitor_interval", None)
        delay = 5 if delay is None else delay
        print(
            f"launch: run failed (rc={rc}); restart {attempt}/{max_restarts} in {delay}s",
            file=sys.stderr,
        )
        time.sleep(delay)


def _script_argv(args) -> list:
    if getattr(args, "module", False):
        return ["-m", args.training_script, *args.training_script_args]
    return [args.training_script, *args.training_script_args]


def simple_launcher(args) -> int:
    """One process for this machine's card."""

    def run_once(attempt):
        env = build_env(args)
        env["ACCELERATE_RESTART_COUNT"] = str(attempt)
        return subprocess.call([sys.executable, *_script_argv(args)], env=env)

    return _supervised(run_once, args)


def multi_process_launcher(args) -> int:
    """``--num_processes`` local processes. One failing takes the group
    down (the rest would block in their next collective), then
    ``--max_restarts`` restarts the group.

    A manual multi-machine job runs this launcher once a machine, each with
    the same ``--num_processes`` (the total), ``--main_process_ip`` /
    ``--main_process_port`` (machine 0's) and its own ``--machine_rank``;
    each machine starts its share, ranks ``machine_rank * per_machine +
    local_rank``."""
    num_machines = getattr(args, "num_machines", 1) or 1
    total = args.num_processes
    if total % num_machines != 0:
        raise ValueError(
            f"--num_processes ({total}) is the GLOBAL process count and must be "
            f"divisible by --num_machines ({num_machines})"
        )
    if num_machines > 1 and (getattr(args, "max_restarts", 0) or 0) > 0:
        # this launcher supervises only its machine's share: restarting it while the other machines' ranks
        # block in collectives hangs the job; a scheduler that restarts every machine's launcher recovers it
        raise ValueError(
            "--max_restarts is per-machine and cannot coordinate a group "
            "restart across --num_machines > 1; restart the launcher on "
            "every machine (e.g. via your job scheduler) instead"
        )
    procs_per_machine = total // num_machines
    rank_base = getattr(args, "machine_rank", 0) * procs_per_machine

    def run_once(attempt):
        procs = []
        for local_rank in range(procs_per_machine):
            env = build_env(args, process_id=rank_base + local_rank, num_processes=total)
            env["ACCELERATE_RESTART_COUNT"] = str(attempt)
            procs.append(subprocess.Popen([sys.executable, *_script_argv(args)], env=env))
        interval = getattr(args, "monitor_interval", None)
        interval = 5 if interval is None else interval
        rc = 0
        try:
            while procs:
                alive = []
                for p in procs:
                    code = p.poll()
                    if code is None:
                        alive.append(p)
                    elif code != 0:
                        # one rank died: the others would hang in the next collective, so end the group
                        rc = code
                        for q in procs:
                            if q.poll() is None:
                                q.terminate()
                        return rc
                procs = alive
                if procs:
                    time.sleep(min(max(interval, 0.05), 1.0))  # a zero interval polls, it does not spin
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
        return rc

    return _supervised(run_once, args)


def pod_ssh_launcher(args) -> int:
    """SSH fan-out: each host of ``--tpu_hosts`` runs the script with its
    rank, the first host the rendezvous. ``--max_restarts`` restarts the
    whole fan-out (the surviving hosts' collectives would block)."""
    import shlex

    hosts = [h.strip() for h in args.tpu_hosts.split(",") if h.strip()]
    port = args.main_process_port or 7777
    # the hosts usually share the image or an NFS checkout: keep the package importable there too;
    # ${PYTHONPATH:+:...} adds no empty entry (the working directory) when the remote variable is unset
    script_cmd = " ".join(shlex.quote(a) for a in _script_argv(args))

    def run_once(attempt):
        procs = []
        for rank, host in enumerate(hosts):
            remote_cmd = (
                f"ACCELERATE_COORDINATOR_ADDRESS={hosts[0]}:{port} "
                f"ACCELERATE_NUM_PROCESSES={len(hosts)} ACCELERATE_PROCESS_ID={rank} "
                f"ACCELERATE_RESTART_COUNT={attempt} "
                f"MASTER_ADDR={hosts[0]} MASTER_PORT={port} RANK={rank} LOCAL_RANK=0 WORLD_SIZE={len(hosts)} "
                f'PYTHONPATH={_pkg_root()}"${{PYTHONPATH:+:$PYTHONPATH}}" '
                f"{sys.executable} {script_cmd}"
            )
            target = f"{args.ssh_user}@{host}" if args.ssh_user else host
            procs.append(subprocess.Popen(["ssh", "-o", "StrictHostKeyChecking=no", target, remote_cmd]))
        rc = 0
        for p in procs:
            rc = p.wait() or rc
        return rc

    return _supervised(run_once, args)


def launch_command(args) -> int:
    args = _load_config_into_args(args)
    if args.fake_devices:
        raise ValueError(
            "--fake_devices is the JAX package's CPU fake mesh, an XLA flag "
            "(--xla_force_host_platform_device_count) with no torch counterpart; "
            "use --cpu --num_processes N for N gloo processes on the CPU"
        )
    if (
        args.main_process_port is None
        and args.num_processes > 1
        and getattr(args, "num_machines", 1) == 1
        and getattr(args, "main_process_ip", "127.0.0.1") in ("127.0.0.1", "localhost")
    ):
        # one port for every rank, taken before the fan-out, so concurrent local groups do not collide on the
        # default; a multi-machine job keeps the default, which every machine's launcher must agree on
        from ..utils.environment import get_free_port

        args.main_process_port = get_free_port()
    if args.tpu_hosts:
        return pod_ssh_launcher(args)
    if args.num_processes > 1 or getattr(args, "num_machines", 1) > 1:
        return multi_process_launcher(args)
    return simple_launcher(args)


def main():
    parser = launch_parser()
    args = parser.parse_args()
    raise SystemExit(launch_command(args))


if __name__ == "__main__":
    main()
