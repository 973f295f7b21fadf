"""``notebook_launcher`` and ``debug_launcher``: run a training function
from a notebook or a REPL.

Counterpart of :mod:`accelerate_tpu.launchers`. One process is a plain
call in this process with the launcher's environment applied (the card
needs no fork). ``num_processes > 1`` with ``cpu=True`` (or
``ACCELERATE_USE_CPU=1``) spawns that many CPU processes with the
launcher's environment protocol, torch's rendezvous names included, so
each can ``torch.distributed.init_process_group("gloo")``; rank 0's
result comes back, and a crashed worker raises instead of leaving the
caller waiting. The JAX package spawns only for its CPU fake mesh, and so
does this one for the CPU: one card takes one process (ROADMAP.md Queue 1
item 8 for more). ``debug_launcher`` is that CPU spawn; the JAX
package's in-process fake mesh has no torch counterpart.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from .utils.environment import parse_flag_from_env, patch_environment

logger = logging.getLogger(__name__)


def _worker(fn, args, env, rank, result_queue):
    os.environ.update(env)
    result = fn(*args)
    if rank == 0 and result_queue is not None:
        import pickle

        # the queue pickles in a feeder thread, where an unpicklable result would fail unseen: probe here
        try:
            pickle.dumps(result)
        except Exception:
            result = None
        result_queue.put(result)


def notebook_launcher(
    function,
    args=(),
    num_processes: Optional[int] = None,
    mixed_precision: str = "no",
    use_port: str = "29500",
    master_addr: str = "127.0.0.1",
    node_rank: int = 0,
    num_nodes: int = 1,
    rdzv_backend: str = "static",  # accepted for the JAX signature; unused
    rdzv_endpoint: str = "",
    rdzv_conf=None,
    rdzv_id: str = "none",
    max_restarts: int = 0,
    monitor_interval: float = 0.1,
    cpu: bool = False,
):
    """Call ``function(*args)`` in this process, or with ``num_processes >
    1`` on the CPU (``cpu=True`` or ``ACCELERATE_USE_CPU=1``) in that many
    spawned gloo processes and return rank 0's result. Refuses to run
    after an ``Accelerator`` or ``PartialState`` was made in this process."""
    from .state import PartialState

    if PartialState._shared_state.get("_initialized"):
        raise ValueError(
            "An Accelerator/PartialState is already live in this process. "
            "Call notebook_launcher before creating the Accelerator inside `function`."
        )

    env = {}
    if mixed_precision and mixed_precision != "no":
        env["ACCELERATE_MIXED_PRECISION"] = mixed_precision
    cpu = cpu or parse_flag_from_env("ACCELERATE_USE_CPU")
    if not (num_processes and num_processes > 1 and cpu):
        if num_processes and num_processes > 1:
            logger.warning(
                "notebook_launcher: one card takes one process; num_processes=%d ignored, running inline "
                "(pass cpu=True for %d gloo processes on the CPU)", num_processes, num_processes,
            )
        if cpu:
            env["ACCELERATE_USE_CPU"] = "1"
        with patch_environment(**env):
            return function(*args)

    import multiprocessing
    from queue import Empty

    ctx = multiprocessing.get_context("spawn")
    result_queue = ctx.Queue()
    procs = []
    for rank in range(num_processes):
        child_env = {
            **env,
            "ACCELERATE_USE_CPU": "1",
            "ACCELERATE_COORDINATOR_ADDRESS": f"{master_addr}:{use_port}",
            "ACCELERATE_NUM_PROCESSES": str(num_processes),
            "ACCELERATE_PROCESS_ID": str(rank),
            "MASTER_ADDR": master_addr,
            "MASTER_PORT": str(use_port),
            "RANK": str(rank),
            "LOCAL_RANK": str(rank),
            "WORLD_SIZE": str(num_processes),
        }
        p = ctx.Process(target=_worker, args=(function, args, child_env, rank, result_queue if rank == 0 else None))
        p.start()
        procs.append(p)
    # drain rank 0's result while it lives: a plain blocking get() would wait forever on a worker that crashed
    # before putting, and the others would wait in their next collective on one that crashed at all
    result = None
    while True:
        try:
            result = result_queue.get(timeout=0.2)
            break
        except Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                break
            if not procs[0].is_alive():
                # it may have put its result and exited between the timeout and the liveness check
                try:
                    result = result_queue.get(timeout=0.2)
                except Empty:
                    pass
                break
    for p in procs:
        p.join()
    failed = [i for i, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"notebook_launcher worker(s) {failed} exited nonzero")
    return result


def debug_launcher(function, args=(), num_processes: int = 2):
    """Run ``function(*args)`` in ``num_processes`` spawned CPU processes
    over gloo (the cheapest way to exercise ``torch.distributed`` code
    without cards); returns rank 0's result."""
    from .utils.environment import get_free_port

    return notebook_launcher(function, args, num_processes=num_processes, use_port=str(get_free_port()), cpu=True)
