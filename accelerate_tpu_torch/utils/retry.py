"""Jittered exponential-backoff retry for flaky IO.

A copy of :mod:`accelerate_tpu.utils.retry`: the same schedule, so the
same ``rng`` gives the same delays in both packages.

Checkpoint writes hit GCS/NFS (transient 5xx, stale handles) and tracker
calls hit the network; both should survive a blip without killing a
multi-hour run. ``retry`` is deliberately narrow by default — it retries
``OSError`` only, so programming errors (and the fault-injection
harness's ``SimulatedCrash``) propagate immediately.

::

    @retry(attempts=4, base_delay=0.2)
    def _write(path, data): ...

    retry_call(tracker.log, values, attempts=3, on_retry=log_event)

``on_retry(attempt, delay, exc)`` fires before each sleep — the
checkpoint path emits ``ckpt_retry`` telemetry events through it, so a
run report shows every transient failure that was absorbed.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

#: exceptions retried by default: filesystem / network IO surfaces as
#: OSError (IOError is an alias; gcsfs/fsspec raise OSError subclasses)
DEFAULT_EXCEPTIONS: Tuple[Type[BaseException], ...] = (OSError,)


def backoff_delays(attempts: int, base_delay: float, max_delay: float, jitter: float, rng=random.random):
    """The sleep schedule between attempts: ``base * 2**i`` capped at
    ``max_delay``, each scaled by ``1 + jitter*U[0,1)`` so a pod of hosts
    retrying the same dead filer doesn't thundering-herd in lockstep."""
    for i in range(max(0, attempts - 1)):
        yield min(max_delay, base_delay * (2**i)) * (1.0 + jitter * rng())


def retry_call(
    fn: Callable,
    *args,
    attempts: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    exceptions: Tuple[Type[BaseException], ...] = DEFAULT_EXCEPTIONS,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    on_giveup: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying on ``exceptions`` with
    jittered exponential backoff. Re-raises the last exception after
    ``attempts`` tries (after ``on_giveup``, if given)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delays = backoff_delays(attempts, base_delay, max_delay, jitter)
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            if attempt == attempts:
                if on_giveup is not None:
                    on_giveup(attempt, e)
                raise
            delay = next(delays)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)


def retry(
    fn: Optional[Callable] = None,
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    jitter: float = 0.5,
    exceptions: Tuple[Type[BaseException], ...] = DEFAULT_EXCEPTIONS,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    on_giveup: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Decorator form of :func:`retry_call` (bare ``@retry`` or
    ``@retry(attempts=5, ...)``)."""

    def decorate(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return retry_call(
                f,
                *args,
                attempts=attempts,
                base_delay=base_delay,
                max_delay=max_delay,
                jitter=jitter,
                exceptions=exceptions,
                on_retry=on_retry,
                on_giveup=on_giveup,
                sleep=sleep,
                **kwargs,
            )

        return wrapper

    return decorate(fn) if fn is not None else decorate
