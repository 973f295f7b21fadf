"""SIGTERM/SIGINT -> a clean final checkpoint instead of a dead run.

Counterpart of :mod:`accelerate_tpu.ft.preemption`. Cloud machines are
preempted with a SIGTERM and a short grace window. A
:class:`PreemptionHandler` converts the signal into a *flag* -- it does
no work inside the signal handler (async-signal context must not take
locks or touch the card) -- which the training loop observes through
``Accelerator.should_checkpoint`` / ``Accelerator.should_stop``::

    for batch in loader:
        step(batch)
        if accelerator.should_checkpoint:
            accelerator.save_state()      # drains async saves, saves SYNC
        if accelerator.should_stop:
            break                          # exit cleanly inside the grace window

``Accelerator(kwargs_handlers=[FaultToleranceKwargs()])`` installs one
automatically; the handler chains to any previously installed handler on
``uninstall()`` restore.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable, Iterable, Optional

logger = logging.getLogger(__name__)

#: default signals: SIGTERM is what preemption sends; SIGINT makes
#: ctrl-C during local runs take the same clean-exit path
DEFAULT_SIGNALS = ("SIGTERM", "SIGINT")


class PreemptionHandler:
    """Latches preemption signals into a checkable flag. (The JAX
    package's ``mark_remote``, which latches it for a signal another host
    received, comes with multi-process training: ROADMAP.md Queue 1 item
    8.)

    ``on_preempt(signame)`` (optional) runs once on the first signal --
    the Accelerator emits a telemetry ``preempt`` event through it. A
    second SIGINT while preempted re-raises ``KeyboardInterrupt`` so a
    user hammering ctrl-C can still kill a hung drain."""

    def __init__(
        self,
        signals: Iterable[str] = DEFAULT_SIGNALS,
        on_preempt: Optional[Callable[[str], None]] = None,
    ):
        self.signal_names = tuple(signals)
        self.on_preempt = on_preempt
        self.received: Optional[str] = None
        self.installed = False
        self._prev_handlers: dict[int, object] = {}

    # ------------------------------------------------------------------ #

    @property
    def preempted(self) -> bool:
        return self.received is not None

    def install(self) -> bool:
        """Register the handlers. Returns ``False`` (with a warning)
        instead of raising when not on the main thread — ``signal.signal``
        only works there, and a notebook/background-thread Accelerator
        should degrade, not crash."""
        if self.installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionHandler.install skipped: not on the main thread")
            return False
        for name in self.signal_names:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                self._prev_handlers[signum] = signal.signal(signum, self._handle)
            except (ValueError, OSError) as e:  # embedded interpreters
                logger.warning(f"could not install handler for {name}: {e}")
        self.installed = bool(self._prev_handlers)
        return self.installed

    def uninstall(self):
        """Restore the previously installed handlers."""
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self.installed = False

    def reset(self):
        """Clear the latched flag (tests; or a run that checkpointed and
        decided to keep going after a spurious SIGINT)."""
        self.received = None

    # ------------------------------------------------------------------ #

    def _handle(self, signum, frame):
        first = self.received is None
        name = signal.Signals(signum).name
        if not first and signum == getattr(signal, "SIGINT", None):
            raise KeyboardInterrupt  # second ctrl-C: user really means it
        self.received = name
        if first:
            logger.warning(f"{name} received — will checkpoint and stop at the next step boundary")
            if self.on_preempt is not None:
                try:
                    self.on_preempt(name)
                except Exception as e:  # the flag must latch even if telemetry hiccups
                    logger.warning(f"on_preempt callback failed: {e}")

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.uninstall()
