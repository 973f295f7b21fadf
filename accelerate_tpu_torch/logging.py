"""Rank-aware logging.

Counterpart of :mod:`accelerate_tpu.logging`. ``get_logger`` returns a
:class:`MultiProcessAdapter` whose records are dropped on processes other
than the main one unless ``main_process_only=False``; with
``in_order=True`` the processes log one at a time, separated by barriers.
"""

from __future__ import annotations

import functools
import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    """A logger adapter that takes ``main_process_only`` and ``in_order``."""

    @staticmethod
    def _state():
        """The process state, or None before one exists (one process; logging
        never creates the state, which would pick a device)."""
        from .state import PartialState

        return PartialState() if PartialState._shared_state.get("_initialized") else None

    @classmethod
    def _should_log(cls, main_process_only: bool) -> bool:
        state = cls._state()
        return not main_process_only or state is None or state.is_main_process

    def log(self, level, msg, *args, **kwargs):
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)
        if self.isEnabledFor(level):
            state = self._state()
            # in_order on every process, whatever main_process_only says: the
            # loop barriers, so a main process logging elsewhere would never
            # meet the others' barrier
            if in_order and state is not None:
                for i in range(state.num_processes):
                    if i == state.process_index:
                        msg, kwargs = self.process(msg, kwargs)
                        self.logger.log(level, msg, *args, **kwargs)
                    state.wait_for_everyone()
            elif self._should_log(main_process_only):
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, msg, *args, **kwargs)

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        """A warning once per distinct message."""
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A :class:`MultiProcessAdapter` over ``logging.getLogger(name)``; the
    level is ``log_level``, else ``ACCELERATE_LOG_LEVEL`` when set."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
