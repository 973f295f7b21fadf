"""The console the launcher reports failures on, as
:mod:`accelerate_tpu.utils.console` has it: ``rich``'s ``Console`` on
stderr when ``rich`` is installed, else a plain stand-in with the same
``print`` / ``rule`` / ``print_exception`` surface (ANSI colour on a tty,
plain text otherwise)."""

from __future__ import annotations

import sys
import traceback

_console = None


def get_console():
    """The process-wide console: ``rich.console.Console`` when available,
    else :class:`_PlainConsole`."""
    global _console
    if _console is None:
        try:
            from rich.console import Console

            _console = Console(stderr=True)
        except ImportError:
            _console = _PlainConsole()
    return _console


class _PlainConsole:
    """The print / rule / print_exception subset of rich's Console."""

    def _color(self, code: str, text: str) -> str:
        if sys.stderr.isatty():
            return f"\033[{code}m{text}\033[0m"
        return text

    def print(self, *objects, style: str | None = None, **kwargs):
        text = " ".join(str(o) for o in objects)
        if style and "red" in style:
            text = self._color("31", text)
        elif style and "yellow" in style:
            text = self._color("33", text)
        print(text, file=sys.stderr)

    def rule(self, title: str = ""):
        width = 79
        pad = max(0, width - len(title) - 2)
        print(f"{'─' * (pad // 2)} {title} {'─' * (pad - pad // 2)}" if title else "─" * width, file=sys.stderr)

    def print_exception(self, **kwargs):
        traceback.print_exc(file=sys.stderr)


def print_launch_failure(rc: int, attempt: int | None = None):
    """The launcher's banner when a child exits non-zero for the last time."""
    console = get_console()
    console.rule("launch failed")
    msg = f"child process exited with code {rc}"
    if attempt is not None:
        msg += f" (attempt {attempt})"
    console.print(msg, style="bold red")
    console.print(
        "Re-run with --debug for collective shape verification, or "
        "ACCELERATE_LOG_LEVEL=debug for verbose logs.",
        style="yellow",
    )
