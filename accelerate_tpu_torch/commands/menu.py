"""The arrow-key picker behind ``config``'s choice questions.

Counterpart of :mod:`accelerate_tpu.commands.menu`: raw-mode key reading
(arrows, j / k, digits, enter), a list redrawn in place, and a numbered
prompt whenever stdin or stdout is not a terminal (pipes, CI, tests), so
``config`` stays scriptable.
"""

from __future__ import annotations

import sys

# key escape sequences -> logical keys
_ESCAPE_SEQUENCES = {
    "[A": "up",
    "[B": "down",
    "OA": "up",
    "OB": "down",
}


def _read_key(stdin=None) -> str:
    """One logical keypress from a raw-mode terminal: "up"/"down"/"enter"/
    "interrupt"/single characters."""
    stdin = stdin or sys.stdin
    import termios
    import tty

    fd = stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        ch = stdin.read(1)
        if ch == "\x1b":
            # escape sequence: arrows send two more bytes immediately; a
            # bare Esc sends none — poll so a lone Esc doesn't block until
            # the user types two unrelated keys
            import select

            seq = ""
            while len(seq) < 2 and select.select([fd], [], [], 0.05)[0]:
                seq += stdin.read(1)
            return _ESCAPE_SEQUENCES.get(seq, "escape")
        if ch in ("\r", "\n"):
            return "enter"
        if ch in ("\x03", "\x04"):  # ctrl-c / ctrl-d
            return "interrupt"
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _interactive_select(prompt: str, choices: list, default_index: int) -> int:
    """The cursor-driven picker: renders the list once, then redraws it in
    place after each keypress."""
    out = sys.stdout
    index = default_index
    out.write(f"{prompt}\n")
    n = len(choices)

    def render(first: bool):
        if not first:
            out.write(f"\x1b[{n}A")  # cursor up n lines
        for i, choice in enumerate(choices):
            marker = "➤" if i == index else " "
            line = f" {marker} {choice}"
            out.write(f"\x1b[2K{line}\n")  # clear line, rewrite
        out.flush()

    render(first=True)
    while True:
        key = _read_key()
        if key == "up":
            index = (index - 1) % n
        elif key == "down":
            index = (index + 1) % n
        elif key == "enter":
            return index
        elif key == "interrupt":
            raise KeyboardInterrupt
        elif key.isdigit() and int(key) < n:  # digit jump
            index = int(key)
        elif key in ("j",):  # vim bindings
            index = (index + 1) % n
        elif key in ("k",):
            index = (index - 1) % n
        render(first=False)


def _fallback_select(prompt: str, choices: list, default_index: int, input_fn=input, max_retries: int = 5) -> int:
    """Numbered-prompt fallback for non-TTY stdin; also the testable path.

    Invalid input re-prompts rather than aborting and discarding earlier
    answers; after ``max_retries`` bad inputs it raises, so a mis-piped
    stdin cannot spin forever."""
    print(prompt)
    for i, choice in enumerate(choices):
        print(f"  [{i}] {choice}")
    last_error = None
    for _ in range(max_retries):
        raw = input_fn(f"choice [{default_index}]: ").strip()
        if not raw:
            return default_index
        try:
            index = int(raw)
        except ValueError:
            # the choice's text itself, or a prefix that only it has
            matches = [i for i, c in enumerate(choices) if str(c).startswith(raw)]
            if len(matches) == 1:
                return matches[0]
            last_error = f"invalid choice {raw!r}; expected 0..{len(choices) - 1} or a unique prefix"
            print(last_error)
            continue
        if 0 <= index < len(choices):
            return index
        last_error = f"choice {index} out of range 0..{len(choices) - 1}"
        print(last_error)
    raise ValueError(last_error or "no valid selection")


def select(prompt: str, choices: list, default=None) -> object:
    """Pick one of ``choices``; returns the chosen value. Cursor menu on a
    TTY, numbered prompt otherwise."""
    if not choices:
        raise ValueError("select() needs at least one choice")
    if default is not None and default not in choices:
        raise ValueError(f"default {default!r} is not one of the choices {choices!r}")
    default_index = 0 if default is None else choices.index(default)
    interactive = sys.stdin.isatty() and sys.stdout.isatty()
    if interactive:
        try:
            return choices[_interactive_select(prompt, choices, default_index)]
        except (ImportError, OSError):  # no termios (non-unix) — fall through
            pass
    return choices[_fallback_select(prompt, choices, default_index)]
