"""Progress bars shown by the local main process only, as
:mod:`accelerate_tpu.utils.tqdm` has them."""

from __future__ import annotations

from .imports import is_tqdm_available


def tqdm(*args, main_process_only: bool = True, **kwargs):
    if not is_tqdm_available():
        raise ImportError("tqdm is required; install tqdm")
    import tqdm as _tqdm

    from ..state import PartialState

    if len(args) > 0 and isinstance(args[0], bool):
        raise ValueError(
            "Passing `True`/`False` positionally is deprecated; use `main_process_only=` instead."
        )
    disable = kwargs.pop("disable", False)
    if main_process_only and not disable:
        disable = not PartialState().is_local_main_process
    return _tqdm.tqdm(*args, disable=disable, **kwargs)
