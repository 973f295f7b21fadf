"""Launch declarations: what one CUDA launch of a kernel does, in the form
the kernel analyzer reads, and the recorder that collects them.

The JAX package's analyzer reads each ``pallas_call`` out of a traced
jaxpr: its grid, every BlockSpec (block shape, backing shape and dtype),
the index maps it evaluates at each grid step, the aliases and the kernel
body. A CUDA launch through ``ctypes`` carries none of that, so every
kernel wrapper of the port declares it: a :class:`LaunchSite` (the
counterpart of ``grid_mapping``) built from the wrapper's operands by the
same arithmetic its launch uses. Each operand's :class:`TileSpec` names
its tile shape, backing shape and dtype, its index map (block index ->
tile index, or the list of tiles a block walks in order, as a grid-stride
loop does) and the number of shared-memory stages the tile goes through
(0: it goes straight to registers). The site's ``plain`` function computes
what the kernel computes; the analyzer walks it to count operations.

``meta`` tensors are PyTorch's abstract values, the counterpart of
``jax.ShapeDtypeStruct``. ``kernel_check`` runs the traced function on
them inside a :class:`LaunchRecorder`; there a wrapper, before it touches
``data_ptr()``, a stream or a kernel library (all three fail on ``meta``),
calls :func:`record` with its site and returns an empty ``meta`` result of
the right shape. Outside a recorder a ``meta`` tensor is refused.
"""

from __future__ import annotations

import contextvars
import itertools
import math
import sys
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
# one lock for every wrapper's launch counter: a fleet's replicas tick on
# threads of their own, and ``count += 1`` on a module global is a read,
# an add and a store that two threads can interleave
_COUNT_LOCK = threading.Lock()
# frames inside these are the wrappers' own; a launch is located at the first frame outside them
_WRAPPER_DIRS = (str(_PKG / "kernels") + "/", str(_PKG / "ops") + "/", str(Path(torch.__file__).parent) + "/")
# reaching the analyzer's own frame means the traced function was a wrapper itself: no user location
_ANALYZER = str(_PKG / "analysis" / "kernelmodel.py")


@dataclass(frozen=True)
class TileSpec:
    """One operand of a launch as a block sees it.

    ``index_map(*block)`` takes a block index (one int per grid dimension,
    x first) and returns the tile index it reads or writes, or a list of
    the tile indices it walks in order. ``stages`` is the number of
    shared-memory buffers the tile is staged through."""

    name: str
    tile: tuple
    shape: tuple
    dtype: torch.dtype
    index_map: Optional[Callable[..., Any]] = None
    stages: int = 0

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def tile_bytes(self) -> int:
        return math.prod(self.tile) * self.itemsize

    def tiles_per_dim(self) -> tuple:
        """``ceil(shape / tile)`` on every dimension: the tiles that make up
        the backing tensor."""
        return tuple(-(-int(s) // max(1, int(t))) for s, t in zip(self.shape, self.tile))

    def tiles_of(self, block: tuple) -> list:
        """The tile indices block ``block`` visits, in order."""
        got = self.index_map(*block)
        if isinstance(got, list):
            return [tuple(int(v) for v in t) for t in got]
        return [tuple(int(v) for v in got)]


@dataclass
class LaunchSite:
    """One launch: the kernel's name (the name its cost contract is
    registered under), the CUDA grid (x, y, z) and threads a block, the
    operands' tiles (inputs, then outputs), the shared memory a block asks
    for beyond its staged tiles, the aliases ``(input, output)``, and the
    plain function with the operands it is called on."""

    kernel: str
    grid: tuple
    threads: int
    ins: tuple = ()
    outs: tuple = ()
    smem_scratch: int = 0
    aliases: tuple = ()
    plain: Optional[Callable] = None
    operands: tuple = ()

    @property
    def blocks(self) -> int:
        return math.prod(self.grid) if self.grid else 1

    def block_indices(self):
        return itertools.product(*(range(int(g)) for g in self.grid))

    def tile_origins(self) -> torch.Tensor:
        """``int32 [blocks, operands, rank]``: the element origin of the
        one tile each block reads (inputs) or writes (outputs), blocks in
        grid order with x slowest. The table a tile-walk kernel reads, so
        the card runs exactly the maps the analyzer judges."""
        tiles = (*self.ins, *self.outs)
        rows = []
        for block in self.block_indices():
            row = []
            for t in tiles:
                visited = t.tiles_of(block)
                if len(visited) != 1:
                    raise ValueError(f"{self.kernel}: block {block} walks {len(visited)} tiles of {t.name}; want one")
                row.append([i * s for i, s in zip(visited[0], t.tile)])
            rows.append(row)
        return torch.tensor(rows, dtype=torch.int32)


@dataclass
class RecordedLaunch:
    site: LaunchSite
    path: Optional[str] = None
    line: Optional[int] = None


@dataclass
class LaunchRecorder:
    """Collects the sites of every launch made on ``meta`` tensors while it
    is entered (``with LaunchRecorder() as rec: fn(*meta_args)``)."""

    launches: list = field(default_factory=list)
    _token: Any = None

    def __enter__(self) -> "LaunchRecorder":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


_CURRENT: contextvars.ContextVar[Optional[LaunchRecorder]] = contextvars.ContextVar("launch_recorder", default=None)


def _caller() -> tuple:
    """``(path, line)`` of the first frame outside the kernel wrappers and
    torch: where the traced program asked for the kernel."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if path == _ANALYZER:
            break
        if not path.startswith(_WRAPPER_DIRS):
            return path, frame.f_lineno
        frame = frame.f_back
    return None, None


def record(site: LaunchSite) -> None:
    """Record ``site`` with the recorder in force; without one a ``meta``
    tensor is not a launch anyone asked to trace, and is refused."""
    rec = _CURRENT.get()
    if rec is None:
        raise ValueError(
            f"{site.kernel} runs on cuda or cpu tensors; meta tensors are traced only under kernel_check"
        )
    rec.launches.append(RecordedLaunch(site, *_caller()))


def runs_on_card(t: torch.Tensor) -> bool:
    """Whether the card's path takes ``t``: a CUDA tensor, or a ``meta``
    tensor under a recorder (a trace stands for the card)."""
    return t.device.type == "cuda" or (t.device.type == "meta" and _CURRENT.get() is not None)


def count_launch(namespace: dict, name: str = "launches") -> None:
    """Add one to the counter ``name`` of a kernel module (``namespace`` is
    its ``globals()``), exactly under concurrent calls: a wrapper's launch
    count, where its kernel launched and nowhere else (and ``build.py``'s
    count of ``nvcc`` builds). A counter is still read, and reset to 0, as
    a plain module attribute."""
    with _COUNT_LOCK:
        namespace[name] += 1
