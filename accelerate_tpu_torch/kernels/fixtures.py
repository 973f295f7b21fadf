"""K8: the tile-walk kernels behind the kernel analyzer's seeded-defect
fixtures, their wrappers and plain versions.

Counterpart of the Pallas kernel bodies in
:func:`accelerate_tpu.analysis.selfcheck._kernel_fixtures` (``copy_kernel``,
``add_kernel``, ``_drifty_spec_kernel``). Each wrapper takes the launch
declaration a fixture makes (tile shape, grid, index maps, alias)
and builds its :class:`~.launch.LaunchSite` from it; the CUDA kernels
(``csrc/kernel_fixtures.cu``) read their tiles from the table of tile
origins the site's maps give, so the card runs exactly what the analyzer
judges, defects included. The table travels in the launch's parameters
(:func:`pack_origins`), so a call is one launch and no copy. On a CPU
tensor a wrapper computes its plain version, the fixture's intended
function (a copy, ``a + d`` from the unmodified ``a``, ``2 x``), whatever
the maps say; on a ``meta`` tensor under ``kernel_check`` it records its
site; on a CUDA tensor it launches the kernel or raises.

The kernels carry no cost contract: they are the seeded defects
(``tile_scale``'s is registered by the selfcheck, deliberately wrong, for
the duration of its TPU1006 fixture). Their launch lines suppress the
registration gate's TPU1005 for that reason.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from .launch import LaunchSite, TileSpec, count_launch, record

THREADS = 256  # threads a block of csrc/kernel_fixtures.cu
MAX_BLOCKS = 8  # blocks a launch's table of tile origins holds: kMaxBlocks of csrc/kernel_fixtures.cu
# shared buffers a copied tile goes through: the reference's double buffering of a grid of 2+ steps
STAGES = 2

# Kernel launches since import (or since a caller reset them to 0).
launches_copy = 0
launches_add = 0
launches_scale = 0
# dynamic shared memory the last tile_copy launch asked for, refused or not
last_copy_smem_request = 0


def tile_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """What a copy fixture means: ``x`` copied."""
    return x.clone()


def tile_add_plain(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """What the add fixture means: ``a + d`` from the unmodified ``a``."""
    return a + d


def tile_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """What the scale fixture means: ``2 x``."""
    return x * 2.0


def _check(tensors: dict, tile: tuple) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.dim() != 2 or t.shape != first.shape or t.dtype != torch.float32 or t.device != first.device:
            raise ValueError(f"{name}: want f32 [rows, cols] tensors of one shape on one device; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len(tile) != 2 or min(tile) < 1:
        raise ValueError(f"tile must be (rows, cols) >= 1, got {tile}")


def pack_origins(site: LaunchSite) -> ctypes.Array:
    """``site.tile_origins()`` flattened into the ``int32`` array the C entry
    copies into the kernel's parameters (``Origins``, at most
    :data:`MAX_BLOCKS` blocks)."""
    table = site.tile_origins()
    if table.shape[0] > MAX_BLOCKS:
        raise ValueError(f"{site.kernel}: {table.shape[0]} blocks; the launch's parameters carry the tile origins "
                         f"of at most MAX_BLOCKS = {MAX_BLOCKS}")
    flat = table.flatten().tolist()
    return (ctypes.c_int * len(flat))(*flat)


def _run(site: LaunchSite, out: Optional[torch.Tensor], launch: Callable) -> torch.Tensor:
    """CPU: the plain version (into ``out`` when given); meta: record;
    CUDA: ``launch(origins, out)`` returns the cudaError."""
    first = site.operands[0]
    if out is not None and (out.shape != first.shape or out.dtype != first.dtype or out.device != first.device):
        raise ValueError(f"out must be {first.dtype} {tuple(first.shape)} on {first.device}")
    if first.device.type == "cpu":
        result = site.plain(*site.operands)
        return result if out is None else out.copy_(result)
    if first.device.type == "meta":
        record(site)
        return torch.empty_like(first) if out is None else out
    if first.device.type != "cuda":
        raise ValueError(f"{site.kernel} runs on cuda or cpu tensors, got {first.device}")
    for t in (*site.operands, out):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{site.kernel}: operands must be contiguous")
    origins = pack_origins(site)
    out = torch.empty_like(first) if out is None else out
    err = launch(origins, out)
    if err != 0:
        raise RuntimeError(f"{site.kernel} launch refused: cudaError {err}")
    return out


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def tile_copy(x, *, tile, grid, in_map, out_map, out=None) -> torch.Tensor:
    """``out`` tile ``out_map(block)`` = ``x`` tile ``in_map(block)`` for
    every block of ``grid``, each tile staged through :data:`STAGES`
    shared buffers."""
    _check({"x": x}, tile)
    site = LaunchSite(
        "tile_copy", tuple(grid), THREADS,
        ins=(TileSpec("x", tuple(tile), tuple(x.shape), x.dtype, in_map, STAGES),),
        outs=(TileSpec("out", tuple(tile), tuple(x.shape), x.dtype, out_map, STAGES),),
        plain=tile_copy_plain, operands=(x,),
    )

    def launch(origins, out):
        from .build import load

        global last_copy_smem_request
        lib = load("kernel_fixtures")
        request = ctypes.c_longlong(0)
        err = lib.tile_copy(  # tpu-lint: disable=TPU1005 (a seeded-defect fixture: no contract)
            x.data_ptr(), out.data_ptr(), origins, site.blocks, x.shape[0], x.shape[1], *tile, STAGES,
            ctypes.byref(request), _stream(x),
        )
        last_copy_smem_request = request.value
        if err == 0:
            count_launch(globals(), "launches_copy")
        return err

    return _run(site, out, launch)


def tile_add(a, d, *, tile, grid, a_map, d_map, out_map, alias: bool = False, out=None) -> torch.Tensor:
    """``out`` tile ``out_map(block)`` = ``a`` tile ``a_map(block)`` + ``d``
    tile ``d_map(block)``; with ``alias`` the output is ``a`` itself."""
    _check({"a": a, "d": d}, tile)
    if alias:
        if out is not None:
            raise ValueError("alias writes into a; pass no out")
        out = a
    site = LaunchSite(
        "tile_add", tuple(grid), THREADS,
        ins=(TileSpec("a", tuple(tile), tuple(a.shape), a.dtype, a_map),
             TileSpec("d", tuple(tile), tuple(d.shape), d.dtype, d_map)),
        outs=(TileSpec("out", tuple(tile), tuple(a.shape), a.dtype, out_map),),
        aliases=((0, 0),) if alias else (), plain=tile_add_plain, operands=(a, d),
    )

    def launch(origins, out):
        from .build import load

        lib = load("kernel_fixtures")
        err = lib.tile_add(  # tpu-lint: disable=TPU1005 (a seeded-defect fixture: no contract)
            a.data_ptr(), d.data_ptr(), out.data_ptr(), origins, site.blocks, a.shape[0], a.shape[1],
            *tile, _stream(a),
        )
        if err == 0:
            count_launch(globals(), "launches_add")
        return err

    return _run(site, out, launch)


def tile_scale(x, *, tile, grid, in_map, out_map, out=None) -> torch.Tensor:
    """``out`` tile ``out_map(block)`` = 2 x ``x`` tile ``in_map(block)``."""
    _check({"x": x}, tile)
    site = LaunchSite(
        "tile_scale", tuple(grid), THREADS,
        ins=(TileSpec("x", tuple(tile), tuple(x.shape), x.dtype, in_map),),
        outs=(TileSpec("out", tuple(tile), tuple(x.shape), x.dtype, out_map),),
        plain=tile_scale_plain, operands=(x,),
    )

    def launch(origins, out):
        from .build import load

        lib = load("kernel_fixtures")
        err = lib.tile_scale(  # tpu-lint: disable=TPU1005 (a seeded-defect fixture: no contract)
            x.data_ptr(), out.data_ptr(), origins, site.blocks, x.shape[0], x.shape[1], *tile, _stream(x),
        )
        if err == 0:
            count_launch(globals(), "launches_scale")
        return err

    return _run(site, out, launch)
