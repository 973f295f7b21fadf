"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``accelerate_tpu_torch/csrc/`` exposes a plain C
interface, so it compiles in seconds into a shared library without
PyTorch's headers. The library lands in :func:`kernel_build_dir` under a
name that carries the hash of its source, the headers it includes and the
flags: a changed source or header builds anew at first use, an unchanged
one loads what is there.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..utils.environment import kernel_build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# name -> {C function: (argtypes, restype)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = _LONGS = ctypes.POINTER(ctypes.c_longlong)
_INTS = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "paged_attention": {
        "paged_decode_attention": ((*[_P] * 8, *[_I] * 9, _F, _I, _P), _I),
    },
    "flash_attention": {
        "flash_attention_fwd": ((*[_P] * 5, *[_I] * 7, _STRIDES, _F, _I, _I, _P), _I),
        "flash_attention_dq": ((*[_P] * 7, *[_I] * 7, _STRIDES, _F, _I, _I, _P), _I),
        "flash_attention_dkv": ((*[_P] * 8, *[_I] * 7, _STRIDES, _F, _I, _I, _P), _I),
        "flash_attention_fwd_config": ((*[_I] * 5, _INTS), _I),
        "flash_attention_dq_config": ((*[_I] * 7, _INTS), _I),
        "flash_attention_dkv_config": ((*[_I] * 7, _INTS), _I),
    },
    "flash_fwd_sm90": {
        "flash_fwd_sm90": ((*[_P] * 5, *[_I] * 7, _STRIDES, _F, _I, _I, _P), _I),
        "flash_fwd_sm90_config": ((*[_I] * 5, _INTS), _I),
    },
    "flash_bwd_sm90": {
        "flash_dq_sm90": ((*[_P] * 7, *[_I] * 7, _STRIDES, _F, _I, _I, _P), _I),
        "flash_dkv_sm90": ((*[_P] * 8, *[_I] * 7, _STRIDES, _F, _I, _I, _P), _I),
        "flash_dq_sm90_config": ((*[_I] * 7, _INTS), _I),
        "flash_dkv_sm90_config": ((*[_I] * 7, _INTS), _I),
    },
    "int4_matmul": {
        "int4_matmul": ((*[_P] * 6, *[_I] * 10, _P), _I),
    },
    "reference_kernels": {
        "block_matmul_softmax": ((*[_P] * 7, *[_I] * 10, _P), _I),
        "block_matmul_softmax_smem": ((_I,), _I),
        "block_accumulate": ((_P, _P, _I, ctypes.c_longlong, _I, _I, _P), _I),
        "reference_kernels_func_attributes": ((_I, _INTS), _I),
    },
    "kernel_fixtures": {
        "tile_copy": ((_P, _P, _INTS, *[_I] * 6, _LONGS, _P), _I),
        "tile_add": ((_P, _P, _P, _INTS, *[_I] * 5, _P), _I),
        "tile_scale": ((_P, _P, _INTS, *[_I] * 5, _P), _I),
        "kernel_fixtures_func_attributes": ((_I, _INTS), _I),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path) -> list[Path]:
    """``path`` and every header it includes with ``#include "..."``,
    transitively, each once: what the library's content depends on."""
    out = [path]
    for p in out:  # grows as headers are found
        for name in _INCLUDE.findall(p.read_bytes()):
            dep = p.parent / name.decode()
            if dep not in out:
                out.append(dep)
    return out


def _target(name: str) -> tuple[Path, Path]:
    """The source of kernel ``name`` and its library, named by a hash of the
    source, the headers it includes and the flags: a changed header builds
    anew as a changed source does."""
    src = CSRC / f"{name}.cu"
    content = b"".join(p.read_bytes() for p in _sources(src))
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, kernel_build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    ``(process or None, temporary output, final path)``."""
    src, lib = _target(name)
    if lib.exists():
        return None, None, lib
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), lib


def _finish(name: str, proc, tmp: Path, lib: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees a whole library or none
    return log


def build_all(names=None) -> dict:
    """Build every kernel library (one ``nvcc`` per source, in parallel);
    returns ``{name: (compiler output, seconds from the start until its
    library was there)}`` (empty output for a library already built)."""
    names = list(names or SIGNATURES)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}

    def finish(n):
        log = _finish(n, *started[n])
        return n, (log, time.perf_counter() - t0)

    with ThreadPoolExecutor(max_workers=len(names)) as pool:  # each waits on its own nvcc
        return dict(pool.map(finish, names))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    _finish(name, *_start(name))
    lib = ctypes.CDLL(str(_target(name)[1]))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib


def func_attributes(name: str, which: int) -> dict:
    """What the compiler made of kernel ``which`` of library ``name``
    (``cudaFuncGetAttributes`` through its ``<name>_func_attributes``
    entry): static shared memory, registers a thread, threads a block."""
    out = (ctypes.c_int * 3)()
    err = getattr(load(name), f"{name}_func_attributes")(which, out)
    if err != 0:
        raise RuntimeError(f"{name}_func_attributes({which}) failed: cudaError {err}")
    return {"shared_size_bytes": out[0], "num_regs": out[1], "max_threads_per_block": out[2]}


def launch_config(name: str, entry: str, *args: int) -> dict:
    """What ``entry`` of library ``name`` launches for ``args`` (its
    ``<entry>_config`` C entry, the launcher's own arithmetic): grid (x, y),
    threads a block, dynamic shared memory bytes."""
    out = (ctypes.c_int * 4)()
    err = getattr(load(name), f"{entry}_config")(*args, out)
    if err != 0:
        raise RuntimeError(f"{entry}_config{args} failed: cudaError {err}")
    return {"grid": (out[0], out[1]), "threads": out[2], "smem_bytes": out[3]}
