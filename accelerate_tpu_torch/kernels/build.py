"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``accelerate_tpu_torch/csrc/`` exposes a plain C
interface, so it compiles in seconds into a shared library without
PyTorch's headers. The library lands in :func:`kernel_build_dir` under a
name that carries the hash of its source, the headers it includes and the
flags: a changed source or header builds anew at first use, an unchanged
one loads what is there.
:func:`build_all` starts one ``nvcc`` per source, all at once.

:func:`recording` collects the libraries :func:`load` is asked for while
it is open (each time, a library loaded before included): what a program
of :mod:`accelerate_tpu_torch.aot` needs, stored beside its signature so
another process can :func:`install_library` them instead of running
``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..utils.environment import kernel_build_dir
from .launch import count_launch

# libraries nvcc built in this process (a library found built counts none):
# what a fleet's spin-up reports as its compiles
nvcc_builds = 0
# libraries this process loaded that it found built: a warm start's loads
prebuilt_loads = 0

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
    count_launch(globals(), "nvcc_builds")
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


# the open recording scopes, process-wide: a program's backward runs on
# autograd's own device thread, so a scope on the caller's thread alone
# would miss the libraries its backward loads
_RECORDING: dict = {}  # id of the scope's set -> the set
_RECORDING_LOCK = threading.Lock()


@contextlib.contextmanager
def recording():
    """Collect the names of the kernel libraries :func:`load` is asked for
    while the block runs (a set, yielded), on any thread of the process:
    autograd runs a backward on its own thread. Scopes nest; a scope open
    on another thread at the same time records the name too (a program's
    record may name a library it did not need, never miss one)."""
    names: set = set()
    with _RECORDING_LOCK:
        _RECORDING[id(names)] = names
    try:
        yield names
    finally:
        with _RECORDING_LOCK:
            del _RECORDING[id(names)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed. The
    name is recorded in every open :func:`recording` scope before the
    process-wide cache is asked, so a library an earlier program loaded
    still counts for the next one."""
    with _RECORDING_LOCK:
        for names in _RECORDING.values():
            names.add(name)
    return _load(name)


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    proc, tmp, lib = _start(name)
    if proc is None:
        count_launch(globals(), "prebuilt_loads")
    _finish(name, proc, tmp, lib)
    lib = ctypes.CDLL(str(_target(name)[1]))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib


load.cache_clear = _load.cache_clear


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or would be) in
    :func:`kernel_build_dir`: ``lib<name>-<hash>.so``."""
    return _target(name)[1]


def install_library(file_name: str, data: bytes) -> bool:
    """Write a library's bytes into :func:`kernel_build_dir` under its own
    ``lib<name>-<hash>.so`` name unless it is there; returns whether it
    wrote. The write goes to a temporary file renamed into place, as a
    build's does, so a concurrent loader sees a whole library or none."""
    if os.path.basename(file_name) != file_name or not (file_name.startswith("lib") and file_name.endswith(".so")):
        raise ValueError(f"not a kernel library name: {file_name!r}")
    final = kernel_build_dir() / file_name
    if final.exists():
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=final.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, final)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise
    return True


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
