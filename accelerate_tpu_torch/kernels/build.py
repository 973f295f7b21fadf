"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``accelerate_tpu_torch/csrc/`` exposes a plain C
interface, so it compiles in seconds into a shared library without
PyTorch's headers. The library lands in :func:`kernel_build_dir` under a
name that carries the hash of its source and flags: a changed source
builds anew at first use, an unchanged one loads what is there.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..utils.environment import kernel_build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# name -> {C function: (argtypes, restype)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_attention": {
        "paged_decode_attention": ((*[_P] * 9, *[_I] * 10, _F, _I, _P), _I),
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


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
    returns ``{name: compiler output}`` (empty for a library already built)."""
    names = list(names or SIGNATURES)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    _finish(name, *_start(name))
    lib = ctypes.CDLL(str(_target(name)[1]))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib
