"""On-disk executable store and content keys: the persistence layer under
:class:`~accelerate_tpu_torch.aot.ProgramCache`.

Counterpart of :mod:`accelerate_tpu.aot.cache`. The JAX package compiles
whole programs with XLA and serializes the executables. The port runs
eager PyTorch, and its one compiler is ``nvcc``, which builds the
hand-written kernels (:mod:`..kernels.build`). So here:

* a **program** is a callable at an input signature, keyed by
  :func:`content_key`: a sha256 over the callable's qualified name and code
  object, the signature, :func:`backend_descriptor`, the kernel sources
  and a salt. Any drift (a new torch, another card, changed ``nvcc``
  flags, a changed kernel source, another shape) lands on another key;
* a **serialized executable** (:func:`serialize_compiled`) is the
  program's store entry: its signature record and the key of each kernel
  library its first call loaded. Each library is an entry of its own,
  content-keyed by its ``lib<name>-<hash>.so`` name and the backend, and
  holds the library's bytes, so a library is stored once for every
  program that needs it;
* a **deserialize** (:func:`deserialize_compiled`) writes each library
  the build directory lacks into it (renamed into place, as a build is),
  so :func:`..kernels.build.load` finds it built: a warm process runs
  with no ``nvcc`` build.

:func:`configure_persistent_cache` is the counterpart of jax's persistent
compilation cache: it points the process's kernel library directory at
``{cache_dir}/cuda``, so every library built there survives the process
whether a program recorded it or not.

Entry layout (one file an entry, ``<key>.aotx``)::

    ATPX1\\n
    {"key": ..., "name": ..., "crc32": ..., "size": ..., "backend": {...}}\\n
    <blob: a program's JSON record, or a library's bytes>

A header written for another backend raises :class:`StaleEntryError`, a
blob that fails its size or crc32 raises :class:`CorruptEntryError`; the
caller deletes the entry and builds anew, so a poisoned store degrades to
a cold one, never to a wrong library. Writes are atomic (a temporary file
renamed into place), so a killed process never publishes half an entry.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import time
import types
import zlib
from typing import Optional

_MAGIC = b"ATPX1"
_SUFFIX = ".aotx"


class CorruptEntryError(Exception):
    """The entry bytes fail structural or crc validation (a poisoned
    store). ``key`` names the entry at fault."""

    def __init__(self, message: str, key: Optional[str] = None):
        super().__init__(message)
        self.key = key


class StaleEntryError(Exception):
    """The entry was written for another backend (torch, CUDA, card or
    ``nvcc`` flags) and must not be used by this process. ``key`` names
    the entry at fault."""

    def __init__(self, message: str, key: Optional[str] = None):
        super().__init__(message)
        self.key = key


def backend_descriptor() -> dict:
    """What a stored library is only valid for: on a CUDA card
    ``{"platform": "gpu", "torch", "cuda", "device", "capability",
    "nvcc_flags"}`` (device 0's name and compute capability, the flags
    :mod:`..kernels.build` compiles with); without one ``{"platform":
    "cpu", "torch"}``."""
    import torch

    from ..kernels.build import NVCC_FLAGS

    if not torch.cuda.is_available():
        return {"platform": "cpu", "torch": torch.__version__}
    major, minor = torch.cuda.get_device_capability(0)
    return {
        "platform": "gpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "capability": f"{major}.{minor}",
        "nvcc_flags": " ".join(NVCC_FLAGS),
    }


@functools.cache
def _kernel_sources_digest() -> str:
    """sha256 over every kernel source and header: a changed kernel
    changes what a program runs, so it changes every program's key."""
    from ..kernels.build import CSRC

    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode() + b"\x00" + path.read_bytes())
    return h.hexdigest()


def _code_of(fn):
    """The code object that defines callable ``fn`` (a function, a bound
    method, a ``functools.partial`` of one, or an object whose ``forward``
    or ``__call__`` is a function)."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    fn = getattr(fn, "__func__", fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        attr = getattr(type(fn), "forward", None) or getattr(type(fn), "__call__", None)
        code = getattr(attr, "__code__", None)
    if code is None:
        raise TypeError(f"cannot key {fn!r}: no Python code object behind it")
    return code


def _qualname(fn) -> str:
    while isinstance(fn, functools.partial):
        fn = fn.func
    fn = getattr(fn, "__func__", fn)
    owner = fn if hasattr(fn, "__qualname__") else type(fn)
    return f"{getattr(owner, '__module__', '')}.{owner.__qualname__}"


def _hash_code(code: types.CodeType, h) -> None:
    """Feed a code object's bytecode, names and constants (nested code
    objects recursively; sets in a stable order) into ``h``: the same
    source gives the same bytes in every process of one Python."""
    h.update(code.co_code)
    h.update(b"\x00" + " ".join(code.co_names).encode())
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _hash_code(c, h)
        elif isinstance(c, frozenset):
            h.update(b"\x00" + repr(sorted(repr(v) for v in c)).encode())
        else:
            h.update(b"\x00" + repr(c).encode())


def content_key(fn, signature, extra=()) -> str:
    """Content key of program ``fn`` at input ``signature``: a sha256 over
    the callable's qualified name and code object, the signature, the
    backend descriptor, the kernel sources and ``extra`` (a salt: what the
    program closes over that its inputs do not show, e.g. the model's
    layout)."""
    h = hashlib.sha256()
    h.update(_qualname(fn).encode())
    _hash_code(_code_of(fn), h)
    h.update(b"\x00" + repr(signature).encode())
    h.update(b"\x00" + json.dumps(backend_descriptor(), sort_keys=True).encode())
    h.update(b"\x00" + _kernel_sources_digest().encode())
    for part in extra:
        h.update(b"\x00" + str(part).encode())
    return h.hexdigest()


def library_key(file_name: str) -> str:
    """Store key of a kernel library: its ``lib<name>-<hash>.so`` name
    (the hash covers its sources and flags) and the backend."""
    h = hashlib.sha256(b"kernel-library\x00" + file_name.encode())
    h.update(b"\x00" + json.dumps(backend_descriptor(), sort_keys=True).encode())
    return h.hexdigest()


def serialize_compiled(record: dict, store: Optional["ExecutableStore"] = None) -> bytes:
    """A program's record ``{"name", "signature", "libraries": [names]}``
    -> its store entry's bytes. With a ``store``, each kernel library the
    record names is put into it as an entry of its own (unless a sound
    one is there), and the entry keeps the library's key and file name."""
    from ..kernels import build

    libs = []
    for name in sorted(record.get("libraries", ())):
        path = build.library_path(name)
        entry = {"name": name, "file": path.name, "key": library_key(path.name)}
        if store is not None:
            try:
                sound = store.get(entry["key"]) is not None
            except (CorruptEntryError, StaleEntryError):
                sound = False
            if not sound:
                store.put(entry["key"], path.read_bytes(), name=path.name, meta={"kind": "library", "library": name})
        libs.append(entry)
    out = {"name": record.get("name", "program"), "signature": str(record.get("signature", "")), "libraries": libs}
    return json.dumps(out, sort_keys=True).encode()


def deserialize_compiled(blob: bytes, store: Optional["ExecutableStore"] = None) -> dict:
    """Inverse of :func:`serialize_compiled`: parse the record and, with a
    ``store``, install every library it names into the kernel build
    directory (no ``nvcc`` runs here). Raises :class:`CorruptEntryError` /
    :class:`StaleEntryError` (with the offending entry's ``key``) for a
    library entry that is missing, poisoned or stale. Returns the record."""
    from ..kernels import build

    try:
        record = json.loads(blob)
        libs = [(lib["name"], lib["file"], lib["key"]) for lib in record["libraries"]]
    except (ValueError, KeyError, TypeError) as e:
        raise CorruptEntryError(f"unreadable program record ({e})") from e
    if store is not None:
        for name, file_name, key in libs:
            data = store.get(key)
            if data is None:
                raise CorruptEntryError(f"library entry {key[:16]} ({file_name}) is missing from {store.path}")
            build.install_library(file_name, data)
    return record


class ExecutableStore:
    """Content-addressed directory of program and kernel-library entries.

    ``get`` raises :class:`CorruptEntryError` / :class:`StaleEntryError`
    rather than returning bad bytes: the caller (ProgramCache) counts
    either as a rejection, deletes the entry and builds anew.
    """

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)

    # ------------------------------------------------------------------ #
    # entry IO
    # ------------------------------------------------------------------ #

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.path, key + _SUFFIX)

    def put(self, key: str, blob: bytes, name: str = "program", meta: Optional[dict] = None) -> str:
        header = {
            "key": key,
            "name": name,
            "crc32": zlib.crc32(blob),
            "size": len(blob),
            "created": time.time(),
            "backend": backend_descriptor(),
        }
        if meta:
            header.update(meta)
        final = self._entry_path(key)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_MAGIC + b"\n")
                f.write(json.dumps(header, sort_keys=True).encode() + b"\n")
                f.write(blob)
            os.replace(tmp, final)  # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return final

    def _read(self, key: str, with_blob: bool):
        path = self._entry_path(key)
        if not os.path.exists(path):
            return None, None
        with open(path, "rb") as f:
            magic = f.readline().rstrip(b"\n")
            if magic != _MAGIC:
                raise CorruptEntryError(f"{path}: bad magic {magic!r}", key=key)
            try:
                header = json.loads(f.readline())
            except ValueError as e:  # not JSON, or not even UTF-8
                raise CorruptEntryError(f"{path}: unreadable header ({e})", key=key) from e
            if not isinstance(header, dict):
                raise CorruptEntryError(f"{path}: header is not an object", key=key)
            return header, (f.read() if with_blob else None)

    def read_header(self, key: str) -> Optional[dict]:
        return self._read(key, with_blob=False)[0]

    def get(self, key: str) -> Optional[bytes]:
        header, blob = self._read(key, with_blob=True)
        if header is None:
            return None
        path = self._entry_path(key)
        # backend gate BEFORE the crc: a stale entry may be intact, but
        # another card's or another torch's library must not be loaded
        want = backend_descriptor()
        if header.get("backend") != want:
            raise StaleEntryError(f"{path}: written for {header.get('backend')!r}, running {want!r}", key=key)
        if header.get("size") != len(blob) or header.get("crc32") != zlib.crc32(blob):
            raise CorruptEntryError(f"{path}: crc/size mismatch (truncated or poisoned)", key=key)
        return blob

    def remove(self, key: str) -> bool:
        path = self._entry_path(key)
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    # ------------------------------------------------------------------ #
    # bulk surface (CLI stats / clear / export)
    # ------------------------------------------------------------------ #

    def keys(self) -> list[str]:
        return sorted(f[: -len(_SUFFIX)] for f in os.listdir(self.path) if f.endswith(_SUFFIX))

    def entries(self) -> list[dict]:
        """Header dicts for every entry (a corrupt header is reported with
        an ``"error"`` field instead of raising: stats must always print)."""
        out = []
        for key in self.keys():
            try:
                header = self.read_header(key) or {}
            except CorruptEntryError as e:
                header = {"key": key, "error": str(e)}
            header["file_bytes"] = os.path.getsize(self._entry_path(key))
            out.append(header)
        return out

    def total_bytes(self) -> int:
        return sum(os.path.getsize(os.path.join(self.path, f)) for f in os.listdir(self.path) if f.endswith(_SUFFIX))

    def clear(self) -> int:
        n = 0
        for key in self.keys():
            self.remove(key)
            n += 1
        return n

    def export_archive(self, out_path: str, keys: Optional[list] = None) -> int:
        """Bundle entries into a ``.tar.gz`` a replica fleet can ship around
        (the ``aot_export`` surface). Returns the entry count."""
        import tarfile

        keys = list(keys) if keys is not None else self.keys()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
        with tarfile.open(out_path, "w:gz") as tar:
            for key in keys:
                path = self._entry_path(key)
                if os.path.exists(path):
                    tar.add(path, arcname=key + _SUFFIX)
        return len(keys)

    def import_archive(self, in_path: str) -> int:
        """Unpack an :meth:`export_archive` bundle into this store. Each
        member's magic is checked before it is published; junk members
        are skipped. Returns the imported entry count."""
        import tarfile

        n = 0
        with tarfile.open(in_path, "r:gz") as tar:
            for member in tar.getmembers():
                base = os.path.basename(member.name)
                if not (member.isfile() and base.endswith(_SUFFIX)):
                    continue
                blob = tar.extractfile(member).read()
                head, _, _ = blob.partition(b"\n")
                if head != _MAGIC:
                    continue
                key = base[: -len(_SUFFIX)]
                fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self._entry_path(key))
                n += 1
        return n


def resolve_cache_dir(
    explicit: Optional[str] = None,
    project_dir: Optional[str] = None,
    dir_name: str = "compile_cache",
) -> Optional[str]:
    """The ONE precedence rule for where the store lives: explicit
    argument > ``ACCELERATE_COMPILE_CACHE_DIR`` > the project's
    ``{project_dir}/{dir_name}`` > None (memory-only cache)."""
    if explicit:
        return explicit
    env = os.environ.get("ACCELERATE_COMPILE_CACHE_DIR")
    if env:
        return env
    if project_dir:
        return os.path.join(project_dir, dir_name)
    return None


def configure_persistent_cache(cache_dir: str, min_compile_time_secs: float = 0.0) -> bool:
    """Point this process's kernel library directory at ``{cache_dir}/cuda``,
    the counterpart of jax's persistent compilation cache: every library
    ``nvcc`` builds from here on lands there and is found built by the
    next process that points at it.

    Respects an existing choice: ``ACCELERATE_TPU_TORCH_BUILD_DIR`` or an
    earlier call wins (re-pointing mid-process would split the built
    set). ``min_compile_time_secs`` keeps the JAX signature; every library
    is kept (the smallest takes seconds of ``nvcc``). Returns True when
    THIS call did the configuring."""
    from ..utils.environment import set_kernel_build_dir

    del min_compile_time_secs
    path = os.path.join(cache_dir, "cuda")
    if not set_kernel_build_dir(path):
        return False
    os.makedirs(path, exist_ok=True)
    return True
