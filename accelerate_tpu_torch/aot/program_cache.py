"""ProgramCache: the shared front end every program of the port goes
through.

Counterpart of :mod:`accelerate_tpu.aot.program_cache`. A program is a
callable at an input signature (:mod:`.cache`); its "compile" is its
first call at that signature, the call that builds or loads the kernel
libraries it needs. One object answers "is this program ready?" three
ways, cheapest first:

1. **memory**: this process already ran it;
2. **disk**: another process ran it (:class:`~.cache.ExecutableStore`):
   install the libraries it recorded into the kernel build directory
   instead of running ``nvcc``, the warm start a restarted trainer or a
   new serving replica takes;
3. **compile**: run it once inside :func:`..kernels.build.recording`,
   then store its record and its libraries so the NEXT process hits (2).

Whatever the route, the callable that runs is the caller's own: a stored
entry carries kernel libraries and a signature, never the weights or the
state a callable closes over.

Every outcome lands in telemetry: ``compile_cache_hit`` (with ``source``
``"memory"|"disk"`` and ``deserialize_ms``), ``compile_cache_miss`` (with
``compile_ms``), ``compile_cache_store``, and ``compile_cache_reject`` for
a poisoned or stale entry, which is deleted and built anew, never used.
The counters ``hits`` / ``misses`` / ``deserialized`` / ``rejected`` mirror
them on the instance.

:meth:`ProgramCache.wrap_jit` is the bridge for callables whose inputs are
only known at call time (``build_train_step``, the serving engine's
prefill and decode tick): it keys each call's input signature, resolves a
first-seen one through the cache, and exposes ``_cache_size`` (the
signatures seen) for the recompile watchdog.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .cache import (
    CorruptEntryError,
    ExecutableStore,
    StaleEntryError,
    _code_of,
    _hash_code,
    _qualname,
    content_key,
    deserialize_compiled,
    resolve_cache_dir,
    serialize_compiled,
)


def _noop_log():
    from ..telemetry.eventlog import EventLog

    return EventLog(None)


def _signature(tree):
    """Hashable input signature of a tree of dicts, lists and tuples:
    shape, dtype and device of each tensor leaf, shape and dtype of each
    numpy leaf, type and value of each Python scalar, the type of any
    other object (what it holds is the program's closure, keyed by the
    caller's salt)."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), str(tree.dtype), str(tree.device))
    if isinstance(tree, np.ndarray):
        return ("ndarray", tuple(tree.shape), str(tree.dtype))
    if isinstance(tree, dict):
        return ("dict", tuple((str(k), _signature(tree[k])) for k in sorted(tree, key=str)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_signature(v) for v in tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return ("py", type(tree).__name__, tree)
    if isinstance(tree, (torch.dtype, torch.device)):
        return ("py", type(tree).__name__, str(tree))
    return ("obj", f"{type(tree).__module__}.{type(tree).__qualname__}")


def _call_signature(args: tuple, kwargs: dict, statics: tuple):
    """A call's signature: its dynamic positional arguments, its keyword
    arguments, and its static arguments (keyed by value); the same for
    :meth:`ProgramCache.compile` and a :meth:`ProgramCache.wrap_jit` call
    on the same inputs."""
    return (_signature(tuple(a for i, a in enumerate(args) if i not in statics)), _signature(kwargs),
            tuple(_signature(args[i]) for i in statics if i < len(args)))


def layout_salt(*objs) -> str:
    """A digest of what a program closes over, for ``key_salt``: for a
    module (or a prepared model's ``.module``) its class and every
    parameter's and buffer's name, shape and dtype; for a callable its
    qualified name and code; for anything else its ``repr``."""
    h = hashlib.sha256()
    for obj in objs:
        module = getattr(obj, "module", obj)
        if isinstance(module, torch.nn.Module):
            h.update(f"\x00{type(module).__module__}.{type(module).__qualname__}".encode())
            for n, t in itertools.chain(module.named_parameters(), module.named_buffers()):
                h.update(f"\x00{n}:{tuple(t.shape)}:{t.dtype}".encode())
        elif callable(obj):
            h.update(b"\x00" + _qualname(obj).encode())
            try:
                _hash_code(_code_of(obj), h)
            except TypeError:  # a builtin: its name is all there is
                pass
        else:
            h.update(b"\x00" + repr(obj).encode())
    return h.hexdigest()[:32]


def _materialize(spec):
    """Zeros shaped like ``spec`` on its device: a tensor gives its shape,
    dtype and device, a numpy array its shape and dtype; any other object
    with ``shape`` and ``dtype`` gives a tensor on its ``device`` (the
    CPU without one). Containers are walked, scalars kept."""
    if isinstance(spec, torch.Tensor):
        return torch.zeros_like(spec)
    if isinstance(spec, np.ndarray):
        return np.zeros_like(spec)
    if isinstance(spec, dict):
        return {k: _materialize(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(_materialize(v) for v in spec)
    if hasattr(spec, "shape") and hasattr(spec, "dtype"):
        return torch.zeros(tuple(spec.shape), dtype=spec.dtype, device=getattr(spec, "device", "cpu"))
    return spec


class ProgramCache:
    """Compile-or-fetch for the port's programs, with an optional
    persistent store and full telemetry.

    ``store=None`` keeps the cache memory-only (it still deduplicates and
    still counts); pass an :class:`ExecutableStore` (or use
    :meth:`from_env`) to make a program's kernel libraries survive the
    process.
    """

    def __init__(self, store: Optional[ExecutableStore] = None, log=None, name: str = "programs"):
        self.store = store
        self.log = log if log is not None else _noop_log()
        self.name = name
        self._mem: dict = {}  # key -> the program's record (the libraries it needs)
        self.hits = 0
        self.misses = 0
        self.deserialized = 0
        self.rejected = 0
        self._serialize_broken = False  # the store refused a write; warn once, go memory-only

    @classmethod
    def from_env(cls, log=None, project_dir: Optional[str] = None, name: str = "programs") -> "ProgramCache":
        """A cache whose store follows ``ACCELERATE_COMPILE_CACHE_DIR`` (or
        ``{project_dir}/compile_cache``); memory-only when neither is set:
        the zero-config construction serving and the CLI use."""
        cache_dir = resolve_cache_dir(project_dir=project_dir)
        return cls(store=ExecutableStore(cache_dir) if cache_dir else None, log=log, name=name)

    # ------------------------------------------------------------------ #
    # compile-or-fetch
    # ------------------------------------------------------------------ #

    def _reject(self, key: str, name: str, exc: Exception) -> None:
        bad = getattr(exc, "key", None) or key
        self.rejected += 1
        self.store.remove(bad)
        self.log.event(
            "compile_cache_reject", severity="warning", program=name, key=bad[:16],
            reason=type(exc).__name__, detail=str(exc)[:200],
        )

    def _fetch(self, key: str, name: str) -> bool:
        """Memory, then disk, for program ``key``: True when it is ready
        (its libraries installed), False when it must be compiled."""
        if key in self._mem:
            self.hits += 1
            self.log.event("compile_cache_hit", program=name, key=key[:16], source="memory")
            return True
        if self.store is None:
            return False
        t0 = time.perf_counter()
        try:
            blob = self.store.get(key)
            if blob is None:
                return False
            record = deserialize_compiled(blob, self.store)
        except (CorruptEntryError, StaleEntryError) as e:
            # a poisoned or stale entry (the program's or a library's):
            # delete it, count it, build anew; it never runs
            self._reject(key, name, e)
            return False
        ms = (time.perf_counter() - t0) * 1000.0
        self.hits += 1
        self.deserialized += 1
        self._mem[key] = {"libraries": sorted(lib["name"] for lib in record["libraries"])}
        self.log.event("compile_cache_hit", program=name, key=key[:16], source="disk", deserialize_ms=round(ms, 3))
        self.log.counter("compile_cache.deserialize_ms", round(ms, 3), program=name)
        return True

    def _compile(self, key: str, name: str, signature, call: Callable):
        """Run ``call`` (the program's first call) recording the kernel
        libraries it loads; store the record. Returns what ``call`` did."""
        from ..kernels import build

        t0 = time.perf_counter()
        with build.recording() as libs:
            out = call()
        ms = (time.perf_counter() - t0) * 1000.0
        self.misses += 1
        record = {"name": name, "signature": signature, "libraries": sorted(libs)}
        self._mem[key] = {"libraries": record["libraries"]}
        self.log.event("compile_cache_miss", program=name, key=key[:16], compile_ms=round(ms, 3))
        self.log.counter("compile_cache.compile_ms", round(ms, 3), program=name)
        if self.store is not None and not self._serialize_broken:
            try:
                self.store.put(key, serialize_compiled(record, self.store), name=name, meta={"kind": "program"})
                self.log.event("compile_cache_store", program=name, key=key[:16])
            except OSError as e:
                # a full or read-only store: the cache goes memory-only
                # rather than failing the program
                self._serialize_broken = True
                self.log.event(
                    "compile_cache_store_failed", severity="warning", program=name,
                    reason=type(e).__name__, detail=str(e)[:200],
                )
        return out

    def compile(
        self,
        fn: Callable,
        *specs,
        name: str = "program",
        donate_argnums=(),
        static_argnums=(),
        key_salt=(),
    ):
        """Make ``fn`` ready at the inputs ``specs`` describe and return
        it: the explicit-inputs path (the CLI's ``warm``). This is the
        port's lowering plus compile: a spec that is a tensor (or has
        ``shape``, ``dtype`` and ``device``) becomes zeros of its shape on
        its device, and ``fn`` is called on them once, building or loading
        its kernel libraries; a memory or disk hit calls nothing.
        ``static_argnums`` are passed as they are and keyed by value.
        ``donate_argnums`` keeps the JAX signature (eager PyTorch frees
        what it no longer needs)."""
        del donate_argnums
        statics = tuple(static_argnums)
        sig = _call_signature(specs, {}, statics)
        key = content_key(fn, sig, extra=key_salt)
        if not self._fetch(key, name):
            args = tuple(s if i in statics else _materialize(s) for i, s in enumerate(specs))
            self._compile(key, name, sig, lambda: fn(*args))
        return fn

    # ------------------------------------------------------------------ #
    # call-time dispatch (the inputs are known only at the call)
    # ------------------------------------------------------------------ #

    def wrap_jit(self, fn: Callable, name: str = "step", static_argnums=(), key_salt=()):
        """Route ``fn``'s calls through this cache.

        The wrapper keys each call's input signature (the tree's structure,
        each tensor's shape, dtype and device, each scalar's value, the
        static arguments' values) and keeps one entry a signature: a
        first-seen signature resolves through memory and disk, or its call
        is the compile, so a restarted process re-creating the same
        callable installs the stored libraries instead of running ``nvcc``;
        later calls go straight to ``fn``. ``key_salt`` keys what ``fn``
        closes over (a model's layout). Exposes ``_cache_size`` (the
        signatures seen) so the recompile watchdog's probe works through
        the wrapper, ``_program_cache`` and ``__wrapped__``."""
        statics = tuple(static_argnums)
        table: set = set()

        def dispatch(*args, **kwargs):
            sig = _call_signature(args, kwargs, statics)
            if sig in table:
                return fn(*args, **kwargs)
            key = content_key(fn, sig, extra=key_salt)
            if self._fetch(key, name):
                table.add(sig)
                return fn(*args, **kwargs)
            out = self._compile(key, name, sig, lambda: fn(*args, **kwargs))
            table.add(sig)
            return out

        dispatch._cache_size = lambda: len(table)
        dispatch._program_cache = self
        dispatch.__wrapped__ = fn
        return dispatch

    # ------------------------------------------------------------------ #
    # explicit AOT surface + stats
    # ------------------------------------------------------------------ #

    def aot_export(self, out_path: str, keys=None) -> int:
        """Bundle the store's entries into a portable archive (ship to a
        replica fleet, bake into an image). Requires a store."""
        if self.store is None:
            raise ValueError(
                "aot_export needs a persistent store (set ACCELERATE_COMPILE_CACHE_DIR or CompileKwargs.cache_dir)"
            )
        n = self.store.export_archive(out_path, keys=keys)
        self.log.event("compile_cache_export", path=out_path, entries=n)
        return n

    def aot_load(self, in_path: str) -> int:
        """Import an :meth:`aot_export` archive into the store; programs
        run afterwards install their libraries instead of building them."""
        if self.store is None:
            raise ValueError(
                "aot_load needs a persistent store (set ACCELERATE_COMPILE_CACHE_DIR or CompileKwargs.cache_dir)"
            )
        n = self.store.import_archive(in_path)
        self.log.event("compile_cache_import", path=in_path, entries=n)
        return n

    def stats(self) -> dict:
        out = {
            "hits": self.hits,
            "misses": self.misses,
            "deserialized": self.deserialized,
            "rejected": self.rejected,
            "in_memory": len(self._mem),
        }
        if self.store is not None:
            out["store_dir"] = self.store.path
            out["store_entries"] = len(self.store.keys())
            out["store_bytes"] = self.store.total_bytes()
        return out


def default_program_cache(log=None, project_dir: Optional[str] = None) -> Optional[ProgramCache]:
    """A :class:`ProgramCache` when the environment opted into persistence
    (``ACCELERATE_COMPILE_CACHE_DIR`` set, or a ``project_dir``), else
    None."""
    if not os.environ.get("ACCELERATE_COMPILE_CACHE_DIR") and not project_dir:
        return None
    return ProgramCache.from_env(log=log, project_dir=project_dir)
