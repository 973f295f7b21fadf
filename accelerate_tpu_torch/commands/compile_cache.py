"""``compile-cache``: inspect, pre-warm and clear the persistent compile
cache (see :mod:`accelerate_tpu_torch.aot`).

Counterpart of :mod:`accelerate_tpu.commands.compile_cache`. ``stats``
reads the executable store (program records and kernel libraries) and the
kernel library directory beside it, without touching the card. ``warm``
runs a step or decode function once at ``--arg f32[8,128]``-style specs
(the kernel check's loaders, :mod:`.kernelcheck`), so a serving fleet or a
trainer to be resumed finds its programs and kernel libraries in the store
before the first request lands. ``clear`` removes entries. ``--selfcheck``
proves the loop on the CPU: a cold compile, a warm deserialize with no
compile, and a poisoned entry rejected and healed with the result
unchanged.

Examples::

    python -m accelerate_tpu_torch.commands.cli compile-cache stats --dir /ckpts/run1/compile_cache
    python -m accelerate_tpu_torch.commands.cli compile-cache warm step.py::step --arg "f32[32,128]"
    python -m accelerate_tpu_torch.commands.cli compile-cache clear --dir ... --yes
    python -m accelerate_tpu_torch.commands.cli compile-cache --selfcheck
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _store_dir(args) -> str | None:
    from ..aot.cache import resolve_cache_dir

    base = resolve_cache_dir(getattr(args, "dir", None))
    if base is None:
        return None
    # the Accelerator lays the store at {cache_dir}/executables with the kernel
    # library directory beside it; accept either the base or the store itself
    sub = os.path.join(base, "executables")
    if os.path.isdir(sub):
        return sub
    return base


def compile_cache_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("compile-cache", help="Inspect / pre-warm / clear the persistent compile cache")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch compile-cache")
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="Prove cold compile -> warm deserialize -> poisoned-entry rejection on the CPU",
    )
    sub = parser.add_subparsers(dest="cc_command")

    p_stats = sub.add_parser("stats", help="Entry table + totals for the executable store")
    p_stats.add_argument("--dir", default=None, help="cache dir (default: ACCELERATE_COMPILE_CACHE_DIR)")
    p_stats.add_argument("--format", choices=("text", "json"), default="text")
    p_stats.set_defaults(cc_func=stats_command)

    p_warm = sub.add_parser("warm", help="Run a step/decode fn once into the store from --arg shape specs")
    p_warm.add_argument("target", help="function: file.py::fn or pkg.module:fn")
    p_warm.add_argument("--arg", action="append", default=[], help="sample arg spec like f32[8,128] (repeatable)")
    p_warm.add_argument("--mesh", default=None, help="mesh shape, e.g. data=1 (one device: more is refused)")
    p_warm.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the function runs (the card unless cpu is asked for)")
    p_warm.add_argument("--dir", default=None, help="cache dir (default: ACCELERATE_COMPILE_CACHE_DIR)")
    p_warm.add_argument("--name", default=None, help="program name recorded in the store (default: the fn name)")
    p_warm.set_defaults(cc_func=warm_command)

    p_clear = sub.add_parser("clear", help="Remove every entry from the executable store")
    p_clear.add_argument("--dir", default=None, help="cache dir (default: ACCELERATE_COMPILE_CACHE_DIR)")
    p_clear.add_argument("--yes", action="store_true", help="actually delete (otherwise dry-run)")
    p_clear.set_defaults(cc_func=clear_command)

    if subparsers is not None:
        parser.set_defaults(func=compile_cache_command)
    return parser


def compile_cache_command(args) -> int:
    if args.selfcheck:
        rc = selfcheck_command(args)
        if rc or not getattr(args, "cc_command", None):
            return rc
    if not getattr(args, "cc_command", None):
        print("usage: accelerate-tpu-torch compile-cache {stats|warm|clear} [--dir DIR] | --selfcheck")
        return 2
    return args.cc_func(args)


# --------------------------------------------------------------------- #
# stats
# --------------------------------------------------------------------- #


def _library_dir_stats(base_dir: str) -> dict | None:
    """The kernel library directory ``configure_persistent_cache`` points
    at (``{cache_dir}/cuda``), when there is one."""
    libs = os.path.join(base_dir, "cuda")
    if not os.path.isdir(libs):
        return None
    files = [os.path.join(libs, f) for f in os.listdir(libs) if f.endswith(".so")]
    return {"dir": libs, "entries": len(files), "bytes": sum(os.path.getsize(f) for f in files)}


def stats_command(args) -> int:
    store_dir = _store_dir(args)
    if store_dir is None:
        print("no cache dir: pass --dir or set ACCELERATE_COMPILE_CACHE_DIR")
        return 2
    from ..aot.cache import ExecutableStore

    store = ExecutableStore(store_dir)
    entries = store.entries()
    base = os.path.dirname(store_dir) if os.path.basename(store_dir) == "executables" else store_dir
    report = {"store_dir": store_dir, "entries": len(entries), "total_bytes": store.total_bytes(), "programs": entries}
    libs = _library_dir_stats(base)
    if libs:
        report["kernel_libraries"] = libs
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    print(f"compile cache at {store_dir}: {len(entries)} entrie(s), {report['total_bytes'] / 1024:.1f} KiB")
    for e in entries:
        if "error" in e:
            print(f"  {e.get('key', '?')[:16]}  CORRUPT: {e['error']}")
            continue
        backend = e.get("backend") or {}
        print(
            f"  {e['key'][:16]}  {e.get('kind', '?'):<8} {e.get('name', '?'):<40} {backend.get('platform', '?'):<4} "
            f"torch {backend.get('torch', '?'):<14} {e['file_bytes'] / 1024:8.1f} KiB"
        )
    if libs:
        print(f"kernel library directory at {libs['dir']}: {libs['entries']} librar(ies), {libs['bytes'] / 1024:.1f} KiB")
    return 0


# --------------------------------------------------------------------- #
# warm
# --------------------------------------------------------------------- #


def _devices_in(mesh: str | None) -> int:
    """The device count a ``--mesh data=4,tensor=2`` spec asks for."""
    n = 1
    for part in (mesh or "").split(","):
        if part.strip():
            _, _, size = part.partition("=")
            n *= int(size)
    return n


def warm_command(args) -> int:
    store_dir = _store_dir(args)
    if store_dir is None:
        print("no cache dir: pass --dir or set ACCELERATE_COMPILE_CACHE_DIR")
        return 2
    if _devices_in(args.mesh) > 1:
        raise NotImplementedError(
            f"compile-cache warm --mesh {args.mesh}: a mesh over more than one device is not ported to "
            "accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 8)"
        )
    import torch

    from ..aot import ExecutableStore, ProgramCache
    from ..utils.environment import resolve_device
    from .kernelcheck import load_step, resolve_sample_args

    device = resolve_device(args.device)
    module, fn = load_step(args.target)
    specs = tuple(
        torch.empty(s.shape, dtype=s.dtype, device=device) if isinstance(s, torch.Tensor) else s
        for s in resolve_sample_args(module, fn, args.arg)
    )
    pc = ProgramCache(store=ExecutableStore(store_dir))
    name = args.name or fn.__name__
    t0 = time.perf_counter()
    pc.compile(fn, *specs, name=name)
    ms = (time.perf_counter() - t0) * 1000.0
    outcome = "deserialized (already warm)" if pc.deserialized else "compiled + stored"
    print(f"warm {name}: {outcome} in {ms:.1f} ms -> {store_dir} ({len(pc.store.keys())} entrie(s) total)")
    return 0


# --------------------------------------------------------------------- #
# clear
# --------------------------------------------------------------------- #


def clear_command(args) -> int:
    store_dir = _store_dir(args)
    if store_dir is None:
        print("no cache dir: pass --dir or set ACCELERATE_COMPILE_CACHE_DIR")
        return 2
    from ..aot.cache import ExecutableStore

    store = ExecutableStore(store_dir)
    keys = store.keys()
    if not args.yes:
        print(f"would remove {len(keys)} entrie(s) from {store_dir} (pass --yes to delete)")
        return 0
    n = store.clear()
    print(f"removed {n} entrie(s) from {store_dir}")
    return 0


# --------------------------------------------------------------------- #
# selfcheck
# --------------------------------------------------------------------- #


def selfcheck_command(args) -> int:
    """Cold compile -> cross-cache warm hit -> poisoned entry rejected
    cleanly, on the CPU; nonzero on any broken link."""
    import tempfile

    import torch

    from ..aot import ExecutableStore, ProgramCache

    failures = []
    fn = lambda x: (torch.sin(x) @ torch.cos(x).T).sum()  # noqa: E731
    spec = torch.empty(16, 32)
    x = torch.ones(16, 32)
    with tempfile.TemporaryDirectory() as tmp:
        cold = ProgramCache(store=ExecutableStore(tmp))
        ref = float(cold.compile(fn, spec, name="selfcheck")(x))
        if cold.misses != 1 or cold.store is None or len(cold.store.keys()) != 1:
            failures.append(f"cold pass: expected 1 miss + 1 stored entry, got {cold.stats()}")

        warm = ProgramCache(store=ExecutableStore(tmp))
        got = float(warm.compile(fn, spec, name="selfcheck")(x))
        if warm.misses != 0 or warm.deserialized != 1:
            failures.append(f"warm pass: expected 0 compiles + 1 deserialize, got {warm.stats()}")
        if got != ref:
            failures.append(f"warm result {got} != cold result {ref}")
        print(f"[compile-cache selfcheck] cold compile -> warm deserialize: {'OK' if not failures else 'FAILED'}")

        # poison the stored entry: it must be rejected (and healed), never used
        store = ExecutableStore(tmp)
        key = store.keys()[0]
        path = store._entry_path(key)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2] + b"\xde\xad" * 8 + blob[len(blob) // 2 :])
        healed = ProgramCache(store=ExecutableStore(tmp))
        got = float(healed.compile(fn, spec, name="selfcheck")(x))
        if healed.rejected != 1 or healed.misses != 1:
            failures.append(f"poison pass: expected 1 reject + 1 recompile, got {healed.stats()}")
        if got != ref:
            failures.append(f"post-poison result {got} != {ref}")
        print(f"[compile-cache selfcheck] poisoned entry rejected + healed: "
              f"{'OK' if healed.rejected == 1 else 'FAILED'}")

    for msg in failures:
        print(f"[compile-cache selfcheck] FAILED: {msg}")
    if not failures:
        print("[compile-cache selfcheck] OK: store round-trip, zero-compile warm start, poison rejection")
    return 1 if failures else 0


def main():
    args = compile_cache_parser().parse_args()
    raise SystemExit(compile_cache_command(args))


if __name__ == "__main__":
    main()
