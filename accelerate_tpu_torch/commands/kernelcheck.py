"""``kernel-check``: the port's kernel analyzer and TPU10xx rules, before
any kernel is built.

Counterpart of ``accelerate-tpu kernel-check``
(:mod:`accelerate_tpu.commands.kernelcheck`), run as
``python -m accelerate_tpu_torch.commands.kernelcheck``. Two modes over
one rule set:

* **traced** (``file.py::fn`` or ``pkg.module:fn``): trace the function on
  ``meta`` tensors, record every CUDA launch its kernel wrappers would make
  (grid, tiles, index maps, shared memory, aliases), run TPU1001-1006,
  and probe the function on concrete operands (on the card unless
  ``--device cpu``; ``--no-probe`` skips it);
* **paths** (files or directories, or ``--changed`` for the git diff): the
  AST registration gate: after ``lib = load("<source>")`` every
  ``lib.<entry>(...)`` must name an entry with a registered contract
  (TPU1005).

Examples::

    python -m accelerate_tpu_torch.commands.kernelcheck step.py::decode_step --arg f32[16,128] --arg f32[128,128]
    python -m accelerate_tpu_torch.commands.kernelcheck accelerate_tpu_torch/kernels   # the registration gate
    python -m accelerate_tpu_torch.commands.kernelcheck --changed
    python -m accelerate_tpu_torch.commands.kernelcheck --selfcheck   # TPU1001-1006 fire, twins clean, reference exact

Project configuration files (``[tool.accelerate-tpu.lint]``) are not
ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import sys

_DTYPE_ALIASES = {
    "f32": "float32", "f64": "float64", "f16": "float16", "bf16": "bfloat16",
    "i32": "int32", "i64": "int64", "i8": "int8", "u8": "uint8", "bool": "bool",
    "f8e4m3": "float8_e4m3fn", "f8e5m2": "float8_e5m2",
}
_ARG_RE = re.compile(r"^\s*([A-Za-z0-9_]+)\[([0-9,\s]*)\]\s*$")


def parse_arg_spec(spec: str):
    """``"f32[8,128]"`` -> an empty ``meta`` tensor of that shape and dtype
    (PyTorch's counterpart of ``jax.ShapeDtypeStruct``)."""
    import torch

    m = _ARG_RE.match(spec)
    if m is None:
        raise ValueError(f"bad --arg spec {spec!r}; expected e.g. f32[8,128] or i32[16]")
    name = _DTYPE_ALIASES.get(m.group(1), m.group(1))
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"bad --arg dtype {m.group(1)!r} in {spec!r}")
    shape = tuple(int(d) for d in m.group(2).split(",") if d.strip())
    return torch.empty(shape, dtype=dtype, device="meta")


def load_step(target: str):
    """Resolve ``file.py::fn`` or ``pkg.module:fn`` to ``(module, fn)``."""
    if "::" in target:
        path, _, fn_name = target.partition("::")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such file: {path}")
        spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(path))[0], path)
        module = importlib.util.module_from_spec(spec)
        sys.path.insert(0, os.path.dirname(os.path.abspath(path)))
        try:
            spec.loader.exec_module(module)
        finally:
            sys.path.pop(0)
    elif ":" in target:
        mod_name, _, fn_name = target.partition(":")
        module = importlib.import_module(mod_name)
    else:
        raise ValueError(f"target {target!r} must be file.py::fn or pkg.module:fn")
    try:
        fn = getattr(module, fn_name)
    except AttributeError as e:
        raise AttributeError(f"{target!r}: module has no function {fn_name!r}") from e
    return module, fn


def resolve_sample_args(module, fn, arg_specs):
    """Sample arguments: explicit ``--arg`` specs win; else the module's
    ``<fn>_sample_args()`` / ``SAMPLE_ARGS`` convention."""
    if arg_specs:
        return tuple(parse_arg_spec(s) for s in arg_specs)
    samples = getattr(module, f"{fn.__name__}_sample_args", None) or getattr(module, "SAMPLE_ARGS", None)
    if samples is None:
        raise ValueError(
            f"no sample shapes for {fn.__name__}: pass --arg 'f32[8,128]' (repeatable) "
            f"or define {fn.__name__}_sample_args() / SAMPLE_ARGS in the module"
        )
    return tuple(samples()) if callable(samples) else tuple(samples)


def kernelcheck_parser():
    parser = argparse.ArgumentParser("python -m accelerate_tpu_torch.commands.kernelcheck")
    parser.add_argument(
        "targets", nargs="*",
        help="file.py::fn / pkg.module:fn (traced mode) or files/directories (AST registration gate)",
    )
    parser.add_argument("--changed", action="store_true",
                        help="Gate only git-touched .py files (falls back to the given targets without git)")
    parser.add_argument("--arg", action="append", default=[], help="sample arg spec like f32[8,128] (repeatable)")
    parser.add_argument("--device", default=None, help="where the probe runs: cuda (default) or cpu")
    parser.add_argument("--no-probe", action="store_true", help="Skip running the function on concrete operands")
    parser.add_argument("--format", choices=("text", "json", "sarif"), default="text", help="Report format")
    parser.add_argument("--select", default=None, help="Comma-separated rule IDs to run (default: all)")
    parser.add_argument("--ignore", default="", help="Comma-separated rule IDs to skip")
    parser.add_argument("--strict", action="store_true", help="Exit nonzero on warnings too")
    parser.add_argument("--selfcheck", action="store_true",
                        help="Prove TPU1001-1006 fire on seeded defects, clean twins stay silent, reference cost exact")
    return parser


def _split_ids(raw):
    return frozenset(x.strip() for x in (raw or "").split(",") if x.strip())


def _is_traced_target(target: str) -> bool:
    return "::" in target or (":" in target and not os.path.exists(target))


def _selfcheck() -> int:
    from accelerate_tpu_torch.analysis.selfcheck import run_kernel_selfcheck

    ok, lines = run_kernel_selfcheck()
    for line in lines:
        print(line)
    if not ok:
        print("kernel-check selfcheck FAILED")
        return 1
    return 0


def kernelcheck_command(args) -> int:
    if args.selfcheck:
        rc = _selfcheck()
        if rc or not (args.targets or args.changed):
            return rc
    if not args.targets and not args.changed:
        print("usage: kernelcheck file.py::fn [--arg f32[8,128] ...] | [paths ...] [--changed] [--selfcheck]")
        return 2

    from accelerate_tpu_torch.analysis import exit_code, render_sarif, render_text
    from accelerate_tpu_torch.analysis.rules import filter_findings

    select = _split_ids(args.select) or None
    ignore = _split_ids(args.ignore)
    traced = [t for t in args.targets if _is_traced_target(t)]
    paths = [t for t in args.targets if not _is_traced_target(t)]
    if args.changed:
        from accelerate_tpu_torch.analysis.changed import changed_python_files

        scoped = changed_python_files()
        if scoped is None:
            print("kernel-check: --changed needs a git work tree; gating the full paths", file=sys.stderr)
        else:
            paths = scoped

    if traced:
        from accelerate_tpu_torch.analysis.kernelmodel import kernel_check

        module, fn = load_step(traced[0])
        report = kernel_check(
            fn, *resolve_sample_args(module, fn, args.arg), select=select,
            ignore=tuple(ignore), probe=not args.no_probe, device=args.device,
        )
        if args.format == "json":
            print(json.dumps(report.as_dict(), indent=2))
        elif args.format == "sarif":
            print(render_sarif(report.findings))
        else:
            print(report.render_text())
        return exit_code(report.findings, strict=args.strict)

    from accelerate_tpu_torch.analysis.kernelmodel import scan_paths

    findings = filter_findings(scan_paths(paths), select=select, ignore=tuple(ignore))
    if args.format == "json":
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    elif args.format == "sarif":
        print(render_sarif(findings))
    else:
        print(render_text(findings))
        print(f"kernel-check: {len(findings)} finding(s) over {len(paths)} path(s)")
    return exit_code(findings, strict=args.strict)


def main():
    raise SystemExit(kernelcheck_command(kernelcheck_parser().parse_args()))


if __name__ == "__main__":
    main()
