"""``checkpoints``: list, verify, garbage-collect and describe the
``checkpoint_N`` directories a run writes under its project directory.

Counterpart of :mod:`accelerate_tpu.commands.checkpoints`. It runs on the
manifests (``commit_success.json``), whose schema both packages share, and
touches no tensor and no card, so it is safe to point at a live run's
directory.

Examples::

    python -m accelerate_tpu_torch.commands.cli checkpoints list runs/my_run/checkpoints
    python -m accelerate_tpu_torch.commands.cli checkpoints verify runs/my_run/checkpoints --format json
    python -m accelerate_tpu_torch.commands.cli checkpoints gc runs/my_run/checkpoints --dry-run
    python -m accelerate_tpu_torch.commands.cli checkpoints describe runs/my_run/checkpoints/checkpoint_7
    python -m accelerate_tpu_torch.commands.cli checkpoints verify --selfcheck

``describe`` reads the manifest's topology record: what wrote the
checkpoint and whether a topology restores it. Against the saved topology
(the default) it reports an identical restore that moves 0 bytes. Against
another one it would price the reshard with ``predict_reshard``, which
stands on multi-process training (ROADMAP.md Queue 1 item 8) and raises
until that lands.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def checkpoints_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser(
            "checkpoints", help="List, verify, or garbage-collect checkpoint directories"
        )
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch checkpoints")
    sub = parser.add_subparsers(dest="checkpoints_command", required=True)

    p_list = sub.add_parser("list", help="List committed/in-flight checkpoints with validity")
    p_list.add_argument("base_dir", help="the checkpoints/ directory of a run")
    p_list.add_argument("--format", choices=("text", "json"), default="text")
    p_list.add_argument("--deep", action="store_true", help="full size+crc32 verification per entry")
    p_list.set_defaults(checkpoints_func=list_command)

    p_verify = sub.add_parser("verify", help="Deep integrity check (manifest sizes + crc32)")
    p_verify.add_argument(
        "path", nargs="?", help="one checkpoint_N dir, or a checkpoints/ base dir (verifies all)"
    )
    p_verify.add_argument("--format", choices=("text", "json"), default="text")
    p_verify.add_argument("--shallow", action="store_true", help="manifest presence/parse only")
    p_verify.add_argument(
        "--selfcheck", action="store_true",
        help="prove discovery/verify/gc classify seeded good/uncommitted/corrupt fixtures",
    )
    p_verify.set_defaults(checkpoints_func=verify_command)

    p_gc = sub.add_parser(
        "gc", help="Recover committed .tmp dirs (interrupted renames) and delete partial ones"
    )
    p_gc.add_argument("base_dir", help="the checkpoints/ directory of a run")
    p_gc.add_argument("--dry-run", action="store_true", help="report without touching disk")
    p_gc.add_argument("--format", choices=("text", "json"), default="text")
    p_gc.set_defaults(checkpoints_func=gc_command)

    p_desc = sub.add_parser(
        "describe",
        help="Saved topology, restore compatibility, and predicted reshard bytes (ICI/DCN)",
    )
    p_desc.add_argument(
        "path", help="one checkpoint_N dir, or a checkpoints/ base dir (describes the newest valid)"
    )
    p_desc.add_argument(
        "--mesh", default=None,
        help="target mesh shape to check restorability against, e.g. data=8 or data=2,tensor=2 "
             "(default: the saved topology itself)",
    )
    p_desc.add_argument(
        "--processes", type=int, default=None,
        help="target process count (default: the saved topology's)",
    )
    p_desc.add_argument(
        "--dcn-axes", default=None,
        help="comma-separated target mesh axes that cross DCN (default: the saved topology's)",
    )
    p_desc.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    p_desc.set_defaults(checkpoints_func=describe_command)

    if subparsers is not None:
        parser.set_defaults(func=lambda args: args.checkpoints_func(args))
    return parser


def _describe(mgr, path: Path, deep: bool) -> dict:
    from accelerate_tpu_torch.ft.manifest import read_manifest

    result = mgr.verify(path, deep=deep)
    manifest = result.manifest or read_manifest(path) or {}
    return {
        "name": path.name,
        "valid": result.ok,
        "step": manifest.get("step"),
        "iteration": manifest.get("iteration"),
        "problems": result.problems,
    }


def list_command(args) -> int:
    from accelerate_tpu_torch.ft.manager import CheckpointManager
    from accelerate_tpu_torch.ft.manifest import TMP_SUFFIX, verify_manifest

    if not os.path.isdir(args.base_dir):
        print(f"no such directory: {args.base_dir}")
        return 2
    mgr = CheckpointManager(args.base_dir)
    rows = [_describe(mgr, d, args.deep) for d in mgr.all_checkpoints()]
    for tmp in mgr.tmp_dirs():
        recoverable = not verify_manifest(tmp, deep=True)
        rows.append({
            "name": tmp.name,
            "valid": False,
            "state": "recoverable (committed, rename interrupted)" if recoverable else "uncommitted partial",
        })
    if args.format == "json":
        print(json.dumps({"base_dir": args.base_dir, "checkpoints": rows}, indent=2))
        return 0
    if not rows:
        print(f"no checkpoints under {args.base_dir}")
        return 0
    for row in rows:
        if row["name"].endswith(TMP_SUFFIX):
            print(f"  {row['name']:<24} {row['state']}")
        else:
            status = "valid" if row["valid"] else f"INVALID ({'; '.join(row['problems'][:2])})"
            step = f"step={row['step']}" if row.get("step") is not None else ""
            print(f"  {row['name']:<24} {status:<40} {step}")
    return 0


def verify_command(args) -> int:
    if args.selfcheck:
        return selfcheck_command(args)
    if not args.path:
        print("verify: a path is required (or --selfcheck)")
        return 2
    from accelerate_tpu_torch.ft.manager import CheckpointManager
    from accelerate_tpu_torch.ft.manifest import MANIFEST_NAME

    deep = not args.shallow
    path = Path(args.path)
    if not path.is_dir():
        print(f"no such directory: {path}")
        return 2
    # a single checkpoint carries (or should carry) a manifest; a base dir
    # holds checkpoint_N children
    is_single = (path / MANIFEST_NAME).exists() or not any(
        child.name.startswith("checkpoint_") for child in path.iterdir() if child.is_dir()
    )
    mgr = CheckpointManager(path.parent if is_single else path)
    targets = [path] if is_single else mgr.all_checkpoints()
    results = [_describe(mgr, t, deep) for t in targets]
    failed = [r for r in results if not r["valid"]]
    if args.format == "json":
        print(json.dumps({"results": results, "ok": not failed}, indent=2))
    else:
        for r in results:
            mark = "OK " if r["valid"] else "BAD"
            print(f"[{mark}] {r['name']}" + ("" if r["valid"] else f": {'; '.join(r['problems'][:3])}"))
    return 1 if failed else 0


def gc_command(args) -> int:
    from accelerate_tpu_torch.ft.manager import CheckpointManager

    if not os.path.isdir(args.base_dir):
        print(f"no such directory: {args.base_dir}")
        return 2
    report = CheckpointManager(args.base_dir).gc(dry_run=args.dry_run)
    if args.format == "json":
        print(json.dumps({**report, "dry_run": args.dry_run}, indent=2))
        return 0
    verb = ("would recover", "would remove") if args.dry_run else ("recovered", "removed")
    for name in report["recovered"]:
        print(f"{verb[0]} committed checkpoint from interrupted rename: {name}")
    for name in report["removed"]:
        print(f"{verb[1]} partial checkpoint: {name}")
    if not report["recovered"] and not report["removed"]:
        print("nothing to collect")
    return 0


def _parse_mesh_shape(spec) -> dict:
    """``"data=4,tensor=2"`` -> ``{"data": 4, "tensor": 2}`` — a plain
    shape dict (no device build)."""
    shape: dict = {}
    if spec:
        for part in str(spec).split(","):
            axis, _, size = part.partition("=")
            if not axis.strip() or not size.strip():
                raise SystemExit(f"bad --mesh entry {part!r}; expected axis=size")
            shape[axis.strip()] = int(size)
    return shape


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


#: the mesh axes that split the batch (the data-parallel degree is their product)
BATCH_AXES = ("data", "fsdp")


def describe_checkpoint(path, target_mesh: dict = None, target_processes: int = None,
                        target_dcn=None) -> dict:
    """The data behind ``checkpoints describe``: the saved topology, its
    compatibility with the target one, and the bytes a restore there would
    move. Manifest and arithmetic only. A target that differs from the
    saved topology raises ``NotImplementedError``: pricing its reshard is
    ``predict_reshard``'s, ROADMAP.md Queue 1 item 8."""
    from accelerate_tpu_torch.ft.manifest import read_manifest
    from accelerate_tpu_torch.ft.topology import ELASTIC, compare_topology

    path = Path(path)
    manifest = read_manifest(path)
    saved = (manifest or {}).get("topology")
    live = {
        "process_count": (
            target_processes if target_processes is not None
            else (saved or {}).get("process_count", 1)
        ),
        "mesh_shape": target_mesh if target_mesh is not None else (saved or {}).get("mesh_shape", {}),
        "dcn_axes": list(target_dcn) if target_dcn is not None else (saved or {}).get("dcn_axes", []),
    }
    live["data_parallel_degree"] = 1
    for a in BATCH_AXES:
        live["data_parallel_degree"] *= int(live["mesh_shape"].get(a, 1) or 1)
    delta = compare_topology(saved, live)
    if delta.status == ELASTIC:
        raise NotImplementedError(
            f"checkpoints describe against another topology ({'; '.join(delta.changes)}) needs predict_reshard, "
            "which is not ported to accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 8)"
        )
    # the saved topology itself (or none recorded): nothing reshards
    arrays = (saved or {}).get("arrays", {})
    return {
        "name": path.name,
        "committed": manifest is not None,
        "schema_version": (manifest or {}).get("schema_version"),
        "step": (manifest or {}).get("step"),
        "iteration": (manifest or {}).get("iteration"),
        "saved_topology": saved,
        "target_topology": live,
        "compatibility": delta.status,
        "changes": delta.changes,
        "verdict": delta.describe(),
        "reshard": {
            "ici_bytes": 0,
            "dcn_bytes": 0,
            "total_bytes": 0,
            "arrays_moved": 0,
            "array_count": len(arrays),
            "total_array_bytes": sum(int(a.get("bytes", 0)) for a in arrays.values()),
        },
    }


def describe_sarif_entries(info: dict) -> list[dict]:
    """``describe`` output as shared-reporter entries: an uncommitted
    manifest is an error; a topology mismatch that forces an elastic
    (resharding) restore is a warning carrying the priced traffic; an
    identical topology is a note."""
    uri = info.get("name")
    if not info.get("committed"):
        return [{
            "rule_id": "CKPT001", "name": "uncommitted-manifest", "level": "error",
            "summary": "checkpoint has no readable commit manifest",
            "message": f"{uri}: no readable commit manifest (uncommitted or corrupt)",
            "uri": uri,
        }]
    compat = info.get("compatibility")
    r = info.get("reshard", {})
    level = "note" if compat == "identical" else "warning"
    detail = (
        f"{uri}: {info.get('verdict')} — predicted reshard traffic "
        f"{r.get('total_bytes', 0):,} B (ICI {r.get('ici_bytes', 0):,} B, "
        f"DCN {r.get('dcn_bytes', 0):,} B; {r.get('arrays_moved', 0)}/"
        f"{r.get('array_count', 0)} arrays move)"
    )
    return [{
        "rule_id": "CKPT002", "name": "topology-compatibility", "level": level,
        "summary": "restore-compatibility verdict for the target topology",
        "message": detail, "uri": uri,
    }]


def describe_command(args) -> int:
    from accelerate_tpu_torch.ft.manager import CheckpointManager
    from accelerate_tpu_torch.ft.manifest import MANIFEST_NAME

    path = Path(args.path)
    if not path.is_dir():
        print(f"no such directory: {path}")
        return 2
    # same single-vs-base heuristic as verify: a manifest (or no
    # checkpoint_N children) means the path IS one checkpoint
    is_single = (path / MANIFEST_NAME).exists() or not any(
        child.name.startswith("checkpoint_") for child in path.iterdir() if child.is_dir()
    )
    if not is_single:
        target = CheckpointManager(path).latest(deep=False)
        if target is None:
            print(f"no committed checkpoint under {path}")
            return 2
        path = target
    target_mesh = _parse_mesh_shape(args.mesh) if args.mesh else None
    target_dcn = None
    if args.dcn_axes is not None:
        target_dcn = [a.strip() for a in args.dcn_axes.split(",") if a.strip()]
    info = describe_checkpoint(path, target_mesh, args.processes, target_dcn)
    if args.format == "sarif":
        # the shared SARIF reporter (analysis.report), so this merges into one code-scanning file with the rest
        from accelerate_tpu_torch.analysis import render_sarif_run

        print(render_sarif_run("accelerate-tpu-torch-checkpoints", describe_sarif_entries(info)))
        return 0 if info["committed"] else 1
    if args.format == "json":
        print(json.dumps(info, indent=2))
        return 0 if info["committed"] else 1
    if not info["committed"]:
        print(f"{info['name']}: no readable commit manifest (uncommitted or corrupt)")
        return 1
    step = f"step={info['step']}" if info["step"] is not None else ""
    print(f"{info['name']}  (manifest schema v{info['schema_version']})  {step}")
    saved = info["saved_topology"]
    if saved is None:
        print("saved topology: none recorded (schema v1 checkpoint)")
    else:
        from accelerate_tpu_torch.ft.topology import _shape_str

        nbytes = info["reshard"]["total_array_bytes"]
        print("saved topology:")
        print(f"  processes: {saved.get('process_count')}")
        print(f"  mesh: {_shape_str(saved.get('mesh_shape', {}))} ({saved.get('mesh_devices')} devices)")
        print(f"  dcn axes: {', '.join(saved.get('dcn_axes', [])) or 'none'}")
        print(f"  data-parallel degree: {saved.get('data_parallel_degree')}")
        print(f"  arrays: {info['reshard']['array_count']} ({_fmt_bytes(nbytes)} global)")
    tgt = info["target_topology"]
    print(
        f"target topology: mesh {_shape_str(tgt.get('mesh_shape', {})) if tgt.get('mesh_shape') else 'single-device'}, "
        f"processes {tgt.get('process_count')}"
    )
    print(f"compatibility: {info['compatibility'].upper()} — {info['verdict']}")
    for change in info["changes"]:
        print(f"  - {change}")
    r = info["reshard"]
    print(
        f"predicted reshard traffic: {_fmt_bytes(r['total_bytes'])} "
        f"(ICI {_fmt_bytes(r['ici_bytes'])}, DCN {_fmt_bytes(r['dcn_bytes'])}; "
        f"{r['arrays_moved']}/{r['array_count']} arrays move)"
    )
    return 0


def selfcheck_command(args) -> int:
    """Seed good / corrupt / truncated / uncommitted / recoverable fixture
    checkpoints (plain files) and assert that discovery, verify, gc, prune
    and describe classify every one correctly."""
    import pickle
    import shutil
    import tempfile

    from accelerate_tpu_torch.ft.manager import CheckpointManager
    from accelerate_tpu_torch.ft.manifest import TMP_SUFFIX, build_manifest, write_manifest
    from accelerate_tpu_torch.test_utils.fault_injection import corrupt_file

    failures: list[str] = []

    def check(cond: bool, msg: str):
        if not cond:
            failures.append(msg)

    def seed(base: Path, n: int, committed: bool = True, step: int = 0) -> Path:
        d = base / (f"checkpoint_{n}" if committed else f"checkpoint_{n}{TMP_SUFFIX}")
        (d / "model").mkdir(parents=True)
        (d / "model" / "array_data.bin").write_bytes(os.urandom(256))
        (d / "accelerate_state.json").write_text(json.dumps({"step": step, "save_iteration": n}))
        with open(d / "rng_state_0.pkl", "wb") as f:
            pickle.dump({"seed": 42}, f)
        write_manifest(d, build_manifest(d, step=step, iteration=n))
        return d

    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "checkpoints"
        good = seed(base, 0, step=10)
        corrupt = seed(base, 1, step=20)
        corrupt_file(corrupt / "accelerate_state.json", mode="garbage")
        truncated = seed(base, 2, step=30)
        corrupt_file(truncated / "model" / "array_data.bin", mode="truncate")
        partial = base / f"checkpoint_3{TMP_SUFFIX}"  # crashed mid-write: no manifest
        (partial / "model").mkdir(parents=True)
        (partial / "model" / "array_data.bin").write_bytes(os.urandom(64))
        recoverable = seed(base, 4, committed=False, step=50)  # crashed pre-rename

        mgr = CheckpointManager(base)
        check(len(mgr.all_checkpoints()) == 3, "expected 3 committed-named checkpoints")
        check(len(mgr.tmp_dirs()) == 2, "expected 2 .tmp dirs")
        check([p.name for p in mgr.all_valid(deep=True)] == ["checkpoint_0"],
              "deep all_valid should keep only the good checkpoint")
        latest = mgr.latest(deep=True)
        check(latest is not None and latest.name == "checkpoint_0",
              "latest() must walk back past the corrupt and truncated checkpoints")
        check(any("crc32" in p for p in mgr.verify(corrupt).problems),
              "garbled file must fail crc32")
        check(any("size mismatch" in p for p in mgr.verify(truncated).problems),
              "truncated file must fail the size check")

        dry = mgr.gc(dry_run=True)
        check(recoverable.exists() and partial.exists(), "dry-run gc must not touch disk")
        check("checkpoint_4.tmp" in dry["recovered"], "dry-run gc must flag the recoverable tmp")
        report = mgr.gc()
        check("checkpoint_4.tmp" in report["recovered"], "gc must recover the committed tmp")
        check("checkpoint_3.tmp" in report["removed"], "gc must remove the partial tmp")
        check((base / "checkpoint_4").is_dir() and not partial.exists(), "gc on-disk result wrong")
        latest = mgr.latest(deep=True)
        check(latest is not None and latest.name == "checkpoint_4",
              "after recovery the rescued checkpoint is the newest valid one")

        removed = mgr.prune(total_limit=2, protect=[good])
        names = {p.name for p in removed}
        check("checkpoint_0" not in names, "prune must never touch a protected checkpoint")
        check("checkpoint_1" in names, "prune should drop the oldest unprotected checkpoint")
        check(good.exists(), "protected checkpoint deleted from disk")

        # ---- topology / describe: a v2 manifest with a topology record ----
        # the saved topology itself must classify identical with zero bytes moved; another one (a mesh of 8)
        # is refused until predict_reshard is ported
        topo_ckpt = base / "checkpoint_9"
        (topo_ckpt / "model").mkdir(parents=True)
        (topo_ckpt / "model" / "array_data.bin").write_bytes(os.urandom(128))
        (topo_ckpt / "accelerate_state.json").write_text(json.dumps({"step": 90, "seed": 7}))
        topology = {
            "schema_version": 1,
            "process_count": 1,
            "mesh_shape": {"data": 1, "tensor": 1},
            "mesh_devices": 1,
            "dcn_axes": [],
            "data_parallel_degree": 1,
            "seed": 7,
            "arrays": {
                "model/w": {"shape": [8, 4], "dtype": "float32", "bytes": 128},
                "model/b": {"shape": [4], "dtype": "float32", "bytes": 16},
            },
        }
        write_manifest(topo_ckpt, build_manifest(topo_ckpt, step=90, iteration=9, topology=topology))
        same = describe_checkpoint(topo_ckpt)
        check(same["compatibility"] == "identical", "same-topology describe must be identical")
        check(same["reshard"]["total_bytes"] == 0, "identical topology must predict zero reshard bytes")
        check(same["reshard"]["array_count"] == 2 and same["reshard"]["total_array_bytes"] == 144,
              "describe must count the recorded arrays and their bytes")
        try:
            describe_checkpoint(topo_ckpt, target_mesh={"data": 8})
            failures.append("describe against another mesh must raise (predict_reshard is item 8's)")
        except NotImplementedError as e:
            check("item 8" in str(e), "the describe refusal must name its Queue 1 item")
        legacy = describe_checkpoint(good)  # a manifest without a topology record
        check(legacy["compatibility"] == "unknown", "no-topology checkpoint must describe as unknown")

        # the CLI surface over the same fixture
        import contextlib
        import io
        import types

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = describe_command(types.SimpleNamespace(
                path=str(topo_ckpt), mesh=None, processes=None, dcn_axes=None, format="json"))
        check(rc == 0, "describe CLI on a committed checkpoint must exit 0")
        try:
            cli_info = json.loads(buf.getvalue())
            check(cli_info["compatibility"] == "identical", "describe CLI JSON must carry the identical verdict")
        except json.JSONDecodeError:
            failures.append("describe CLI --format json must print valid JSON")

        try:
            shutil.rmtree(base / "checkpoint_4" / "model")
            check(not mgr.verify(base / "checkpoint_4").ok, "losing a pytree dir must fail verify")
        except OSError as e:
            failures.append(f"fixture teardown failed: {e}")

    for msg in failures:
        print(f"[checkpoints selfcheck] FAILED: {msg}")
    if not failures:
        print(
            "[checkpoints selfcheck] OK: manifest commit/verify (crc32, sizes), "
            "discovery skips corrupt+uncommitted, gc recovers interrupted renames, "
            "prune honors protection, describe classifies identical/unknown "
            "topologies (0 bytes moved) and refuses another one (item 8)"
        )
    return 1 if failures else 0


def main():
    args = checkpoints_parser().parse_args()
    raise SystemExit(args.checkpoints_func(args))


if __name__ == "__main__":
    main()
