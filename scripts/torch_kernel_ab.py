#!/usr/bin/env python3
"""Time the port's K1 (flash forward) and K8 (fixture tile kernels) in two
checkouts on one CUDA card, in turns: other, this, this, other.

    python3 scripts/torch_kernel_ab.py --other DIR

DIR holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``, or a copy with one change to a
kernel source). Each turn is a subprocess that imports
``accelerate_tpu_torch`` from its own tree (and builds its kernels there),
and times it with this checkout's ``chip_smoke.time_ms`` (CUDA events
after warm-up, L2 flushed before each call, the median of 30 calls):

* K1 through ``flash_fwd_kernel`` at the training shape (B 8, S 2048, H
  32/4, causal) in bf16 D 64, fp16 D 64 and bf16 D 128, and in bf16 D 64
  at the same shape's work in four times the blocks (B 32, S 1024, causal)
  and non-causal at B 2, S 8192. At the training shape each case also
  reports ``err_over_tol``, its output's largest error against
  ``flash_attention_plain`` over ``chip_smoke.FLASH_TOL`` (``flash_err``:
  at most 1 where it is within tolerance); the inputs of the bf16 case are
  ``chip_smoke.py``'s bf16 ``flash_kernel`` case's (seed 7);
* the three K8 bodies at the fixture shapes, (16, 128) f32 (the copy and
  the scale as the ``unregistered_call`` and ``drifting_call`` fixtures,
  the add aliased on a map free of hazards), as ``chip_smoke.py`` does.

Prints one JSON line a turn and a last line with each tree's medians over
its two turns, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
K1_CASES = (  # name, dtype, D, B, S, causal, checked against the plain version
    ("bf16", "bfloat16", 64, 8, 2048, True, True),
    ("fp16", "float16", 64, 8, 2048, True, True),
    ("bf16-d128", "bfloat16", 128, 8, 2048, True, True),
    ("bf16-b32-s1024", "bfloat16", 64, 32, 1024, True, False),
    ("bf16-s8192-noncausal", "bfloat16", 64, 2, 8192, False, False),
)


def chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its timing and error
    measures), whichever tree the turn imports the port from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker() -> dict:
    import torch

    from accelerate_tpu_torch.analysis.selfcheck import _kernel_fixtures
    from accelerate_tpu_torch.kernels import fixtures
    from accelerate_tpu_torch.ops import flash_attention as fa

    cs = chip_smoke()
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name, dtype_name, d, b, s, causal, check in K1_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, s, 32, d), (b, s, 4, d), (b, s, 4, d)))
        if check:
            got, _ = fa.flash_fwd_kernel(q, k, v, causal, d**-0.5, None)
            want, _ = fa.flash_attention_plain(q, k, v, causal, d**-0.5)
            out[f"k1_{name}_err_over_tol"] = cs.flash_err(torch, got, want, cs.FLASH_TOL[dtype_name]["out"])[1]
            del got, want
        out[f"k1_{name}_ms"] = cs.time_ms(torch, lambda: fa.flash_fwd_kernel(q, k, v, causal, d**-0.5, None),
                                          flush=flush)
        del q, k, v
        torch.cuda.empty_cache()
    fixture_set, _ = _kernel_fixtures()
    x, a, d_ = (torch.randn(16, 128, generator=gen, device="cuda") for _ in range(3))

    def clean_add():
        return fixtures.tile_add(a, d_, tile=(8, 128), grid=(2,), a_map=lambda i: (i, 0), d_map=lambda i: (i, 0),
                                 out_map=lambda i: (i, 0), alias=True)

    out["tile_copy_ms"] = cs.time_ms(torch, lambda: fixture_set["TPU1005"][0](x), flush=flush)
    out["tile_add_ms"] = cs.time_ms(torch, clean_add, flush=flush)
    out["tile_scale_ms"] = cs.time_ms(torch, lambda: fixture_set["TPU1006"][0](x), flush=flush)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="another checkout of the repository")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return 0
    if not args.other:
        parser.error("--other DIR is required")
    trees = {"other": Path(args.other).resolve(), "this": HERE}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runs: dict = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        tree = trees[which]
        env = {**os.environ, "PYTHONPATH": str(tree)}
        proc = subprocess.run([sys.executable, str(HERE / "scripts" / "torch_kernel_ab.py"), "--worker"], cwd=tree,
                              env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        print(json.dumps({"turn": which, "tree": str(tree), **row}), flush=True)
    medians = {which: {key: statistics.median(r[key] for r in rows) for key in rows[0]} for which, rows in runs.items()}
    print(json.dumps({"card": smi, "median_of_two_turns": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
