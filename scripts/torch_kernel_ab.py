#!/usr/bin/env python3
"""Time the port's K1-K3 (flash forward and backward), K4 (paged decode
attention), K5 (int4 dequantize-matmul), K6 and K7 (the reference kernels)
and K8 (fixture tile kernels) in two checkouts on one CUDA card, in turns:
other, this, this, other.

    python3 scripts/torch_kernel_ab.py --other DIR [--only k6,k7]

``--only`` names the groups to time (``k4``, ``k5``, ``flash`` for K1-K3,
``k6``, ``k7``, ``k8``; all by default).

DIR holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``, or a copy with one change to a
kernel source). Each turn is a subprocess that imports
``accelerate_tpu_torch`` from its own tree (and builds its kernels there),
and times it with this checkout's ``chip_smoke.time_ms`` (CUDA events
after warm-up, L2 flushed before each call, the median of 30 calls):

* K1 through ``flash_fwd_kernel``, K2 through ``flash_dq_kernel`` and K3
  through ``flash_dkv_kernel`` (fed that tree's K1 lse and delta) at the
  training shape (B 8, S 2048, H 32/4, causal) in bf16 D 64, fp16 D 64 and
  bf16 D 128, and in bf16 D 64 at the same shape's work in four times the
  blocks (B 32, S 1024, causal) and non-causal at B 2, S 8192. Each case
  also reports ``err_over_tol`` of K2's dq and K3's dk and dv (and, at the
  training shape, of K1's output) against that tree's own plain versions
  over ``chip_smoke.FLASH_TOL`` (``flash_err``: at most 1 where it is within
  tolerance); the inputs are ``chip_smoke.flash_inputs``' (seed 7), so the
  bf16 case's are ``chip_smoke.py``'s bf16 ``flash_kernel`` case's;
* K4 through ``paged_decode_attention`` at the serving slice's shape (B 8,
  H 32/4, 128 blocks of 16 rows, ``chip_smoke.paged_inputs``' ragged
  frontiers, bf16) at head dims 64 and 128, and at a serving tick's rows
  (``tick``: the same table, rows of 100 to 464 live keys, D 64), with its
  ``max_abs_err`` against that tree's plain version;
* K5 through ``int4_matmul`` at TinyLlama's four projection shapes (int4,
  groups of 128, ``chip_smoke.int4_weight``) at M 1, 8 and 64 in bf16, with
  its ``err_over_tol`` against that tree's plain version over
  ``chip_smoke.INT4_TOL``;
* K6 through ``block_matmul_softmax`` at the decode-logits shape (8, 2048)
  @ (2048, 32000) in bf16 and f32, the same at B 64, and the ragged
  (16, 300) @ (300, 1500) bf16 (rows of 3,000 bytes: the ring's 8-byte
  copies), each with ``max_abs_err`` and ``err_over_tol`` against that
  tree's plain version over ``chip_smoke.SOFTMAX_TOL`` and whether two
  calls are bit-equal; beside the logits cases in bf16, the product
  ``x @ w`` alone (cuBLAS): the floor a fused design competes with;
* K7 through ``block_accumulate`` at [4096, 4096] f32 and bf16, with
  ``max_abs_err`` against ``acc.add_(delta)`` and that call's own time;
* the three K8 bodies at the fixture shapes, (16, 128) f32 (the copy and
  the scale as the ``unregistered_call`` and ``drifting_call`` fixtures,
  the add aliased on a map free of hazards), as ``chip_smoke.py`` does.

Each turn first builds its tree's kernels: K4's library alone
(``k4_build_s``), then the rest at once (``build_s``). A tree's first turn
builds them from nothing (its own ``build/cuda``), its second finds them
built, so the last line gives build seconds from each tree's first turn.

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
K1_CASES = (  # name, dtype, D, B, S, causal, K1 checked against the plain version (K2, K3: every case)
    ("bf16", "bfloat16", 64, 8, 2048, True, True),
    ("fp16", "float16", 64, 8, 2048, True, True),
    ("bf16-d128", "bfloat16", 128, 8, 2048, True, True),
    ("bf16-b32-s1024", "bfloat16", 64, 32, 1024, True, False),
    ("bf16-s8192-noncausal", "bfloat16", 64, 2, 8192, False, False),
)
K4_HEAD_DIMS = (64, 128)  # at B 8, H 32/4, 128 blocks of 16, bf16
K4_TICK_KEYS = (100, 464)  # live keys a row at the serving tick's shape (D 64)
K5_BATCHES = (1, 8, 64)  # at each of chip_smoke.INT4_SHAPES, bf16, groups of 128
K6_CASES = (  # name, B, D, N, dtype
    ("logits-bf16", 8, 2048, 32000, "bfloat16"),
    ("logits-f32", 8, 2048, 32000, "float32"),
    ("logits-b64-bf16", 64, 2048, 32000, "bfloat16"),
    ("logits-b64-f32", 64, 2048, 32000, "float32"),
    ("ragged-bf16", 16, 300, 1500, "bfloat16"),
)
K7_CASES = (("4096-f32", "float32"), ("4096-bf16", "bfloat16"))  # [4096, 4096]
GROUPS = ("k4", "k5", "flash", "k6", "k7", "k8")  # in the order they run
BUILD_KEYS = ("k4_build_s", "build_s")


def chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its timing and error
    measures), whichever tree the turn imports the port from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(only) -> dict:
    import time

    import torch

    from accelerate_tpu_torch.kernels import build

    cs = chip_smoke()
    out = {}
    t0 = time.perf_counter()
    build.build_all(["paged_attention"])
    out["k4_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.build_all()
    out["build_s"] = time.perf_counter() - t0
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for group in GROUPS:  # each adds its keys to out
        if group in only:
            TIMERS[group](cs, torch, out, flush)
    return out


def time_k4(cs, torch, out, flush):
    import numpy as np

    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in K4_HEAD_DIMS:
        q, kp, vp, table, cur = cs.paged_inputs(torch, gen, 8, 32, 4, d, 16, 128, torch.bfloat16, rng)
        got = pa.paged_decode_attention(q, kp, vp, table, cur)
        want = pa.paged_decode_attention_plain(q, kp, vp, table, cur)
        out[f"k4_bf16-d{d}_max_abs_err"] = (got.float() - want.float()).abs().max().item()
        out[f"k4_bf16-d{d}_ms"] = cs.time_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, table, cur),
                                             flush=flush)
    q, kp, vp, table, _ = cs.paged_inputs(torch, gen, 8, 32, 4, 64, 16, 128, torch.bfloat16, rng)
    cur = torch.as_tensor(rng.integers(K4_TICK_KEYS[0] - 1, K4_TICK_KEYS[1], size=8).astype(np.int32), device="cuda")
    got, want = pa.paged_decode_attention(q, kp, vp, table, cur), pa.paged_decode_attention_plain(q, kp, vp, table, cur)
    out["k4_bf16-tick_max_abs_err"] = (got.float() - want.float()).abs().max().item()
    out["k4_bf16-tick_ms"] = cs.time_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, table, cur), flush=flush)


def time_k5(cs, torch, out, flush):
    from accelerate_tpu_torch.ops import qmatmul as qm

    gen = torch.Generator(device="cuda").manual_seed(17)
    for k, n in cs.INT4_SHAPES:
        packed, scale, _ = cs.int4_weight(torch, gen, k, n, 128)
        for m in K5_BATCHES:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            out[f"k5_{k}x{n}_m{m}_err_over_tol"] = cs.int4_compare(torch, qm, x, packed, scale, 128)[1]
            out[f"k5_{k}x{n}_m{m}_ms"] = cs.time_ms(
                torch, lambda: qm.int4_matmul(x, packed, scale, group_size=128), flush=flush)
        del packed, scale


def time_flash(cs, torch, out, flush):
    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, dtype_name, d, b, s, causal, check in K1_CASES:
        dtype, scale, tol = getattr(torch, dtype_name), d**-0.5, cs.FLASH_TOL[dtype_name]
        q, k, v, do = cs.flash_inputs(torch, gen, b, s, s, 32, 4, d, dtype)
        o, lse = fa.flash_fwd_kernel(q, k, v, causal, scale, None)
        if check:
            want, _ = fa.flash_attention_plain(q, k, v, causal, scale)
            out[f"k1_{name}_err_over_tol"] = cs.flash_err(torch, o, want, tol["out"])[1]
            del want
        out[f"k1_{name}_ms"] = cs.time_ms(torch, lambda: fa.flash_fwd_kernel(q, k, v, causal, scale, None),
                                          flush=flush)
        delta = fa._delta(o, do)
        floor = cs.GRAD_FLOOR * do.float().pow(2).mean().sqrt().item()
        got = fa.flash_dq_kernel(q, k, v, do, lse, delta, causal, scale, None)
        want = fa.flash_attention_plain_dq(q, k, v, do, lse, delta, causal, scale)
        out[f"k2_{name}_dq_err_over_tol"] = cs.flash_err(torch, got, want, tol["dq"], floor)[1]
        got = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal, scale, None)
        want = fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, causal, scale)
        out[f"k3_{name}_dk_err_over_tol"] = cs.flash_err(torch, got[0], want[0], tol["dk"], floor)[1]
        out[f"k3_{name}_dv_err_over_tol"] = cs.flash_err(torch, got[1], want[1], tol["dv"], floor)[1]
        del got, want
        out[f"k2_{name}_ms"] = cs.time_ms(
            torch, lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, causal, scale, None), flush=flush)
        out[f"k3_{name}_ms"] = cs.time_ms(
            torch, lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal, scale, None), flush=flush)
        out[f"k2_k3_{name}_ms"] = out[f"k2_{name}_ms"] + out[f"k3_{name}_ms"]
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()


def time_k6(cs, torch, out, flush):
    from accelerate_tpu_torch.kernels import reference as ref

    gen = torch.Generator(device="cuda").manual_seed(23)
    for name, b, d, n, dtype_name in K6_CASES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(b, d, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(d, n, generator=gen, device="cuda") / d**0.5).to(dtype)
        got = ref.block_matmul_softmax(x, w)
        again = ref.block_matmul_softmax(x, w)
        want = ref.block_matmul_softmax_plain(x, w)
        out[f"k6_{name}_max_abs_err"], out[f"k6_{name}_err_over_tol"] = cs.flash_err(torch, got, want, cs.SOFTMAX_TOL)
        out[f"k6_{name}_bit_equal"] = float(torch.equal(got, again))
        del got, again, want
        out[f"k6_{name}_ms"] = cs.time_ms(torch, lambda: ref.block_matmul_softmax(x, w), flush=flush)
        if dtype == torch.bfloat16 and name.startswith("logits"):
            out[f"k6_{name}_matmul_ms"] = cs.time_ms(torch, lambda: x @ w, flush=flush)
        del x, w
        torch.cuda.empty_cache()


def time_k7(cs, torch, out, flush):
    from accelerate_tpu_torch.kernels import reference as ref

    gen = torch.Generator(device="cuda").manual_seed(29)
    for name, dtype_name in K7_CASES:
        dtype = getattr(torch, dtype_name)
        acc = torch.randn(4096, 4096, generator=gen, device="cuda").to(dtype)
        delta = torch.randn(4096, 4096, generator=gen, device="cuda").to(dtype)
        want = ref.block_accumulate_plain(acc.clone(), delta)
        ref.block_accumulate(acc, delta)
        torch.cuda.synchronize()
        out[f"k7_{name}_max_abs_err"] = (acc.float() - want.float()).abs().max().item()
        out[f"k7_{name}_ms"] = cs.time_ms(torch, lambda: ref.block_accumulate(acc, delta), flush=flush)
        out[f"k7_{name}_add_ms"] = cs.time_ms(torch, lambda: acc.add_(delta), flush=flush)
        del acc, delta, want


def time_k8(cs, torch, out, flush):
    from accelerate_tpu_torch.analysis.selfcheck import _kernel_fixtures
    from accelerate_tpu_torch.kernels import fixtures

    gen = torch.Generator(device="cuda").manual_seed(7)
    fixture_set, _ = _kernel_fixtures()
    x, a, d_ = (torch.randn(16, 128, generator=gen, device="cuda") for _ in range(3))

    def clean_add():
        return fixtures.tile_add(a, d_, tile=(8, 128), grid=(2,), a_map=lambda i: (i, 0), d_map=lambda i: (i, 0),
                                 out_map=lambda i: (i, 0), alias=True)

    out["tile_copy_ms"] = cs.time_ms(torch, lambda: fixture_set["TPU1005"][0](x), flush=flush)
    out["tile_add_ms"] = cs.time_ms(torch, clean_add, flush=flush)
    out["tile_scale_ms"] = cs.time_ms(torch, lambda: fixture_set["TPU1006"][0](x), flush=flush)


TIMERS = {"k4": time_k4, "k5": time_k5, "flash": time_flash, "k6": time_k6, "k7": time_k7, "k8": time_k8}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="another checkout of the repository")
    parser.add_argument("--only", default=",".join(GROUPS), help="groups to time, comma-separated: " + ", ".join(GROUPS))
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    only = set(args.only.split(","))
    if only - set(GROUPS):
        parser.error(f"unknown groups {sorted(only - set(GROUPS))}; choose from {', '.join(GROUPS)}")
    if args.worker:
        print(json.dumps(worker(only)), flush=True)
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
        proc = subprocess.run([sys.executable, str(HERE / "scripts" / "torch_kernel_ab.py"), "--worker", "--only",
                               args.only], cwd=tree,
                              env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        print(json.dumps({"turn": which, "tree": str(tree), **row}), flush=True)
    medians = {which: {key: rows[0][key] if key in BUILD_KEYS else statistics.median(r[key] for r in rows)
                       for key in rows[0]} for which, rows in runs.items()}
    print(json.dumps({"card": smi, "median_of_two_turns": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
