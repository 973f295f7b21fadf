#!/usr/bin/env python3
"""Time design variants of K6 (``block_matmul_softmax``) on one CUDA card.

    python3 scripts/torch_reference_variants.py

Each variant is ``accelerate_tpu_torch/csrc/reference_kernels.cu`` with
one of its compiled-in constants changed (the ring's stages), written
under ``build/variants/<name>/`` and built there by
``kernels.build`` (one ``nvcc`` each, all at once); the wrapper's matching
constants in ``kernels/reference.py`` are set while the variant runs. The
split rule's target (``_TARGET_BLOCKS``) is varied the same way. Every
variant is checked against the plain version (``err_over_tol`` over
``chip_smoke.SOFTMAX_TOL``) and for two calls bit-equal, then timed with
``chip_smoke.time_ms`` (CUDA events, L2 flushed, median of 30) at the
decode-logits shape (8, 2048) @ (2048, 32000) in bf16 and f32, in three
turns that alternate the order; beside them the product ``x @ w`` alone
and ``w.sum(dtype=torch.float32)``, a read of ``w`` by one library call.

Prints one JSON line a variant and case, then the medians beside the
card's name and power limit.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

# name -> (C constants, wrapper constants); "ring4" is the source as it is
VARIANTS = {
    "ring4": ({}, {}),
    "ring3": ({"kStages": 3}, {"_STAGES": 3}),
    "ring6": ({"kStages": 6}, {"_STAGES": 6}),
    "split264": ({}, {"_TARGET_BLOCKS": 264}),
    "split528": ({}, {"_TARGET_BLOCKS": 528}),
}
CASES = (("logits-bf16", "bfloat16"), ("logits-f32", "float32"))  # (8, 2048) @ (2048, 32000)


def variant_source(consts: dict) -> str:
    src = (HERE / "accelerate_tpu_torch" / "csrc" / "reference_kernels.cu").read_text()
    for name, value in consts.items():
        src, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if hits != 1:
            raise SystemExit(f"constant {name} not found once in reference_kernels.cu")
    return src


def main() -> int:
    import torch

    import chip_smoke as cs
    from accelerate_tpu_torch.kernels import build
    from accelerate_tpu_torch.kernels import reference as ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    defaults = {k: getattr(ref, k) for _, wrapper in VARIANTS.values() for k in wrapper}
    dirs, started = {}, {}
    for name, (consts, _) in VARIANTS.items():
        dirs[name] = build.CSRC
        if consts:
            dirs[name] = HERE / "build" / "variants" / name
            dirs[name].mkdir(parents=True, exist_ok=True)
            (dirs[name] / "reference_kernels.cu").write_text(variant_source(consts))
    for name, path in dirs.items():  # every nvcc at once
        build.CSRC = path
        started[name] = build._start("reference_kernels")
    for name, (proc, tmp, lib) in started.items():
        build._finish("reference_kernels", proc, tmp, lib)

    def use(name):
        build.CSRC = dirs[name]
        build.load.cache_clear()
        for key, value in {**defaults, **VARIANTS[name][1]}.items():
            setattr(ref, key, value)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(23)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    inputs = {case: (torch.randn(8, 2048, generator=gen, device="cuda").to(getattr(torch, dt)),
                     (torch.randn(2048, 32000, generator=gen, device="cuda") / 2048**0.5).to(getattr(torch, dt)))
              for case, dt in CASES}
    for name in VARIANTS:
        use(name)
        for case, (x, w) in inputs.items():
            got, again = ref.block_matmul_softmax(x, w), ref.block_matmul_softmax(x, w)
            _, over = cs.flash_err(torch, got, ref.block_matmul_softmax_plain(x, w), cs.SOFTMAX_TOL)
            print(json.dumps({"variant": name, "case": case, "plan": list(ref._softmax_plan(x, w)),
                              "err_over_tol": over, "bit_equal": bool(torch.equal(got, again))}), flush=True)
            if over > 1.0 or not torch.equal(got, again):
                return 1
    times: dict = {}
    for turn in range(3):
        for name in VARIANTS if turn % 2 == 0 else reversed(list(VARIANTS)):
            use(name)
            for case, (x, w) in inputs.items():
                times.setdefault(f"{name}:{case}", []).append(
                    cs.time_ms(torch, lambda: ref.block_matmul_softmax(x, w), flush=flush))
        for case, (x, w) in inputs.items():
            times.setdefault(f"matmul:{case}", []).append(cs.time_ms(torch, lambda: x @ w, flush=flush))
            times.setdefault(f"read_w:{case}", []).append(
                cs.time_ms(torch, lambda: w.sum(dtype=torch.float32), flush=flush))
    use("ring4")
    print(json.dumps({"card": smi, "median_ms": {k: statistics.median(v) for k, v in times.items()},
                      "turns_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
