#!/usr/bin/env python3
"""Where an engine worker's boot goes on the card: what a fresh Python
process pays before it can serve TinyLlama-1.1B.

    python3 scripts/torch_proc_boot.py

A worker of the multi-process fleet (``serving_proc``) is a fresh
interpreter: it imports torch and the port, makes its CUDA context,
builds its model (seeded random weights drawn on the card) and warms its
engine before it says hello. This script runs the same steps in a child
process, one at a time, each on the host clock: ``import torch``, the
CUDA context, the port's imports, the first model build (profiled: the
top entries by cumulative time name what the build pulls in), and a
second model build in the same process. One JSON line, then the card's
name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import cProfile, io, json, pstats, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.empty(1, device="cuda"); torch.cuda.synchronize()
t2 = time.perf_counter()
from accelerate_tpu_torch.serving import ServingEngine  # noqa: F401
import accelerate_tpu_torch.serving_proc  # noqa: F401
import chip_smoke
t3 = time.perf_counter()
prof = cProfile.Profile()
prof.enable()
chip_smoke.proc_tinyllama(device="cuda")
torch.cuda.synchronize()
prof.disable()
t4 = time.perf_counter()
chip_smoke.proc_tinyllama(device="cuda")
torch.cuda.synchronize()
t5 = time.perf_counter()
stats = pstats.Stats(prof, stream=io.StringIO())
modules = sorted(((st[3], fn[0]) for fn, st in stats.stats.items() if fn[2] == "<module>"), reverse=True)
compile_s = sum(st[2] for fn, st in stats.stats.items() if fn[2] == "<built-in method builtins.compile>")
print(json.dumps({"import_torch_s": t1 - t0, "cuda_context_s": t2 - t1, "import_port_s": t3 - t2,
                  "first_model_s": t4 - t3, "second_model_s": t5 - t4, "first_model_compile_s": compile_s,
                  "first_model_top_modules": [[round(c, 3), f] for c, f in modules[:6]]}))
"""


def main() -> int:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    print(out.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
