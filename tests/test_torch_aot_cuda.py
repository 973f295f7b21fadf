"""The card's twin of test_torch_aot.py: a kernel library's round trip
through the executable store with the real ``nvcc``. A cold process with an
empty kernel build directory runs a program that launches K4 (the paged
decode kernel) through a ProgramCache over a fresh store and builds its
library; a warm process with another empty build directory runs the same
program from the store with no ``nvcc`` build and gives bit-equal output.
It needs a CUDA card and skips without one; this file imports no JAX, so it
runs on the machine with the card: ``python -m pytest tests/test_torch_aot_cuda.py -m cuda``."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import hashlib, json, sys
sys.path.insert(0, {repo!r})
import torch
from accelerate_tpu_torch.aot import ExecutableStore, ProgramCache
from accelerate_tpu_torch.kernels import build
from accelerate_tpu_torch.ops import paged_attention as pa

gen = torch.Generator(device="cuda").manual_seed(0)
b, heads, kv_heads, dim, bs, mb = 4, 8, 2, 64, 16, 8
nb = b * mb + 1
q = torch.randn(b, heads, dim, generator=gen, device="cuda").to(torch.bfloat16)
kp, vp = (torch.randn(nb, bs, kv_heads, dim, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
table = torch.arange(1, nb, device="cuda", dtype=torch.int32).reshape(b, mb)
cur = torch.tensor([0, 17, 100, mb * bs - 1], device="cuda", dtype=torch.int32)
pc = ProgramCache(store=ExecutableStore({store!r}))
step = pc.wrap_jit(lambda *a: pa.paged_decode_attention(*a), name="k4")
out = step(q, kp, vp, table, cur)
torch.cuda.synchronize()
print(json.dumps({{"misses": pc.misses, "deserialized": pc.deserialized, "nvcc": build.nvcc_builds,
                  "out": hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()}}))
"""


@pytest.mark.cuda
def test_k4_library_round_trips_through_the_store(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is a CUDA kernel with no interpret mode (chip_smoke.py's aot group)")

    def run(build_dir):
        env = dict(os.environ, ACCELERATE_TPU_TORCH_BUILD_DIR=str(tmp_path / build_dir))
        out = subprocess.run([sys.executable, "-c", _CHILD.format(repo=REPO, store=str(tmp_path / "store"))],
                             capture_output=True, text=True, env=env, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold, warm = run("cold"), run("warm")
    assert cold["misses"] == 1 and cold["nvcc"] > 0
    assert (warm["misses"], warm["deserialized"], warm["nvcc"]) == (0, 1, 0)
    assert warm["out"] == cold["out"]
