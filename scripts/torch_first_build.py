#!/usr/bin/env python3
"""What a fresh process's first model build costs on the card, with and
without ``nn.Embedding``'s own weight init.

    python3 scripts/torch_first_build.py

``models/llama.py`` hands ``nn.Embedding`` its storage, so the module's
own init (a ``normal_`` on a ``meta`` tensor, which imports
``torch._dynamo`` and through it ``sympy`` and ``torch.distributed.tensor``)
never runs: ``create_llama_model`` draws the table itself. This script
builds TinyLlama-1.1B's shape (22 layers, bf16, seeded weights drawn on the
card) in fresh child processes, alternately as the package builds it
(``package``) and with ``nn.Embedding`` initialising itself again
(``embedding_init``), and times on the host clock ``import torch``, the
CUDA context, the port's imports, the first build and a second build in
the same process. One JSON line a child, then the card's name and power
limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.empty(1, device="cuda"); torch.cuda.synchronize()
t2 = time.perf_counter()
from accelerate_tpu_torch import LlamaConfig, create_llama_model
import accelerate_tpu_torch.models.llama as llama
if sys.argv[1] == "embedding_init":
    class Embedding(torch.nn.Embedding):
        def __init__(self, num, dim, _weight=None):
            super().__init__(num, dim)  # the module draws its own weight, as before the package skipped it
    llama.nn = type(sys)("nn")
    llama.nn.__dict__.update({k: getattr(torch.nn, k) for k in dir(torch.nn) if not k.startswith("__")})
    llama.nn.Embedding = Embedding
t3 = time.perf_counter()
cfg = LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_hidden_layers=22,
                  num_attention_heads=32, num_key_value_heads=4, max_position_embeddings=2048)
create_llama_model(cfg, seed=0, dtype=torch.bfloat16); torch.cuda.synchronize()
t4 = time.perf_counter()
create_llama_model(cfg, seed=0, dtype=torch.bfloat16); torch.cuda.synchronize()
t5 = time.perf_counter()
print(json.dumps({"mode": sys.argv[1], "import_torch_s": t1 - t0, "cuda_context_s": t2 - t1,
                  "import_port_s": t3 - t2, "first_build_s": t4 - t3, "second_build_s": t5 - t4,
                  "dynamo_imported": "torch._dynamo" in sys.modules}))
"""


def main() -> int:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for mode in ("package", "embedding_init", "package", "embedding_init"):
        out = subprocess.run([sys.executable, "-c", CHILD, mode], cwd=REPO, capture_output=True, text=True,
                             check=True, env=env)
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
