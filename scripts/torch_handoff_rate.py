#!/usr/bin/env python3
"""The serving fleet's KV handoff transport on the card: a payload's bytes
over the time of its device-to-host copy plus its host-to-device copy.

    python3 scripts/torch_handoff_rate.py

Replicas of one fleet share a card, so a handoff (``prefill_detached`` ->
``submit_prefilled``) moves its rows out with ``KVCache.host_rows`` and
back with ``KVCache.from_host_rows``. This times those two calls on
TinyLlama-1.1B's rows (22 layers, 4 KV heads, head dim 64, bf16) at the
fleet's handoff lengths, the median of 20 round trips each, the card idle
before every copy. One JSON line per length, then the card's name and power
limit; the 1,280-token rate (the fleet's longest prompt, a 1,024-token
preamble and a 256-token suffix) is the ``h100`` row of
``analysis/costmodel.py``'s ``HANDOFF_BW_TABLE``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from accelerate_tpu_torch import LlamaConfig  # noqa: E402
from accelerate_tpu_torch.ops.kv_cache import KVCache  # noqa: E402

TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_hidden_layers=22,
                 num_attention_heads=32, num_key_value_heads=4, max_position_embeddings=2048)
LENGTHS = (64, 256, 1024, 1280, 2048)
REPS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_handoff_rate: no CUDA device", file=sys.stderr)
        return 1
    cfg = LlamaConfig(**TINYLLAMA)
    cache = KVCache.empty(cfg, 1, cfg.max_position_embeddings, torch.bfloat16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache.key.normal_(generator=gen)
    cache.value.normal_(generator=gen)
    for n in LENGTHS:
        out_s, in_s = [], []
        for _ in range(REPS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = cache.host_rows(n)
            t1 = time.perf_counter()
            back = KVCache.from_host_rows(rows, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out_s.append(t1 - t0)
            in_s.append(t2 - t1)
        assert torch.equal(back.key, cache.key[:, :, :n]) and torch.equal(back.value, cache.value[:, :, :n])
        d2h, h2d = statistics.median(out_s[2:]), statistics.median(in_s[2:])
        nbytes = sum(x.numel() * x.element_size() for x in rows.values())
        print(json.dumps({"tokens": n, "bytes": nbytes, "d2h_ms": d2h * 1e3, "h2d_ms": h2d * 1e3,
                          "round_trip_bytes_per_s": nbytes / (d2h + h2d)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
