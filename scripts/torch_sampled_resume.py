#!/usr/bin/env python3
"""Sampled serving resumed by recompute on the card: where a resumed
stream parts from an uninterrupted one, and how close to a tie of the
sampler it parts.

    python3 scripts/torch_sampled_resume.py [--device cpu] [--f32]

A worker that dies mid-decode loses its rows; a survivor that is serving
requests of its own recomputes the dead worker's rows from their snapshots
(prompt, tokens so far, the stream's generator state) and samples on. In
bf16 the recomputed rows are not the decoded ones bit for bit, so a
resumed stream may part from an uninterrupted one where the sampler's
choice was close. This plays ``chip_smoke.py``'s sampled failover in one
process: the paged engine (FLEET_ENGINE, temperature 0.8, top-k 50, seed
3; TinyLlama-1.1B's shape at 22 layers, seeded random weights, bf16), the
first 24 fleet prompts (32 new tokens) split between a survivor (even)
and a dying engine (odd) as the supervisor splits a burst, each engine's
ids starting after 3 warm requests. Both tick 1, 2 or 3 times; the dying
engine's snapshots go through the transport's codec into the survivor,
which runs to the end. Each request is held to its uninterrupted run (the
same split, no fault). ``torch.multinomial`` draws one token as
``argmax(p / q)``, ``q ~ Exp(1)`` drawn from the request's generator, one
draw a token: at each parting the line gives the race's top two at that
token on the uninterrupted run's teacher-forced row, T times their gap,
which of the first draws would give the resumed token, and the largest
logprob difference of the tokens before the parting. One JSON line a
snapshot point, then the card's name and power limit (with ``--device
cpu``: a 2-layer model of width 64, no card, no race). ``--f32`` serves the
model in f32, where recomputed rows differ from decoded ones by rounding
alone: a resumed stream that parts there parts at a tie.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model  # noqa: E402
from accelerate_tpu_torch.serving_transport import decode_snapshots, encode_snapshots  # noqa: E402

REQUESTS, NEW, WARM = 24, 32, len(cs.PROC_WARM)


def forced_row(model, ids, chunk=1024):
    """The f32 logits row after ``ids`` (a dense cache, fed in chunks): the
    uninterrupted run's teacher-forced view of the token it parts at."""
    from accelerate_tpu_torch.ops.kv_cache import KVCache

    ids = torch.as_tensor(np.asarray(ids), device="cuda")[None].long()
    cache = KVCache.empty(model.config, 1, cs.FLEET_ENGINE["max_len"], model.dtype, "cuda")
    with torch.no_grad():
        for s in range(0, ids.shape[1], chunk):
            part = ids[:, s : s + chunk]
            positions = torch.arange(s, s + part.shape[1], device="cuda")[None]
            logits, cache = model(part, positions=positions, decode=True, cache=cache)
    return logits[0, -1].float()


def main() -> int:
    dev = "cpu" if "--device" in sys.argv and sys.argv[sys.argv.index("--device") + 1] == "cpu" else "cuda"
    cfg = cs.TINYLLAMA if dev == "cuda" else dict(cs.TINYLLAMA, hidden_size=64, intermediate_size=128,
                                                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    dtype = torch.float32 if "--f32" in sys.argv else torch.bfloat16
    model = create_llama_model(LlamaConfig(**cfg), seed=0, dtype=dtype, device=dev)
    prompts = cs.fleet_prompts(model.config.vocab_size)[:REQUESTS]
    kw = dict(cs.FLEET_ENGINE, **cs.PROC_SAMPLED, seed=3, device=dev)
    t, k = cs.PROC_SAMPLED["temperature"], cs.PROC_SAMPLED["top_k"]

    def engine(w):
        eng = ServingEngine(model, **kw)
        eng._uid = WARM
        return eng, {f: eng.submit(prompts[f], NEW) for f in range(w, REQUESTS, 2)}

    ref = {}
    for w in (0, 1):
        eng, uids = engine(w)
        eng.run()
        ref.update({f: (np.asarray(eng.poll(u)), np.asarray(eng.logprobs(u)), u) for f, u in uids.items()})
    for ticks in (1, 2, 3):
        survivor, mine = engine(0)
        dying, theirs = engine(1)
        for _ in range(ticks):
            survivor.step()
            dying.step()
        snaps = dying.export_inflight(include_kv=False)
        at = {s["uid"]: len(s["out_tokens"]) for s in snaps}
        _, blob = encode_snapshots(snaps)
        moved = {s["uid"]: survivor.import_inflight(s) for s in decode_snapshots(blob, survivor)}
        survivor.run()
        got = {f: (np.asarray(survivor.poll(u)), np.asarray(survivor.logprobs(u))) for f, u in mine.items()}
        for f, u in theirs.items():
            done = u in dying.done
            got[f] = ((np.asarray(dying.done[u]), np.asarray(dying.logprobs(u))) if done else
                      (np.asarray(survivor.poll(moved[u])), np.asarray(survivor.logprobs(moved[u]))))
        partings = []
        for f in range(REQUESTS):
            n0 = len(prompts[f])
            g, g_lp = got[f][0][n0:], got[f][1]
            w, w_lp, uid = ref[f][0][n0:], ref[f][1], ref[f][2]
            diff = np.nonzero(g != w)[0]
            if not len(diff):
                continue
            n = int(diff[0])
            part = {"request": f, "resumed_at": at.get(theirs.get(f)), "part_at": n, "uninterrupted": int(w[n]),
                    "resumed": int(g[n]), "lp_diff_before": float(np.max(np.abs(g_lp[:n] - w_lp[:n]))) if n else 0.0}
            if dev == "cuda":
                row = forced_row(model, np.concatenate([prompts[f], w[:n]]))
                row = row.masked_fill(row < torch.topk(row, k).values[-1], float("-inf"))
                probs = torch.softmax(row / t, dim=-1)
                gen = torch.Generator(device=dev).manual_seed(
                    int(np.random.SeedSequence([3, uid]).generate_state(1, np.uint64)[0]))
                race = []
                for _ in range(n + 6):
                    q = torch.empty((1, probs.shape[-1]), device=dev, dtype=torch.float32).exponential_(1, generator=gen)
                    race.append(torch.log(probs) - torch.log(q[0]))
                top = torch.topk(race[n], 2)
                part.update(race_top_two=[int(x) for x in top.indices],
                            gap_times_t=float(t * (top.values[0] - top.values[1])),
                            draws_giving_resumed=[j for j, sc in enumerate(race) if int(torch.argmax(sc)) == int(g[n])])
            partings.append(part)
        print(json.dumps({"dtype": str(dtype), "snapshot_after_ticks": ticks, "requests": REQUESTS, "resumed": len(moved),
                          "parted": len(partings), "partings": partings}), flush=True)
    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
