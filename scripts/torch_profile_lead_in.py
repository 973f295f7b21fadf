#!/usr/bin/env python3
"""Does torch.profiler see every device kernel of a traced region? Drives
the int4 decode tick of ``chip_smoke.py``'s ``quant_profile`` phase
(TinyLlama shape, seeded random weights, projections quantized to int4 in
groups of 128, 8 slots decoding prompts of 200 tokens, 8 steps a tick) on
one CUDA card, and traces single ticks three ways, in turns:

* ``bare``: one tick inside a plain ``profile()`` context;
* ``slept``: the host sleeps 0.2 s inside the context, then a marker
  kernel (``torch.cuda._sleep(1000)``), the tick and a second marker;
* ``traced``: ``chip_smoke.traced``, a lead of 256 markers before the
  tick and one after it (``attempts``: the leads it took until a lead
  marker and the last one were traced, and how many lead markers the
  accepted trace lost).

Each traced tick prints one JSON line: the device events traced (kernels
and copies, no user annotations or markers), whether a marker before
the tick and one after it were traced (``markers``), K5's device kernels beside its wrapper launches
in that tick, K4's device kernels, and the names of the first device
events. A complete trace of a tick holds the same events every time.

    python3 scripts/torch_profile_lead_in.py
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from accelerate_tpu_torch import LlamaConfig, create_llama_model  # noqa: E402
from accelerate_tpu_torch.ops import qmatmul as qm  # noqa: E402


def ready_engine(qmodel, seed):
    """An engine whose 8 slots are all decoding: the prefill tick and two more."""
    eng = cs.serve_engine(qmodel)
    rng = np.random.default_rng(seed)
    for _ in range(8):
        eng.submit(rng.integers(1, qmodel.config.vocab_size, size=200).astype(np.int32), 64)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    return eng


def device_events(prof):
    from torch.autograd import DeviceType

    return sorted((ev for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)),
                  key=lambda ev: ev.time_range.start)


def bare(eng):
    from torch.profiler import ProfilerActivity, profile

    qm.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    return device_events(prof), None, None


def slept(eng):
    from torch.profiler import ProfilerActivity, profile

    def marker():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    qm.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        marker()
        eng.step()
        torch.cuda.synchronize()
        marker()
    events = device_events(prof)
    kept = [ev for ev in events if "spin_kernel" not in ev.name]
    spins = [ev.time_range.start for ev in events if "spin_kernel" in ev.name]
    markers = [any(t < kept[0].time_range.start for t in spins), any(t > kept[-1].time_range.start for t in spins)]
    return kept, None, markers


def traced(eng):
    def tick():
        qm.launches = 0
        eng.step()

    events, _, attempts, lost = cs.traced(torch, tick)
    return sorted(events, key=lambda ev: ev.time_range.start), [attempts, lost], [True, True]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_lead_in: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    cs.phase_build()
    model = create_llama_model(LlamaConfig(**cs.TINYLLAMA), seed=0, dtype=torch.bfloat16)
    qmodel = cs.quantize_for_serving(torch, model)[0]
    del model
    cs.serve_engine(qmodel).generate_many(
        [np.arange(1, 9, dtype=np.int32), np.arange(1, 300, dtype=np.int32)], max_new_tokens=9)
    ways = {"bare": bare, "slept": slept, "traced": traced}
    for turn in range(8):
        for mode, way in ways.items():
            evs, attempts, markers = way(ready_engine(qmodel, turn))
            print(json.dumps({
                "mode": mode, "attempts": attempts, "markers": markers, "traced": len(evs),
                "k5_launches": qm.launches, "k5_kernels": sum("int4_matmul_" in ev.name for ev in evs),
                "k4_kernels": sum("paged_decode_" in ev.name for ev in evs),
                "first": [ev.name[:40] for ev in evs[:4]],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
