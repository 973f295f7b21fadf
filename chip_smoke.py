#!/usr/bin/env python3
"""Smoke test of accelerate_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``. It builds the port's CUDA kernels from ``accelerate_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, serves a
TinyLlama-1.1B-shape Llama (seeded random weights, bf16) through
``ServingEngine`` and checks that every decode step went through the
kernel, profiles one decode tick, then checks greedy serving against a
no-cache reference loop.
Each phase prints one JSON line; any failed check exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}  # f32 outside the tensor cores

# TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T config.json
TINYLLAMA = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_hidden_layers=22,
    num_attention_heads=32, num_key_value_heads=4, max_position_embeddings=2048,
    rope_theta=10000.0, rms_norm_eps=1e-5,
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(torch, fn, reps: int = 30, warmup: int = 5, flush=None) -> float:
    """Median over ``reps`` runs of ``fn`` timed with CUDA events, after
    ``warmup`` runs; ``flush`` (a large tensor) is rewritten before each
    run so the run finds the 50 MB L2 cold, as a decode step does. At
    1 GiB the rewrite also keeps the card busy while the host enqueues the
    run, so the events time the card and not the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from accelerate_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: sorted({ln.split("info    : ")[-1] for ln in log.splitlines() if "registers" in ln}) for n, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(logs), "ptxas": ptxas})


def paged_inputs(torch, gen, b, heads, kv_heads, dim, bs, mb, dtype, rng):
    """Ragged frontiers (0 and the table's last position included), table
    rows pointing at random distinct pool blocks, pad entries at the trash
    sink."""
    nb = b * mb + 1
    dev = "cuda"
    q = torch.randn(b, heads, dim, generator=gen, device=dev).to(dtype)
    kp = torch.randn(nb, bs, kv_heads, dim, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, bs, kv_heads, dim, generator=gen, device=dev).to(dtype)
    cur = rng.integers(0, mb * bs, size=b)
    cur[0], cur[-1] = 0, mb * bs - 1
    table = np.zeros((b, mb), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    used = 0
    for i in range(b):
        n = cur[i] // bs + 1
        table[i, :n] = perm[used : used + n]
        used += n
    return (
        q, kp, vp,
        torch.as_tensor(table, device=dev),
        torch.as_tensor(cur.astype(np.int32), device=dev),
    )


def kernel_bound(q, kp, table, cur, window):
    """Least time for one call: each input byte read once (only the live
    keys of K and V), the output written once; operations of the two
    products over the live keys at the peak rate of the input type."""
    b, heads, dim = q.shape
    kv_heads = kp.shape[2]
    cur = cur.cpu().numpy().astype(np.int64)
    live = cur + 1 if window is None else np.minimum(cur + 1, window)
    live_keys = int(live.sum())
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + table.numel() * 4 + cur.size * 4 + 2 * live_keys * kv_heads * dim * elt
    flops = 4 * heads * dim * live_keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(torch):
    """The kernel against its plain version at the serving slice's shapes."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    cases = [
        # name, dtype, heads, kv_heads, dim, window, atol
        ("f32", torch.float32, 32, 4, 64, None, 1e-4),
        ("bf16", torch.bfloat16, 32, 4, 64, None, 2e-2),
        ("bf16-window256", torch.bfloat16, 32, 4, 64, 256, 2e-2),
        ("bf16-d128", torch.bfloat16, 32, 4, 128, None, 2e-2),
    ]
    b, bs, mb = 8, 16, 128
    results = {}
    for name, dtype, heads, kv_heads, dim, window, atol in cases:
        q, kp, vp, table, cur = paged_inputs(torch, gen, b, heads, kv_heads, dim, bs, mb, dtype, rng)

        def kernel():
            return pa.paged_decode_attention(q, kp, vp, table, cur, sliding_window=window)

        def plain():
            return pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"kernel output finite ({name})")
        check(err <= atol, f"kernel vs plain max_abs_err {err} <= {atol} ({name})")

        # yardstick: one library call over K/V gathered contiguous beforehand
        kg = kp[table.long()].reshape(b, mb * bs, kv_heads, dim).transpose(1, 2).contiguous()
        vg = vp[table.long()].reshape(b, mb * bs, kv_heads, dim).transpose(1, 2).contiguous()
        pos = torch.arange(mb * bs, device="cuda")
        mask = pos[None, :] <= cur[:, None].long()
        if window is not None:
            mask &= pos[None, :] > cur[:, None].long() - window
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, enable_gqa=True)

        lib_err = (library()[:, :, 0].float() - want.float()).abs().max().item()
        bound_ms, bound_by = kernel_bound(q, kp, table, cur, window)
        row = {
            "phase": "kernel", "case": name, "shape": [b, heads, kv_heads, dim, bs, mb], "window": window,
            "max_abs_err": err, "atol": atol, "library_max_abs_err": lib_err,
            "ms": time_ms(torch, kernel, flush=flush), "plain_ms": time_ms(torch, plain, flush=flush),
            "library_ms": time_ms(torch, library, flush=flush), "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(row)
        results[name] = row
    return results


def phase_kernel_sweep(torch):
    """The kernel against its plain version over the shapes it takes: every
    dtype, group sizes 1-8, both head dims, blocks of 4-128 rows (24: not
    a power of two), windows of 1 and 100 keys, frontiers at 0 and past
    the table."""
    import itertools

    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
    worst, n = 0.0, 0
    for dtype, (heads, kv_heads), dim, bs, window in itertools.product(
        tols, ((4, 4), (8, 2), (8, 1)), (64, 128), (4, 16, 24, 128), (None, 1, 100)
    ):
        b, mb = 3, max(2, 512 // bs)
        q, kp, vp, table, cur = paged_inputs(torch, gen, b, heads, kv_heads, dim, bs, mb, dtype, rng)
        cur[1] = mb * bs + 37  # past the table: the frontier clamps to its last entry
        got = pa.paged_decode_attention(q, kp, vp, table, cur, sliding_window=window)
        want = pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tols[dtype], f"sweep {dtype} H{heads}/{kv_heads} D{dim} bs{bs} W{window}: {err}")
        worst, n = max(worst, err / tols[dtype]), n + 1
    emit({"phase": "kernel_sweep", "cases": n, "worst_err_over_tol": worst})


def phase_serve(torch):
    """TinyLlama-1.1B shape in bf16 served by the paged engine; every
    decode step's attention must be the kernel."""
    from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = LlamaConfig(**TINYLLAMA)
    t0 = time.perf_counter()
    model = create_llama_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def engine():
        return ServingEngine(model, num_slots=8, prompt_buckets=(64, 256), paged_block_size=16, tick_block=8)

    # warm-up outside the measured run (library handles, allocator)
    engine().generate_many([np.arange(1, 9, dtype=np.int32), np.arange(1, 300, dtype=np.int32)], max_new_tokens=9)

    rng = np.random.default_rng(1)
    lengths = [5, 400, 37, 64, 130, 256, 300, 12, 90, 200, 350, 48]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    max_new = 64
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches

    for uid, p in zip(uids, prompts):
        out, lps = eng.poll(uid), eng.logprobs(uid)
        check(out is not None and len(out) == len(p) + max_new, f"request {uid} completed with its length")
        check(len(lps) == max_new and bool(np.isfinite(lps).all()), f"request {uid} logprobs finite")
    want = cfg.num_hidden_layers * eng.decode_steps
    check(launches == want, f"kernel launches {launches} == layers x decode steps {want}")
    snap = eng.metrics.snapshot()
    row = {
        "phase": "serve", "config": "TinyLlama-1.1B shape, bf16, seeded random weights",
        "params": model.num_parameters(), "model_build_s": build_s,
        "requests": len(prompts), "prompt_lengths": lengths, "max_new_tokens": max_new,
        "generated_tokens": snap["tokens_generated"], "wall_s": wall,
        "tokens_per_s": snap["tokens_generated"] / wall,
        "ttft_ms_mean": snap["ttft_ms_mean"], "ttft_ms_p50": snap["ttft_ms_p50"], "ttft_ms_p95": snap["ttft_ms_p95"],
        "itl_ms_p50": snap["itl_ms_p50"], "decode_steps": eng.decode_steps, "kernel_launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(row)
    return row, model


def phase_profile(torch, model):
    """Where one decode tick's time goes: 8 slots decoding (prompts of
    200 tokens), ``tick_block`` steps. The tick's wall time is taken
    without the profiler; the next tick is traced with torch.profiler for
    the device's busy time (the sum of the traced kernels, one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import ServingEngine

    eng = ServingEngine(model, num_slots=8, prompt_buckets=(64, 256), paged_block_size=16, tick_block=8)
    rng = np.random.default_rng(4)
    for _ in range(8):
        eng.submit(rng.integers(1, model.config.vocab_size, size=200).astype(np.int32), 64)
    eng.step()  # admits and prefills all 8, then one tick
    eng.step()  # warm tick
    check(all(ph == "decode" for ph in eng.slot_phase), "all 8 slots decoding")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # the same tick without the profiler's host overhead
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    paged = sum(ms for name, (ms, _) in by_name.items() if "paged_decode_" in name)  # split + combine pass
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = {
        "phase": "profile", "what": "one decode tick, 8 slots x 8 steps, TinyLlama shape bf16",
        "tick_wall_ms": plain_wall_ms, "tick_wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / plain_wall_ms if busy else None,
        "paged_attention_ms": paged, "paged_attention_kernels": sum(
            n for name, (_, n) in by_name.items() if "paged_decode_" in name),
        "kernels_traced": sum(n for _, n in by_name.values()),
        "top": [[name[:80], ms, n] for name, (ms, n) in top],
    }
    emit(row)
    return row


def phase_consistency(torch):
    """Greedy serving (paged kernel decode) against a no-cache greedy loop
    over the full forward, f32, TinyLlama widths with 2 layers."""
    from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model

    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 2})
    model = create_llama_model(cfg, seed=3, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (7, 70, 300)]
    n_new = 16
    eng = ServingEngine(model, num_slots=2, prompt_buckets=(64, 256), paged_block_size=16, tick_block=8)
    uids = [eng.submit(p, n_new) for p in prompts]
    eng.run()
    compared, near_ties, max_lp_err = 0, 0, 0.0
    with torch.no_grad():
        for uid, p in zip(uids, prompts):
            got, got_lps = eng.poll(uid)[len(p):], eng.logprobs(uid)
            seq = torch.as_tensor(p, device="cuda")[None].long()
            for i in range(n_new):
                row = model(seq)[0, -1].float()
                top2 = torch.topk(row, 2).values
                ref = int(torch.argmax(row))
                if int(got[i]) != ref:
                    gap = float(top2[0] - top2[1])
                    check(gap < 1e-3, f"request {uid} token {i}: {int(got[i])} != {ref} with top-2 gap {gap}")
                    near_ties += 1
                    break
                max_lp_err = max(max_lp_err, abs(float(torch.log_softmax(row, -1)[ref]) - float(got_lps[i])))
                compared += 1
                seq = torch.cat([seq, torch.tensor([[ref]], device="cuda")], dim=1)
    check(max_lp_err < 1e-3, f"logprob vs reference {max_lp_err} < 1e-3")
    row = {
        "phase": "consistency", "config": "TinyLlama widths, 2 layers, f32", "prompts": [len(p) for p in prompts],
        "tokens_compared": compared, "stopped_at_near_tie": near_ties, "max_logprob_err": max_lp_err,
    }
    emit(row)
    return row


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only", file=sys.stderr)
        return 1
    try:
        import accelerate_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if Path(accelerate_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: accelerate_tpu_torch must come from this checkout ({here})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    phase_build()
    print(smi, flush=True)
    kernel = phase_kernel(torch)
    phase_kernel_sweep(torch)
    serve, model = phase_serve(torch)
    phase_profile(torch, model)
    del model
    phase_consistency(torch)

    main_case = kernel["bf16"]  # the serving slice's dtype and shapes
    emit({"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/pallas_paged_attention.py:40",
        "launches": serve["kernel_launches"], "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
