#!/usr/bin/env python3
"""Smoke test of accelerate_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``. It builds the port's CUDA kernels from ``accelerate_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and holds each against its plain
PyTorch version on the card. Then the two slices:

* serving: a TinyLlama-1.1B-shape Llama (seeded random weights, bf16)
  served through ``ServingEngine``, every decode step through the paged
  kernel (K4); one decode tick profiled; greedy serving checked against a
  no-cache reference loop;
* training: the same shape at full depth, f32 masters and bf16 compute,
  trained for 12 steps at batch 8 x seq 2048 through ``Accelerator`` ->
  ``build_train_step``, every layer's attention through the flash kernels
  (K1 forward, twice with remat; K2 and K3 backward), and the kernels held
  against their plain versions on one layer's inputs from that run; one
  step profiled; 2-layer runs in f32 and in bf16 compute checked against
  the einsum attention path; the flash/einsum crossover measured.

Each phase prints one JSON line; any failed check exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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


# ---------------------------------------------------------------------------
# training slice: flash attention kernels K1-K3 and the train step
# ---------------------------------------------------------------------------

# K1-K3 against their plain versions. Each element of out, dq, dk and dv must
# lie within t (|ref| + RMS(ref)) of its reference, plus GRAD_FLOOR RMS(dO)
# for the gradients; lse within LSE_TOL. Each limit is two to seven times the
# largest error read on the card over flash_kernel's and flash_sweep's cases
# (their err_over_tol; PERF.md). The floor is there for inputs where every
# live row has one live key: dS, dq and dk are then 0 but for rounding.
FLASH_TOL = {
    "float32": {"out": 2e-5, "dq": 2e-5, "dk": 2e-4, "dv": 2e-4},
    "bfloat16": {"out": 2e-2, "dq": 5e-2, "dk": 2e-2, "dv": 3e-2},
    "float16": {"out": 5e-3, "dq": 1e-2, "dk": 5e-3, "dv": 5e-3},
}
LSE_TOL = 1e-5
GRAD_FLOOR = 2e-5


def live_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs the masks leave live: the work these inputs need."""
    row = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(row, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(row - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound(kind, q, k, causal, window):
    """Least time for one call of K1 (fwd), K2 (dq) or K3 (dkv): every input
    read once and every output written once over the HBM rate, against the
    products over the live pairs (2, 3 or 4 of them, 2 D FLOPs a pair each)
    at the peak rate of the input type."""
    b, sq, h, d = q.shape
    elt = q.element_size()
    pairs = live_pairs(sq, k.shape[1], causal, window)
    qo, kv, rows = q.numel() * elt, k.numel() * elt, b * h * sq * 4
    nbytes = {
        "fwd": qo + 2 * kv + qo + rows,  # q, k, v -> out, lse
        "dq": 2 * qo + 2 * kv + 2 * rows + q.numel() * 4,  # q, dO, k, v, lse, delta -> dq f32
        "dkv": 2 * qo + 2 * kv + 2 * rows + 2 * k.numel() * 4,  # -> dk, dv f32
    }[kind]
    flops = {"fwd": 2, "dq": 3, "dkv": 4}[kind] * 2 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_inputs(torch, gen, b, sq, sk, h, h_kv, d, dtype):
    return [torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, sq, h, d), (b, sk, h_kv, d), (b, sk, h_kv, d), (b, sq, h, d))]


def flash_err(torch, got, want, t, floor=0.0) -> tuple[float, float]:
    """``(max |got - want|, max of |got - want| / (t (|want| + RMS(want)) +
    floor))``: the second is at most 1 where ``got`` is within tolerance.
    The infinities (a dead row's lse) must agree exactly."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin], want[~fin]):
        return float("inf"), float("inf")
    if not fin.any():
        return 0.0, 0.0
    got, want = got[fin], want[fin]
    err = (got - want).abs()
    limit = t * (want.abs() + want.pow(2).mean().sqrt()) + floor
    over = torch.where(err == 0, torch.zeros_like(err), err / limit)
    return err.max().item(), over.max().item()


def flash_compare(torch, fa, q, k, v, do, causal, window):
    """Each kernel against its plain version on the same inputs (K2 and K3
    fed K1's lse and delta): ``{kind: (max abs error, max error over its
    tolerance)}`` for fwd (out, lse), dq and dkv (dk, dv)."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_fwd_kernel(q, k, v, causal, scale, window)
    delta = fa._delta(out, do)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, causal, scale, window)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal, scale, window)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, scale, window)
    want_dq = fa.flash_attention_plain_dq(q, k, v, do, lse, delta, causal, scale, window)
    want_dk, want_dv = fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, causal, scale, window)
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    floor = GRAD_FLOOR * do.float().pow(2).mean().sqrt().item()
    errs = {
        "fwd": [flash_err(torch, out, want_out, tol["out"]), flash_err(torch, lse, want_lse, 0.0, LSE_TOL)],
        "dq": [flash_err(torch, dq, want_dq, tol["dq"], floor)],
        "dkv": [flash_err(torch, dk, want_dk, tol["dk"], floor), flash_err(torch, dv, want_dv, tol["dv"], floor)],
    }
    return {kind: (max(e[0] for e in es), max(e[1] for e in es)) for kind, es in errs.items()}, (out, lse, delta)


def check_flash(errs, what: str) -> None:
    for kind, (_, over) in errs.items():
        check(over <= 1.0, f"flash {kind} vs plain: error {over} x its tolerance ({what})")


def phase_flash_kernel(torch):
    """K1-K3 against their plain versions at the training slice's attention
    shape (B 8, H 32, H_kv 4, D 64, S 2048, causal, bf16), again in f32 and
    at D 128; their times beside the bound, the plain version's and
    scaled_dot_product_attention's (forward; backward, which computes dq,
    dk and dv in one call). Tolerances: FLASH_TOL."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    cases = [("bf16", torch.bfloat16, 64, 30), ("f32", torch.float32, 64, 5), ("bf16-d128", torch.bfloat16, 128, 30)]
    b, s, h, h_kv = 8, 2048, 32, 4
    results = {}
    for name, dtype, d, reps in cases:
        q, k, v, do = flash_inputs(torch, gen, b, s, s, h, h_kv, d, dtype)
        errs, (out, lse, delta) = flash_compare(torch, fa, q, k, v, do, True, None)
        check_flash(errs, name)
        scale = d**-0.5
        kernels = {
            "fwd": lambda: fa.flash_fwd_kernel(q, k, v, True, scale, None),
            "dq": lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, True, scale, None),
            "dkv": lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, True, scale, None),
        }
        plains = {
            "fwd": lambda: fa.flash_attention_plain(q, k, v, True, scale),
            "dq": lambda: fa.flash_attention_plain_dq(q, k, v, do, lse, delta, True, scale),
            "dkv": lambda: fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, True, scale),
        }
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = (lib_out.transpose(1, 2).float() - out.float()).abs().max().item()
        dot = do.transpose(1, 2).contiguous()
        library = {
            "fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            "bwd": lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True),
        }
        row = {"phase": "flash_kernel", "case": name, "shape": [b, s, h, h_kv, d], "causal": True,
               "library_max_abs_err_fwd": lib_err}
        for kind in kernels:
            bound_ms, bound_by = flash_bound(kind, q, k, True, None)
            row[kind] = {
                "max_abs_err": errs[kind][0], "err_over_tol": errs[kind][1],
                "ms": time_ms(torch, kernels[kind], reps=reps, flush=flush),
                "plain_ms": time_ms(torch, plains[kind], reps=min(reps, 5), warmup=1, flush=flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
        row["library_fwd_ms"] = time_ms(torch, library["fwd"], reps=reps, flush=flush)
        row["library_bwd_ms"] = time_ms(torch, library["bwd"], reps=reps, flush=flush)
        emit(row)
        results[name] = row
        del q, k, v, do, out, lse, delta, qt, kt, vt, lib_out, dot, kernels, plains, library
    return results


def phase_flash_sweep(torch):
    """K1-K3 against their plain versions over the shapes they take: every
    dtype, groups 1/4/8, D 64/128, Sq = Sk in {1, 100, 2048}, Sq < Sk and
    Sq > Sk (dead rows under causal), non-causal, causal, and bands of 1 and
    100 keys."""
    import itertools

    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    shapes = ((1, 1), (100, 100), (2048, 2048), (100, 300), (300, 100))
    masks = ((False, None), (True, None), (True, 1), (True, 100))
    worst, n = {}, 0
    for dtype, g, d, (sq, sk), (causal, window) in itertools.product(dtypes, (1, 4, 8), (64, 128), shapes, masks):
        q, k, v, do = flash_inputs(torch, gen, 1, sq, sk, 2 * g, 2, d, dtype)
        errs, _ = flash_compare(torch, fa, q, k, v, do, causal, window)
        check_flash(errs, f"sweep {dtype} G{g} D{d} {sq}x{sk} causal={causal} W{window}")
        for kind, (_, over) in errs.items():
            key = f"{str(dtype).split('.')[-1]} {kind}"
            worst[key] = max(worst.get(key, 0.0), over)
        n += 1
    emit({"phase": "flash_sweep", "cases": n, "worst_err_over_tol": worst})


def llama_step_flops(module, cfg, tokens: int, seq_len: int) -> float:
    """bench.py's _llama_step_flops: 6 x non-embedding params x tokens, plus
    the attention scores (2 S^2 hidden a layer forward, x3 with the
    backward, halved by causality)."""
    n_params = sum(p.numel() for name, p in module.named_parameters() if "embed" not in name)
    batch = tokens // seq_len
    attn = 0.5 * 12.0 * cfg.num_hidden_layers * batch * seq_len**2 * cfg.hidden_size
    lm_head = 6.0 * tokens * cfg.hidden_size * cfg.vocab_size if cfg.tie_word_embeddings else 0.0
    return 6.0 * n_params * tokens + attn + lm_head


def token_batches(torch, n, b, s, vocab, seed):
    """Token ids with a skewed (Pareto) unigram distribution, made with numpy:
    something a model can learn in a few steps."""
    rng = np.random.default_rng(seed)
    ids = (rng.pareto(1.2, size=(n, b, s)) * 50).astype(np.int64) % vocab
    return torch.as_tensor(ids, device="cuda")


def build_trainer(torch, cfg, mixed_precision, seed=0, lr=3e-4):
    from accelerate_tpu_torch import Accelerator, causal_lm_loss, create_llama_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(mixed_precision=mixed_precision)
    model = acc.prepare_model(create_llama_model(cfg, seed=seed, dtype=torch.float32))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=lr, weight_decay=0.01))
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    return acc, model, step


@contextlib.contextmanager
def first_dq_call(fa):
    """Keep the ``(q, k, v, dO)`` of the first call to K2's wrapper while the
    block runs: the last layer's attention inputs as the model made them."""
    real, seen = fa.flash_dq_kernel, []

    def spy(q, k, v, dout, *rest):
        if not seen:  # detached: the recomputed q, k, v would keep the layer's graph alive
            seen.append(tuple(t.detach() for t in (q, k, v, dout)))
        return real(q, k, v, dout, *rest)

    fa.flash_dq_kernel = spy
    try:
        yield seen
    finally:
        fa.flash_dq_kernel = real


def phase_train(torch):
    """TinyLlama-1.1B shape at full depth, f32 masters, bf16 compute, remat,
    batch 8 x seq 2048, AdamW(3e-4, weight decay 0.01): 2 warm-up and 10
    timed steps through build_train_step. Every layer's attention must be
    the flash kernels: K1 twice a layer a step (forward and remat), K2 and
    K3 once. The first step's last-layer q, k, v and dO are kept, and K1-K3
    are held against their plain versions on them once the counts are read."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.ops import flash_attention as fa

    b, s, warmup, timed = 8, 2048, 2, 10
    cfg = LlamaConfig(**TINYLLAMA, remat=True)
    acc, model, step = build_trainer(torch, cfg, "bf16")
    batches = token_batches(torch, warmup + timed, b, s, cfg.vocab_size, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    losses, times = [], []
    with first_dq_call(fa) as seen:
        for i in range(warmup + timed):
            t0 = time.perf_counter()
            loss = step({"input_ids": batches[i]})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv}
    n, layers = warmup + timed, cfg.num_hidden_layers
    check(all(np.isfinite(losses)), f"losses finite: {losses}")
    check(losses[-1] < losses[0], f"loss falls over {n} steps: {losses[0]} -> {losses[-1]}")
    check(launches == {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n},
          f"flash launches {launches} == K1 2 x {layers} x {n}, K2/K3 {layers} x {n}")
    q, k, v, do = seen[0]
    model_errs, _ = flash_compare(torch, fa, q, k, v, do, True, None)
    check_flash(model_errs, "the train step's own last-layer inputs")
    del seen, q, k, v, do
    step_ms = sorted(times[warmup:])
    flops = llama_step_flops(model.module, cfg, b * s, s)
    med = statistics.median(step_ms)
    row = {
        "phase": "train", "config": "TinyLlama-1.1B shape, 22 layers, f32 masters + bf16 compute, remat, seeded",
        "params": model.num_parameters(), "batch": b, "seq": s, "warmup_steps": warmup, "timed_steps": timed,
        "tokens_per_s": b * s / (med / 1e3), "step_ms_median": med,
        "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1], "step_flops": flops,
        "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "launches": launches,
        "flash_vs_plain_on_model_inputs": {kind: {"max_abs_err": a, "err_over_tol": o}
                                           for kind, (a, o) in model_errs.items()},
    }
    emit(row)
    return row, acc, model, step, batches


def phase_train_profile(torch, step, batches):
    """One more train step under torch.profiler: device busy time (the union
    of the traced kernels' intervals; user annotations left out), idle share
    against the traced step's wall time, and where the device time goes.
    The step's wall time without the profiler is given beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step({"input_ids": batches[0]})
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step({"input_ids": batches[1]})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            ms, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
            spans.append((ev.time_range.start, ev.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3

    def share(pred):
        return sum(ms for name, (ms, _) in by_name.items() if pred(name.lower()))

    flash = {k: share(lambda nm, k=k: f"flash_{k}<" in nm or f"flash_{k}(" in nm) for k in ("fwd", "dq", "dkv")}
    gemm = share(lambda nm: any(t in nm for t in ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    row = {
        "phase": "train_profile", "what": "one train step, TinyLlama shape, batch 8 x 2048, bf16 compute, remat",
        "step_wall_ms": wall_ms, "step_wall_ms_unprofiled": plain_wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if busy else None,
        "flash_ms": flash, "flash_share": sum(flash.values()) / busy if busy else None,
        "gemm_ms": gemm, "gemm_share": gemm / busy if busy else None,
        "kernels_traced": sum(n for _, n in by_name.values()),
        "top": [[name[:90], ms, n] for name, (ms, n) in top],
    }
    emit(row)
    return row


def phase_train_consistency(torch, mixed_precision):
    """TinyLlama widths, 2 layers, batch 1 x seq 2048, where the flash path
    dispatches by itself: three steps through the kernels, then three from
    the same weights on the einsum attention path (FLASH_MIN_SEQ raised
    above the sequence for that run only). In f32 (the kernels' CUDA-core
    path) losses agree within 1e-5 relative and grad norms within 1e-4. In
    bf16 compute (the tensor-core path) the einsum path rounds its scores to
    bf16 where the kernels keep them f32: losses within 1e-4, grad norms
    within 2e-3, about twice the differences read on the card (PERF.md)."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.ops import attention
    from accelerate_tpu_torch.ops import flash_attention as fa

    loss_tol, norm_tol = {"no": (1e-5, 1e-4), "bf16": (1e-4, 2e-3)}[mixed_precision]
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 2}, remat=True)
    batches = token_batches(torch, 3, 1, 2048, cfg.vocab_size, seed=5)
    runs = {}
    saved = attention.FLASH_MIN_SEQ
    try:
        for path in ("flash", "einsum"):
            attention.FLASH_MIN_SEQ = saved if path == "flash" else 1 << 30
            before = fa.launches_fwd
            acc, model, step = build_trainer(torch, cfg, mixed_precision, seed=4)
            losses, norms = [], []
            for i in range(3):
                losses.append(float(step({"input_ids": batches[i]})))
                norms.append(float(acc._last_grad_norm))
            runs[path] = {"losses": losses, "grad_norms": norms, "k1_launches": fa.launches_fwd - before}
            del acc, model, step
    finally:
        attention.FLASH_MIN_SEQ = saved
    check(runs["flash"]["k1_launches"] == 2 * 2 * 3 and runs["einsum"]["k1_launches"] == 0,
          f"flash run through K1, einsum run not: {runs}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["flash"]["losses"], runs["einsum"]["losses"]))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(runs["flash"]["grad_norms"], runs["einsum"]["grad_norms"]))
    check(loss_err <= loss_tol, f"flash vs einsum loss rel err {loss_err} <= {loss_tol} ({mixed_precision})")
    check(norm_err <= norm_tol, f"flash vs einsum grad norm rel err {norm_err} <= {norm_tol} ({mixed_precision})")
    compute = "f32" if mixed_precision == "no" else "f32 masters + bf16 compute"
    row = {"phase": "train_consistency", "config": f"TinyLlama widths, 2 layers, {compute}, batch 1 x 2048",
           **runs, "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err}
    emit(row)
    return row


def phase_flash_crossover(torch):
    """Forward + backward of attention through the kernels against the
    einsum path (use_flash=False) at S 128-4096, 16,384 tokens a call (the
    training batch), H 32, H_kv 4, D 64, causal, bf16: where the card's
    crossover for FLASH_MIN_SEQ lies."""
    from accelerate_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for s in (128, 256, 512, 1024, 2048, 4096):
        q, k, v, do = flash_inputs(torch, gen, 16384 // s, s, s, 32, 4, 64, torch.bfloat16)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        times = {}
        for path, flag in (("flash", True), ("einsum", False)):
            def run(flag=flag):
                dot_product_attention(q, k, v, causal=True, use_flash=flag).backward(do)

            times[path] = time_ms(torch, run, reps=10, warmup=2)
        rows.append({"seq": s, "batch": 16384 // s, "flash_ms": times["flash"], "einsum_ms": times["einsum"],
                     "einsum_over_flash": times["einsum"] / times["flash"]})
        del q, k, v, do
        torch.cuda.empty_cache()
    emit({"phase": "flash_crossover", "what": "fwd+bwd, H 32/4, D 64, causal, bf16, 16384 tokens", "rows": rows})
    return rows


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
    flash = phase_flash_kernel(torch)["bf16"]  # the training slice's dtype and shapes
    phase_flash_sweep(torch)
    serve, model = phase_serve(torch)
    phase_profile(torch, model)
    del model
    phase_consistency(torch)
    train, acc, model, step, batches = phase_train(torch)
    phase_train_profile(torch, step, batches)
    del acc, model, step, batches
    torch.cuda.empty_cache()
    phase_train_consistency(torch, "no")
    phase_train_consistency(torch, "bf16")
    phase_flash_crossover(torch)

    main_case = kernel["bf16"]  # the serving slice's dtype and shapes
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/pallas_paged_attention.py:40",
        "launches": serve["kernel_launches"], "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
    }]
    for kind, name, line in (("fwd", "flash_attention_fwd", 89), ("dq", "flash_attention_dq", 177),
                             ("dkv", "flash_attention_dkv", 210)):
        row = flash[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": "accelerate_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"accelerate_tpu/ops/pallas_attention.py:{line}",
            "launches": train["launches"][kind], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # K1: scaled_dot_product_attention's forward; K2, K3: its backward, one call for dq, dk and dv
            "library_ms": flash["library_fwd_ms"] if kind == "fwd" else flash["library_bwd_ms"],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
