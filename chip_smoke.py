#!/usr/bin/env python3
"""Smoke test of accelerate_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``. It builds the port's CUDA kernels from ``accelerate_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and holds each against its plain
PyTorch version on the card: K4 at every head dim it takes (16 to 256),
K1-K3 in bf16, fp16 and f32 (in 16 bits the Hopper kernels of
``flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu``), with each one's TFLOP/s
and share of its bound, and each one's launch as the C launcher reports it,
as ``fwd_launch`` / ``bwd_launch`` give it and as ``kernel_check`` records
it, all three equal. Then the slices:

* serving: a TinyLlama-1.1B-shape Llama (seeded random weights, bf16)
  served through ``ServingEngine``, every decode step through the paged
  kernel (K4); one decode tick profiled; greedy serving checked against a
  no-cache reference loop, at TinyLlama's widths and at
  ``LlamaConfig.tiny()``'s head dim of 16;
* training: the same shape at full depth, f32 masters and bf16 compute,
  trained for 12 steps at batch 8 x seq 2048 through ``Accelerator`` ->
  ``build_train_step``, every layer's attention through the flash kernels
  (K1 forward, twice with remat; K2 and K3 backward), and the kernels held
  against their plain versions on one layer's inputs from that run; one
  step profiled; 2-layer runs in f32 and in bf16 compute checked against
  the einsum attention path; the flash/einsum crossover measured;
* quantized decode: the same shape with every projection quantized to
  int4 (group 128) by ``load_and_quantize_model``, served by the same
  engine and decoded by ``generate``, every projection through the fused
  dequantize-matmul kernel (K5; 154 launches a forward) and every decode
  step's attention through K4; the int4 tick profiled; a 2-layer int4
  model checked against a no-cache loop over ``nn.Linear`` layers holding
  the decoded weights. The two reference kernels (K6, K7) are held
  against their plain versions (ragged rows included), two calls bit-equal,
  and timed against the bounds their registered cost contracts give;
* the kernel-check path: the analyzer's capacity against the card's own,
  its selfcheck, ``Accelerator().kernel_check`` over the six seeded-defect
  fixtures and the clean twins K6/K7, each probed on the card (the fixture
  kernels K8: the shared-memory hog refused, the rest launched), and over
  the TinyLlama decode and train steps traced on meta; every fixture's
  outcome on the card asserted, every declared shared-memory occupancy
  held to what ``nvcc`` built, the three K8 bodies timed;
* fine-tuning BERT: examples/torch_nlp_example.py's loop at BERT-base's
  full width and depth (seeded random weights, bf16 compute with the
  softmax in bf16) for one epoch of 3,668 rows through the data loader,
  every batch on the card, the end flag on the last batch only, and
  ``gather_for_metrics`` giving back exactly 3,668 predictions;
  ``bench.py::run_bench``'s configuration (batch 256 x 128) timed, with
  its MFU, peak memory and the device's idle share; a 2-layer f32 run on
  the card held to the same run on the CPU. No kernel runs there: BERT's
  padded attention is the einsum path, as in the JAX package.

Each phase prints one JSON line; any failed check exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
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


def free_memory(torch) -> None:
    """Return dropped models and engines to the card: they sit in reference
    cycles, so only a collector pass frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_build():
    from accelerate_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: sorted({ln.split("info    : ")[-1] for ln in log.splitlines() if "registers" in ln})
             for n, (log, _) in logs.items()}
    by_library = {n: s for n, (_, s) in logs.items()}  # each nvcc's wall time, all running at once
    emit({"phase": "build", "seconds": seconds, "seconds_by_library": by_library, "libraries": sorted(logs),
          "ptxas": ptxas})


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
    one = torch.zeros(1, device="cuda")
    results = {}
    for name, dtype, heads, kv_heads, dim, window, atol in cases:
        q, kp, vp, table, cur = paged_inputs(torch, gen, b, heads, kv_heads, dim, bs, mb, dtype, rng)

        def kernel():
            return pa.paged_decode_attention(q, kp, vp, table, cur, sliding_window=window)

        def plain():
            return pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"kernel output finite ({name})")
        check(err <= atol, f"kernel vs plain max_abs_err {err} <= {atol} ({name})")
        check(torch.equal(got, again), f"two calls on the same inputs bit-equal ({name})")  # splits joined in order

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
            # the protocol's floor: a one-element fill timed the same way (events around it, L2 flushed)
            "floor_ms": time_ms(torch, lambda: one.zero_(), flush=flush),
        }
        emit(row)
        results[name] = row
    return results


def phase_kernel_sweep(torch):
    """The kernel against its plain version over the shapes it takes: every
    dtype, group sizes 1-8, head dims 16, 64, 96, 128 and 256, blocks of 4-128
    rows (24: not a power of two; 128 rows at D 256 in tiles of part of a
    page), windows of 1 and 100 keys, frontiers at 0 and past the table."""
    import itertools

    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
    worst, n, worst_by_dim = 0.0, 0, {}
    for dtype, (heads, kv_heads), dim, bs, window in itertools.product(
        tols, ((4, 4), (8, 2), (8, 1)), (16, 64, 96, 128, 256), (4, 16, 24, 128), (None, 1, 100)
    ):
        b, mb = 3, max(2, 512 // bs)
        q, kp, vp, table, cur = paged_inputs(torch, gen, b, heads, kv_heads, dim, bs, mb, dtype, rng)
        cur[1] = mb * bs + 37  # past the table: the frontier clamps to its last entry
        got = pa.paged_decode_attention(q, kp, vp, table, cur, sliding_window=window)
        want = pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tols[dtype], f"sweep {dtype} H{heads}/{kv_heads} D{dim} bs{bs} W{window}: {err}")
        worst, n = max(worst, err / tols[dtype]), n + 1
        worst_by_dim[dim] = max(worst_by_dim.get(dim, 0.0), err / tols[dtype])
    emit({"phase": "kernel_sweep", "cases": n, "worst_err_over_tol": worst, "worst_by_head_dim": worst_by_dim})


def serve_engine(model):
    from accelerate_tpu_torch import ServingEngine

    return ServingEngine(model, num_slots=8, prompt_buckets=(64, 256), paged_block_size=16, tick_block=8)


def serve_run(torch, model, phase, config):
    """The serving configuration on ``model``: 12 prompts of 5-400 tokens,
    64 new tokens each, greedy. Every decode step's attention must be K4,
    and for a quantized model every projection of every forward K5."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import qmatmul

    cfg = model.config
    # warm-up outside the measured run (library handles, allocator)
    serve_engine(model).generate_many(
        [np.arange(1, 9, dtype=np.int32), np.arange(1, 300, dtype=np.int32)], max_new_tokens=9
    )

    rng = np.random.default_rng(1)
    lengths = [5, 400, 37, 64, 130, 256, 300, 12, 90, 200, 350, 48]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    max_new = 64
    free_memory(torch)  # the warm-up engine's pools, and whatever an earlier phase dropped
    eng = serve_engine(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches = qmatmul.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int4_launches = pa.launches, qmatmul.launches

    for uid, p in zip(uids, prompts):
        out, lps = eng.poll(uid), eng.logprobs(uid)
        check(out is not None and len(out) == len(p) + max_new, f"request {uid} completed with its length")
        check(len(lps) == max_new and bool(np.isfinite(lps).all()), f"request {uid} logprobs finite")
    want = cfg.num_hidden_layers * eng.decode_steps
    check(launches == want, f"kernel launches {launches} == layers x decode steps {want}")
    forwards = eng.prefill_forwards + eng.decode_steps
    want_int4 = 7 * cfg.num_hidden_layers * forwards if cfg.quant_method == "int4" else 0
    check(int4_launches == want_int4, f"int4 launches {int4_launches} == 7 x layers x forwards {want_int4}")
    snap = eng.metrics.snapshot()
    return {
        "phase": phase, "config": config, "params": model.num_parameters(),
        "requests": len(prompts), "prompt_lengths": lengths, "max_new_tokens": max_new,
        "generated_tokens": snap["tokens_generated"], "wall_s": wall,
        "tokens_per_s": snap["tokens_generated"] / wall,
        "ttft_ms_mean": snap["ttft_ms_mean"], "ttft_ms_p50": snap["ttft_ms_p50"], "ttft_ms_p95": snap["ttft_ms_p95"],
        "itl_ms_p50": snap["itl_ms_p50"], "decode_steps": eng.decode_steps, "prefill_forwards": eng.prefill_forwards,
        "kernel_launches": launches, "int4_launches": int4_launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def phase_serve(torch):
    """TinyLlama-1.1B shape in bf16 served by the paged engine; every
    decode step's attention must be the kernel."""
    from accelerate_tpu_torch import LlamaConfig, create_llama_model

    cfg = LlamaConfig(**TINYLLAMA)
    t0 = time.perf_counter()
    model = create_llama_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    row = serve_run(torch, model, "serve", "TinyLlama-1.1B shape, bf16, seeded random weights")
    row["model_build_s"] = build_s
    emit(row)
    return row, model


def traced(torch, run, leads=(256, 2048, 8192)):
    """``run()`` under torch.profiler: ``(its device events, wall ms of run,
    attempts, lead markers lost)``, the events without user annotations
    or markers. The profiler loses the first few device events of a
    window, more the longer the process has run, whether the host or the
    card waited before them (``scripts/torch_profile_lead_in.py``). So
    ``lead`` marker kernels
    (``torch.cuda._sleep``'s spin, a microsecond each) open the window and
    take that loss, and one more follows ``run``. Where a lead marker and
    the last one are traced, so is everything between them. Otherwise
    ``run`` is traced again behind a longer lead; the phase fails if none
    does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt, lead in enumerate(leads, 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]
        kept = [ev for ev in events if "spin_kernel" not in ev.name]
        spins = [ev.time_range.start for ev in events if "spin_kernel" in ev.name]
        first, last = min(ev.time_range.start for ev in kept), max(ev.time_range.start for ev in kept)
        led = sum(t < first for t in spins)
        if led and sum(t > last for t in spins) == 1:
            return kept, wall_ms, attempt, lead - led
    check(False, f"torch.profiler traced a lead marker and the last one around the run (leads up to {leads[-1]})")


def phase_profile(torch, model, phase="profile", what="TinyLlama shape bf16"):
    """Where one decode tick's time goes: 8 slots decoding (prompts of
    200 tokens), ``tick_block`` steps. The tick's wall time is taken
    without the profiler; the next is traced with torch.profiler
    (``traced``) for the device's busy time (the sum of the traced kernels,
    one stream)."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import qmatmul as qm

    eng = serve_engine(model)
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

    def tick():
        pa.launches = qm.launches = 0
        eng.step()

    events, wall_ms, attempts, lost = traced(torch, tick)
    k4_calls, k5_calls = pa.launches, qm.launches
    by_name: dict = {}
    for ev in events:
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    paged = [(ms, n) for name, (ms, n) in by_name.items() if "paged_decode_" in name]
    int4 = [(ms, n) for name, (ms, n) in by_name.items() if "int4_matmul_" in name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = {
        "phase": phase, "what": f"one decode tick, 8 slots x 8 steps, {what}",
        "tick_wall_ms": plain_wall_ms, "tick_wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / plain_wall_ms if busy else None,
        "paged_attention_ms": sum(ms for ms, _ in paged), "paged_attention_kernels": sum(n for _, n in paged),
        "paged_attention_launches": k4_calls,
        "int4_matmul_ms": sum(ms for ms, _ in int4), "int4_matmul_kernels": sum(n for _, n in int4),
        "int4_matmul_launches": k5_calls,
        "kernels_traced": sum(n for _, n in by_name.values()), "trace_attempts": attempts, "trace_lead_lost": lost,
        "top": [[name[:80], ms, n] for name, (ms, n) in top],
    }
    emit(row)
    # one device kernel for each wrapper launch: the splits are joined inside the launch
    check(k4_calls > 0 and row["paged_attention_kernels"] == k4_calls,
          f"{phase}: K4 device kernels {row['paged_attention_kernels']} == its launches {k4_calls}")
    check(row["int4_matmul_kernels"] == k5_calls,
          f"{phase}: K5 device kernels {row['int4_matmul_kernels']} == its launches {k5_calls}")
    return row


def greedy_against_reference(torch, reference, served, gap_limit):
    """Greedy tokens and logprobs of ``served`` (``[(prompt, tokens,
    logprobs)]``) against a no-cache greedy loop over ``reference``'s full
    forward. A token may differ only where the reference's top-2 logit gap
    is under ``gap_limit``, which ends that request's comparison. Returns
    ``(tokens compared, requests stopped at a near tie, max logprob error)``."""
    compared, near_ties, max_lp_err = 0, 0, 0.0
    with torch.no_grad():
        for n_req, (prompt, got, got_lps) in enumerate(served):
            seq = torch.as_tensor(np.asarray(prompt), device="cuda")[None].long()
            for i in range(len(got)):
                row = reference(seq)[0, -1].float()
                top2 = torch.topk(row, 2).values
                ref = int(torch.argmax(row))
                if int(got[i]) != ref:
                    gap = float(top2[0] - top2[1])
                    check(gap < gap_limit, f"request {n_req} token {i}: {int(got[i])} != {ref} with top-2 gap {gap}")
                    near_ties += 1
                    break
                max_lp_err = max(max_lp_err, abs(float(torch.log_softmax(row, -1)[ref]) - float(got_lps[i])))
                compared += 1
                seq = torch.cat([seq, torch.tensor([[ref]], device="cuda")], dim=1)
    return compared, near_ties, max_lp_err


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
    served = [(p, eng.poll(uid)[len(p):], eng.logprobs(uid)) for uid, p in zip(uids, prompts)]
    compared, near_ties, max_lp_err = greedy_against_reference(torch, model, served, gap_limit=1e-3)
    check(max_lp_err < 1e-3, f"logprob vs reference {max_lp_err} < 1e-3")
    row = {
        "phase": "consistency", "config": "TinyLlama widths, 2 layers, f32", "prompts": [len(p) for p in prompts],
        "tokens_compared": compared, "stopped_at_near_tie": near_ties, "max_logprob_err": max_lp_err,
    }
    emit(row)
    return row


def phase_tiny_serve(torch):
    """LlamaConfig.tiny() (head dim 16, which K4 takes since slice 6) served
    by the paged engine on the card in f32: every decode step's attention
    through K4 (launches == layers x decode steps, counted from 0 for this
    run), greedy tokens and logprobs against a no-cache loop over the full
    forward, as the consistency phase holds TinyLlama's widths."""
    from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = LlamaConfig.tiny()
    model = create_llama_model(cfg, seed=6, dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 19, 40, 70)]
    n_new = 16
    eng = ServingEngine(model, num_slots=2, prompt_buckets=(16, 64), paged_block_size=8, tick_block=4)
    pa.launches = 0
    uids = [eng.submit(p, n_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    launches = pa.launches
    check(launches == cfg.num_hidden_layers * eng.decode_steps > 0,
          f"tiny serve: K4 launches {launches} == layers x decode steps {cfg.num_hidden_layers * eng.decode_steps}")
    served = [(p, eng.poll(uid)[len(p):], eng.logprobs(uid)) for uid, p in zip(uids, prompts)]
    check(all(len(toks) == n_new for _, toks, _ in served), "tiny serve: every request completed")
    compared, near_ties, max_lp_err = greedy_against_reference(torch, model, served, gap_limit=1e-3)
    check(max_lp_err < 1e-3, f"tiny serve: logprob vs reference {max_lp_err} < 1e-3")
    row = {
        "phase": "tiny_serve", "config": "LlamaConfig.tiny() (hidden 64, 4/2 heads, head dim 16), f32",
        "head_dim": cfg.hidden_size // cfg.num_attention_heads, "prompts": [len(p) for p in prompts],
        "kernel_launches": launches, "decode_steps": eng.decode_steps, "tokens_compared": compared,
        "stopped_at_near_tie": near_ties, "max_logprob_err": max_lp_err,
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


def flash_flops(kind, q, k, causal, window) -> int:
    """The products of K1 (fwd), K2 (dq) or K3 (dkv) over the live pairs: 2,
    3 or 4 of them, 2 D FLOPs a pair each."""
    b, sq, h, d = q.shape
    return {"fwd": 2, "dq": 3, "dkv": 4}[kind] * 2 * b * h * d * live_pairs(sq, k.shape[1], causal, window)


def flash_bound(kind, q, k, causal, window):
    """Least time for one call of K1 (fwd), K2 (dq) or K3 (dkv): every input
    read once and every output written once over the HBM rate, against the
    products over the live pairs at the peak rate of the input type."""
    b, sq, h, d = q.shape
    elt = q.element_size()
    qo, kv, rows = q.numel() * elt, k.numel() * elt, b * h * sq * 4
    nbytes = {
        "fwd": qo + 2 * kv + qo + rows,  # q, k, v -> out, lse
        "dq": 2 * qo + 2 * kv + 2 * rows + q.numel() * 4,  # q, dO, k, v, lse, delta -> dq f32
        "dkv": 2 * qo + 2 * kv + 2 * rows + 2 * k.numel() * 4,  # -> dk, dv f32
    }[kind]
    flops = flash_flops(kind, q, k, causal, window)
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
    shape (B 8, H 32, H_kv 4, D 64, S 2048, causal, bf16), again in fp16 and
    f32 and at D 128; their times beside the bound, the plain version's and
    scaled_dot_product_attention's (forward; backward, which computes dq,
    dk and dv in one call), with each one's achieved TFLOP/s and share of
    its bound. Tolerances: FLASH_TOL."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    cases = [("bf16", torch.bfloat16, 64, 30), ("fp16", torch.float16, 64, 30), ("f32", torch.float32, 64, 5),
             ("bf16-d128", torch.bfloat16, 128, 30)]
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
            ms = time_ms(torch, kernels[kind], reps=reps, flush=flush)
            row[kind] = {
                "max_abs_err": errs[kind][0], "err_over_tol": errs[kind][1], "ms": ms,
                "plain_ms": time_ms(torch, plains[kind], reps=min(reps, 5), warmup=1, flush=flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flash_flops(kind, q, k, True, None) / (ms * 1e-3) / 1e12, "share_of_bound": bound_ms / ms,
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


def phase_flash_launch(torch):
    """K1-K3's launches for every dtype x D, three ways: what the C launcher
    reports (its ``*_config`` entry, the arithmetic it launches with), what
    ``fwd_launch`` / ``bwd_launch`` say, and the grid and threads
    ``kernel_check`` records on meta tensors for a forward and backward; all
    must agree. The shared memory each asks for fits an H100 block."""
    from accelerate_tpu_torch.analysis import kernel_check
    from accelerate_tpu_torch.kernels import build
    from accelerate_tpu_torch.ops import flash_attention as fa

    def fwd_bwd(q, k, v):
        q.requires_grad_(True)
        out = fa.flash_attention(q, k, v, causal=True)
        out.float().sum().backward()
        return out

    b, s, h, h_kv = 8, 2048, 32, 4
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    rows = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (64, 128):
            code = fa._DTYPE_CODES[dtype]
            meta = [torch.empty(shape, dtype=dtype, device="meta") for shape in ((b, s, h, d), (b, s, h_kv, d))]
            sites = {site.kernel_name: {"grid": tuple(site.grid), "threads": site.threads}
                     for site in kernel_check(fwd_bwd, meta[0], meta[1], meta[1], probe=False).sites}
            launches = {"fwd": (fa.fwd_launch(dtype, b, h, s, d), (code, b, h, s, d))}
            for kind in ("dq", "dkv"):
                launches[kind] = (fa.bwd_launch(kind, dtype, b, h, h_kv, s, s, d), (code, b, h, h_kv, s, s, d))
            for kind, (launch, args) in launches.items():
                built = build.launch_config(launch.library, launch.entry, *args)
                recorded = sites[f"flash_attention_{kind}"]
                check(built == {"grid": launch.grid, "threads": launch.threads, "smem_bytes": launch.smem_bytes}
                      and recorded == {"grid": launch.grid, "threads": launch.threads}
                      and launch.smem_bytes <= optin,
                      f"{kind} {dtype_name(dtype)} D{d}: launcher {built}, python {launch}, recorded {recorded}")
                rows.append({"kernel": kind, "dtype": dtype_name(dtype), "d": d, "library": launch.library, **built})
    emit({"phase": "flash_launch", "shape": [b, s, h, h_kv], "smem_per_block_optin": optin, "cases": rows})


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


def device_time(events) -> tuple[float, dict]:
    """Device busy ms (the union of the traced kernels' intervals) and
    ``{kernel name: (ms, count)}``."""
    by_name: dict = {}
    spans = []
    for ev in events:
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
        spans.append((ev.time_range.start, ev.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3, by_name


def phase_train_profile(torch, step, batches):
    """One more train step under torch.profiler (``traced``): device busy
    time (the union of the traced kernels' intervals; user annotations
    left out), idle share against the traced step's wall time, and where the
    device time goes. The step's wall time without the profiler is given
    beside it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step({"input_ids": batches[0]})
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    events, wall_ms, attempts, lost = traced(torch, lambda: step({"input_ids": batches[1]}))
    busy, by_name = device_time(events)

    def share(pred):
        return sum(ms for name, (ms, _) in by_name.items() if pred(name.lower()))

    names = {"fwd": ("flash_fwd_wgmma<", "flash_fwd_f32<"), "dq": ("flash_dq_wgmma<", "flash_dq_f32<"),
             "dkv": ("flash_dkv_wgmma<", "flash_dkv_f32<")}
    flash = {k: share(lambda nm, k=k: any(n in nm for n in names[k])) for k in names}
    gemm = share(lambda nm: any(t in nm for t in ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    row = {
        "phase": "train_profile", "what": "one train step, TinyLlama shape, batch 8 x 2048, bf16 compute, remat",
        "step_wall_ms": wall_ms, "step_wall_ms_unprofiled": plain_wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if busy else None,
        "flash_ms": flash, "flash_share": sum(flash.values()) / busy if busy else None,
        "gemm_ms": gemm, "gemm_share": gemm / busy if busy else None,
        "kernels_traced": sum(n for _, n in by_name.values()), "trace_attempts": attempts, "trace_lead_lost": lost,
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


# ---------------------------------------------------------------------------
# quantized decode slice: the fused int4 kernel (K5), the reference kernels
# (K6, K7), and the int4 model served and decoded
# ---------------------------------------------------------------------------

# K5 against its plain version: each element within t (|ref| + RMS(ref)). Both
# sum exact products in f32 in another order, and the kernel's sums run on the
# tensor cores; in bf16 and fp16 the results may round to neighbouring values
# of the type. Each limit is a few times the largest error read on the card
# over int4_kernel's and int4_sweep's cases (their err_over_tol; PERF.md).
INT4_TOL = {"float32": 2e-5, "bfloat16": 8e-3, "float16": 2e-3}
INT4_SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))  # (in, out) of TinyLlama's projections
INT4_MAIN_CASE = "2048x5632 M8"  # gate/up projection at the decode tick's batch: the kernels line's K5 row


# google-research/bert's BERT-Base uncased (Devlin et al. 2018; Hugging Face bert-base-uncased config.json)
BERT_BASE = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
    max_position_embeddings=512, type_vocab_size=2,
)


def bert_example():
    """examples/torch_nlp_example.py of this checkout, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "torch_nlp_example.py"
    spec = importlib.util.spec_from_file_location("torch_nlp_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bert_accelerator(torch, mixed_precision, cpu=False):
    """A fresh Accelerator; bf16 takes bench.py's policy, the softmax in bf16."""
    from accelerate_tpu_torch import Accelerator, MixedPrecisionPolicy
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    handlers = [MixedPrecisionPolicy(softmax_dtype="bfloat16")] if mixed_precision == "bf16" else None
    return Accelerator(mixed_precision=mixed_precision, kwargs_handlers=handlers, cpu=cpu)


def bert_step_flops(module, tokens: int) -> float:
    """bench.py's _bert_step_flops: 6 x non-embedding params x tokens."""
    return 6.0 * sum(p.numel() for name, p in module.named_parameters() if "embed" not in name) * tokens


def phase_bert_finetune(torch):
    """examples/torch_nlp_example.py's loop on the card: BERT-base at full
    width and depth (seeded random weights), f32 masters and bf16 compute
    with the softmax in bf16, AdamW(2e-5, weight decay 0.01) decaying
    linearly, SyntheticMRPC(n=3668) at seq 128 through prepare_data_loader
    (batch 32, shuffled, seed 42): one epoch of 115 steps, the last batch
    20 real rows wrapped round to 32. Then the example's eval pass, whose
    gather_for_metrics must give back exactly 3668 predictions. The host
    time the loader takes to hand over each batch is read around each
    ``next``; three more steps on the epoch's last batches run under
    torch.profiler (``traced``) for the device's idle share."""
    from accelerate_tpu_torch import BertConfig, bert_classification_loss, create_bert_model, prepare_data_loader

    example = bert_example()
    seq, batch_size, n = 128, 32, 3668
    free_memory(torch)  # earlier phases' models sit in reference cycles: out of this phase's peak
    acc = bert_accelerator(torch, "bf16")
    cfg = BertConfig.base()
    dataset = example.SyntheticMRPC(n=n, seq_len=seq, vocab_size=cfg.vocab_size)
    model = create_bert_model(cfg, seq_len=seq)
    optimizer = torch.optim.AdamW(model.module.parameters(), lr=2e-5, weight_decay=0.01)
    total_steps = len(dataset) // batch_size
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: max(0.0, 1.0 - s / total_steps))
    loader = prepare_data_loader(dataset, batch_size=batch_size, shuffle=True, seed=42)
    model, optimizer, loader, schedule = acc.prepare(model, optimizer, loader, schedule)
    step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
    eval_step = acc.build_eval_step(lambda p, ids, mask: model.apply_fn(p, ids, mask))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    losses, fetch_ms, on_card, ends, last_batches = [], [], True, [], []
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        f0 = time.perf_counter()
        batch = next(it, None)
        fetch_ms.append((time.perf_counter() - f0) * 1e3)
        if batch is None:
            break
        on_card &= all(t.is_cuda for t in batch.values())
        ends.append(acc.gradient_state.end_of_dataloader)
        losses.append(step(batch))
        last_batches = (last_batches + [batch])[-3:]
    losses = [float(x) for x in losses]  # waits for the card
    train_s = time.perf_counter() - t0
    n_steps = len(losses)
    t0 = time.perf_counter()
    correct, total = example.evaluate(acc, eval_step, loader)
    eval_s = time.perf_counter() - t0
    events, wall_ms, attempts, lost = traced(torch, lambda: [step(batch) for batch in last_batches])
    busy, _ = device_time(events)
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(all(np.isfinite(losses)), f"bert_finetune losses finite: {losses}")
    check(last < first, f"bert_finetune: mean of the last ten losses {last} < the first ten's {first}")
    check(n_steps == 115 and ends == [False] * 114 + [True],
          f"end_of_dataloader on the last of {n_steps} batches only")
    check(total == n, f"gather_for_metrics gave {total} predictions for {n} rows")
    check(on_card, "every batch arrived as CUDA tensors")
    row = {
        "phase": "bert_finetune", "config": "bert-base-uncased shape, seeded random weights, f32 masters + bf16 "
        "compute, bf16 softmax", "params": model.num_parameters(), "batch": batch_size, "seq": seq, "rows": n,
        "steps": n_steps, "samples_per_s": n_steps * batch_size / train_s, "train_s": train_s, "eval_s": eval_s,
        "accuracy": correct / total, "predictions": total, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        # the first fetch fills the window (three batches); the last finds the loader done
        "loader_host_ms_per_batch": statistics.mean(fetch_ms[1:-1]), "loader_host_ms_first": fetch_ms[0],
        "loss_first10": first, "loss_last10": last, "losses": losses[:3] + losses[-3:],
        "traced_steps": 3, "traced_wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if busy else None, "trace_attempts": attempts, "trace_lead_lost": lost,
    }
    emit(row)
    del acc, model, optimizer, loader, step, eval_step, last_batches
    free_memory(torch)
    return row


def phase_bert_bench(torch):
    """bench.py::run_bench's configuration on the port: BERT-base, batch 256
    x seq 128, f32 masters and bf16 compute with the softmax in bf16,
    AdamW(2e-5, weight decay 0.01), one fixed batch from
    np.random.default_rng(0); 2 + 3 warm-up steps, then 20 steps, each
    fenced by a synchronize (as bench.py's StepTelemetry fences each
    call). Three more steps run under torch.profiler (``traced``) for the
    device's busy time and idle share, and where the device time goes."""
    from accelerate_tpu_torch import BertConfig, bert_classification_loss, create_bert_model, send_to_device

    b, seq, warmup, timed = 256, 128, 5, 20
    free_memory(torch)
    acc = bert_accelerator(torch, "bf16")
    model = acc.prepare_model(create_bert_model(BertConfig.base(), seq_len=seq))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=2e-5, weight_decay=0.01))
    step = acc.build_train_step(lambda p, bt: bert_classification_loss(p, bt, model.apply_fn))
    rng = np.random.default_rng(0)
    batch = send_to_device({
        "input_ids": rng.integers(5, 30000, size=(b, seq)).astype(np.int32),
        "attention_mask": np.ones((b, seq), np.bool_),
        "labels": rng.integers(0, 2, size=(b,)).astype(np.int32),
    }, acc.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"bert_bench losses finite: {losses}")
    step_ms = sorted(times[warmup:])
    med = statistics.median(step_ms)
    flops = bert_step_flops(model.module, b * seq)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events, wall_ms, attempts, lost = traced(torch, lambda: [step(batch) for _ in range(3)])
    busy, by_name = device_time(events)

    def share(pred):
        return sum(ms for name, (ms, _) in by_name.items() if pred(name.lower()))

    gemm = share(lambda nm: any(t in nm for t in ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    row = {
        "phase": "bert_bench", "config": "bench.py run_bench on the port: bert-base-uncased shape, seeded random "
        "weights, f32 masters + bf16 compute, bf16 softmax", "params": model.num_parameters(), "batch": b, "seq": seq,
        "warmup_steps": warmup, "timed_steps": timed, "samples_per_s": b * timed / (sum(step_ms) / 1e3),
        "step_ms_median": med, "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1],
        "step_flops": flops, "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak_gb,
        "traced_steps": 3, "traced_wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if busy else None, "gemm_ms": gemm,
        "gemm_share": gemm / busy if busy else None, "kernels_traced": sum(n for _, n in by_name.values()),
        "trace_attempts": attempts, "trace_lead_lost": lost, "losses": losses,
        "top": [[name[:200], ms, n] for name, (ms, n) in top],
    }
    emit(row)
    del acc, model, step, batch
    free_memory(torch)
    return row


def phase_bert_consistency(torch):
    """Two layers at BERT-base width, f32, three steps through the loader on
    the card and the same three on the CPU from the same weights: losses
    within 1e-4 relative, every final parameter within 1e-4 of its CPU
    value relative to the larger of the tensor's RMS and 1e-3 (the key
    biases start at zero and stay near it: their gradient is zero in exact
    arithmetic, a bias on every key adding the same logit across a row).
    The padding mask has zero columns
    (keys 100-127 of every row) and one fully masked row, so the masked
    fill runs on the card. SGD, so a parameter moves with its gradient:
    Adam's first steps move every element by about lr whatever its
    gradient's size, so a gradient at rounding level could step either
    way on either device."""
    from accelerate_tpu_torch import BertConfig, bert_classification_loss, create_bert_model, prepare_data_loader

    cfg = BertConfig(**{**BERT_BASE, "num_hidden_layers": 2})
    rng = np.random.default_rng(7)
    n, seq = 24, 128
    ids = rng.integers(5, cfg.vocab_size, size=(n, seq)).astype(np.int32)
    mask = np.ones((n, seq), np.bool_)
    mask[:, 100:] = False
    mask[5] = False
    labels = rng.integers(0, 2, size=(n,)).astype(np.int32)
    rows = [{"input_ids": ids[i], "attention_mask": mask[i], "labels": labels[i]} for i in range(n)]
    runs = {}
    for device in ("cuda", "cpu"):
        acc = bert_accelerator(torch, "no", cpu=device == "cpu")
        model = create_bert_model(cfg, seed=3, device="cpu")  # one generator, one set of weights; prepare moves them
        opt = torch.optim.SGD(model.module.parameters(), lr=1e-2)
        loader = prepare_data_loader(rows, batch_size=8, shuffle=True, seed=1)
        model, opt, loader = acc.prepare(model, opt, loader)
        step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
        losses = [float(step(b)) for b in loader]
        runs[device] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()})
        del acc, model, opt, loader, step
    (gpu_losses, gpu_params), (cpu_losses, cpu_params) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    param_err = max(float((gpu_params[k] - v).abs().max() / v.pow(2).mean().sqrt().clamp_min(1e-3))
                    for k, v in cpu_params.items())
    check(len(gpu_losses) == 3 and all(np.isfinite(gpu_losses)), f"bert_consistency: three finite losses {gpu_losses}")
    check(loss_err <= 1e-4, f"bert_consistency: card vs CPU loss rel err {loss_err} <= 1e-4")
    check(param_err <= 1e-4, f"bert_consistency: card vs CPU final params err / RMS {param_err} <= 1e-4")
    row = {"phase": "bert_consistency", "config": "bert-base widths, 2 layers, f32, batch 8 x 128, 3 SGD steps",
           "losses_cuda": gpu_losses, "losses_cpu": cpu_losses, "loss_rel_err": loss_err,
           "param_err_over_rms": param_err}
    emit(row)
    free_memory(torch)
    return row


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def int4_weight(torch, gen, k, n, g):
    """A seeded N(0, 1/k) weight quantized to int4 with groups of ``g``:
    ``(packed, scale, the decoded weight in bf16)``."""
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, dequantize, quantize

    w = torch.randn(k, n, generator=gen, device="cuda") / k**0.5
    qt = quantize(w, QuantizationConfig(method="int4", group_size=g))
    return qt.data, qt.scale, dequantize(qt, torch.bfloat16)


def int4_bound(x, packed, scale):
    """Least time for one call: x, the codes and the scales read once and the
    output written once over the HBM rate, against 2 M in out operations at
    the tensor cores' bf16 rate."""
    m, n = x.shape[0], packed.shape[-1]
    nbytes = x.numel() * x.element_size() + packed.numel() + scale.numel() * 4 + m * n * x.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * x.shape[1] * n / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int4_compare(torch, qm, x, packed, scale, g):
    """``(max abs error, max error over its tolerance)`` of K5 against its
    plain version on these inputs; two calls must agree bit for bit."""
    got, again = qm.int4_matmul(x, packed, scale, group_size=g), qm.int4_matmul(x, packed, scale, group_size=g)
    torch.cuda.synchronize()
    check(got.dtype == x.dtype and bool(torch.isfinite(got).all()), "int4 kernel output finite, in x's type")
    check(torch.equal(got, again), "int4 kernel: two calls on the same inputs bit-equal")  # splits joined in order
    want = qm.int4_matmul_plain(x, packed, scale, group_size=g)
    return flash_err(torch, got, want, INT4_TOL[dtype_name(x.dtype)])


def int4pack_library(torch, qm, x, packed, scale, g):
    """PyTorch's own int4 weight-only product as K5's yardstick (timed here,
    never called by the port): ``torch.ops.aten._weight_int4pack_mm``
    computes, per group of ``g``, ``x @ ((code - 8) * scale + zero)``; with
    zero 0 that is K5's function with the scale rounded to bf16. The codes go
    through ``_convert_weight_to_int4pack`` as ``[N, K/2]`` bytes; which
    nibble of a byte holds the even contraction row is not assumed: both
    orders are tried and the one that agrees with K5's plain version kept.
    Returns ``(call or None, {"library_max_abs_err", "nibble_order"} or
    {"library_error"})``."""
    k, n = x.shape[1], packed.shape[-1]
    rows = packed.reshape(k // 2, n)  # byte row r: code 2r low, 2r + 1 high
    lo, hi = (rows & 0x0F), (rows >> 4)
    sz = torch.stack([scale[:, 0, :].to(torch.bfloat16), torch.zeros_like(scale[:, 0, :], dtype=torch.bfloat16)],
                     dim=-1).contiguous()  # [K/g, N, 2]: scale, zero
    want = qm.int4_matmul_plain(x, packed, scale, group_size=g).float()
    best, errors = None, {}
    try:
        for order, byte in (("even_high", (lo << 4) | hi), ("even_low", rows)):
            w = torch.ops.aten._convert_weight_to_int4pack(byte.t().contiguous(), 8)

            def call(w=w):
                return torch.ops.aten._weight_int4pack_mm(x, w, g, sz)

            err = (call().float() - want).abs().max().item()
            errors[order] = err
            if best is None or err < errors[best[0]]:
                best = (order, call)
    except Exception as exc:  # the op refused on this card: the row keeps null
        return None, {"library_error": f"{type(exc).__name__}: {exc}"[:300]}
    order, call = best
    if errors[order] > 0.05 * want.abs().max().item():
        return None, {"library_error": f"no nibble order agrees with the plain version: {errors}"}
    return call, {"library_max_abs_err": errors[order], "nibble_order": order, "library_err_by_order": errors}


def phase_int4_kernel(torch):
    """K5 against its plain version at TinyLlama's four projection shapes x
    M in {1, 8, 64, 256} (generate's and the tick's batches, the prefill
    windows), x in bf16, fp16 and f32, groups of 128 and 64 (INT4_TOL). In
    bf16 at group 128, the slice's configuration, its time (CUDA events, L2
    flushed) beside its bound, its plain version's time, the one PyTorch call
    that computes the same function (``_weight_int4pack_mm``, see
    ``int4pack_library``) and torch.matmul against the weight decoded to
    bf16 beforehand, which reads four times the bytes."""
    from accelerate_tpu_torch.ops import qmatmul as qm

    gen = torch.Generator(device="cuda").manual_seed(17)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    results = {}
    for k, n in INT4_SHAPES:
        row = {"phase": "int4_kernel", "shape": [k, n], "group_size": 128, "timed_dtype": "bfloat16", "cases": {}}
        worst = 0.0
        for g in (128, 64):
            packed, scale, w_bf16 = int4_weight(torch, gen, k, n, g)
            for m in (1, 8, 64, 256):
                for dtype in (torch.bfloat16, torch.float16, torch.float32):
                    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                    err, over = int4_compare(torch, qm, x, packed, scale, g)
                    check(over <= 1.0, f"int4 kernel vs plain {k}x{n} M{m} g{g} {dtype}: {over} x its tolerance")
                    worst = max(worst, over)
                    if g != 128 or dtype != torch.bfloat16:
                        continue
                    bound_ms, bound_by = int4_bound(x, packed, scale)
                    dense_err = (torch.matmul(x, w_bf16).float()
                                 - qm.int4_matmul_plain(x, packed, scale, group_size=g).float()).abs().max().item()
                    library, lib_info = int4pack_library(torch, qm, x, packed, scale, g)
                    case = {
                        "max_abs_err": err, "err_over_tol": over,
                        "ms": time_ms(torch, lambda: qm.int4_matmul(x, packed, scale, group_size=g), flush=flush),
                        "plain_ms": time_ms(torch, lambda: qm.int4_matmul_plain(x, packed, scale, group_size=g),
                                            reps=5, warmup=1, flush=flush),
                        "library_ms": time_ms(torch, library, flush=flush) if library else None,
                        "library": "torch.ops.aten._weight_int4pack_mm (zero 0, scale in bf16)", **lib_info,
                        "dense_ms": time_ms(torch, lambda: torch.matmul(x, w_bf16), flush=flush),
                        "dense": "torch.matmul on the weight decoded to bf16 beforehand (4x the bytes)",
                        "dense_max_abs_err": dense_err, "bound_ms": bound_ms, "bound_by": bound_by,
                        "plan": qm._split_plan(m, k // g, n)._asdict(),
                    }
                    row["cases"][f"M{m}"] = case
                    results[f"{k}x{n} M{m}"] = case
            del packed, scale, w_bf16
        row["worst_err_over_tol"] = worst
        emit(row)
    return results


def phase_int4_sweep(torch):
    """K5 against its plain version over the shapes it takes: odd batches,
    out of 128 and 384, in equal to one group, groups of 64 to 512, every
    dtype; the arguments it refuses; and QuantDense's four methods on the
    card against the same layer on the CPU (1e-4 of the largest output: f32
    sums in another order; w8a8's integer product is exact)."""
    import itertools

    from accelerate_tpu_torch.ops import qmatmul as qm
    from accelerate_tpu_torch.ops.qdense import QuantDense
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize

    gen = torch.Generator(device="cuda").manual_seed(19)
    worst, n_cases = 0.0, 0
    for dtype, g, m, n, groups in itertools.product(
        (torch.float32, torch.bfloat16, torch.float16), (64, 128, 256, 512), (3, 17, 100), (128, 384), (1, 3)
    ):
        packed, scale, _ = int4_weight(torch, gen, groups * g, n, g)
        x = torch.randn(m, groups * g, generator=gen, device="cuda").to(dtype)
        _, over = int4_compare(torch, qm, x, packed, scale, g)
        check(over <= 1.0, f"int4 sweep M{m} in{groups * g} out{n} g{g} {dtype}: {over} x its tolerance")
        worst, n_cases = max(worst, over), n_cases + 1

    packed, scale, _ = int4_weight(torch, gen, 256, 256, 64)
    x = torch.randn(4, 256, generator=gen, device="cuda").to(torch.bfloat16)
    before = qm.launches
    refused = [
        (ValueError, lambda: qm.int4_matmul(x, packed, scale, group_size=128)),  # packed inconsistent with g
        (ValueError, lambda: qm.int4_matmul(x[:, :128], packed, scale, group_size=64)),  # in != groups x g
        (ValueError, lambda: qm.int4_matmul(x, *int4_weight(torch, gen, 256, 256, 32)[:2], group_size=32)),  # g % 64
        (ValueError, lambda: qm.int4_matmul(x, packed[:, :, :192].contiguous(), scale[:, :, :192].contiguous(),
                                            group_size=64)),  # out % 128
        (ValueError, lambda: qm.int4_matmul(x.T.contiguous().T, packed, scale, group_size=64)),  # not contiguous
        (ValueError, lambda: qm.int4_matmul(x, packed.cpu(), scale, group_size=64)),  # devices differ
        (TypeError, lambda: qm.int4_matmul(x, packed.to(torch.int8), scale, group_size=64)),
        (TypeError, lambda: qm.int4_matmul(x, packed, scale.to(torch.bfloat16), group_size=64)),
        (TypeError, lambda: qm.int4_matmul(x.to(torch.float64), packed, scale, group_size=64)),
    ]
    for exc, call in refused:
        try:
            call()
        except exc:
            continue
        raise RuntimeError("check failed: int4_matmul accepted arguments it must refuse")
    check(qm.launches == before, "a refused call launches nothing")

    dense_err = {}
    for method, g in (("int8", None), ("int8", 64), ("w8a8", None), ("int4", 64), ("int4", 32), ("nf4", 64)):
        w = torch.randn(256, 384, generator=gen, device="cuda") / 16.0
        qt = quantize(w, QuantizationConfig(method=method, group_size=g, bits=8 if method in ("int8", "w8a8") else 4))
        layer = QuantDense(256, 384, method=method, group_size=g)
        layer.load_state_dict({"qdata": qt.data.cpu(), "qscale": qt.scale.cpu()})
        x = torch.randn(5, 256, generator=gen, device="cuda")
        before = qm.launches
        with torch.no_grad():
            want = layer(x.cpu())
            got = layer.cuda()(x)
        check(qm.launches == before + (1 if (method, g) == ("int4", 64) else 0), f"QuantDense {method} g{g} dispatch")
        # the kernel rounds x to bf16, the CPU's dequantize path does not
        tol = 1e-2 if (method, g) == ("int4", 64) else 1e-4
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        check(err <= tol, f"QuantDense {method} g{g} on the card vs the CPU: {err} <= {tol}")
        dense_err[f"{method}-g{g}"] = err
    emit({"phase": "int4_sweep", "cases": n_cases, "worst_err_over_tol": worst, "refused_calls": len(refused),
          "qdense_card_vs_cpu_rel_err": dense_err})


def phase_int4_host_cost(torch):
    """What one projection costs the host at the decode tick's batch (M 8,
    2048 -> 2048, bf16 stream): seconds to enqueue 2000 calls back to back,
    a call, for an int4 QuantDense (K5's wrapper: its checks, two
    allocations, the stream lookup, one ctypes call, two launches) beside an
    nn.Linear; ``total_us`` ends in a synchronize, so it is the larger of
    the host's and the card's time a call. The decode tick is bound by the
    host, so this is what the int4 model's tokens/s follows."""
    from torch import nn

    from accelerate_tpu_torch.ops.qdense import QuantDense
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize

    gen = torch.Generator(device="cuda").manual_seed(29)
    k = n = 2048
    qt = quantize(torch.randn(k, n, generator=gen, device="cuda") / k**0.5, QuantizationConfig(method="int4", group_size=128))
    layer = QuantDense(k, n, method="int4", group_size=128).cuda()
    layer.load_state_dict({"qdata": qt.data, "qscale": qt.scale})
    linear = nn.Linear(k, n, bias=False, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(8, 1, k, generator=gen, device="cuda").to(torch.bfloat16)

    def per_call(fn, calls=2000):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return {"host_us": (t1 - t0) / calls * 1e6, "total_us": (time.perf_counter() - t0) / calls * 1e6}

    with torch.no_grad():
        row = {
            "phase": "int4_host_cost", "shape": [8, k, n], "calls": 2000,
            "quant_dense_int4": per_call(lambda: layer(x)), "nn_linear_bf16": per_call(lambda: linear(x)),
            "torch_empty": per_call(lambda: torch.empty((8, n), dtype=torch.bfloat16, device="cuda")),
            "current_stream": per_call(lambda: torch.cuda.current_stream(x.device).cuda_stream),
        }
    emit(row)
    return row


# K6 is held per element to SOFTMAX_TOL (|ref| + RMS(ref)) of its plain version: f32 sums in another order
SOFTMAX_TOL = 1e-4


def spec_bound(spec, *operands):
    """Least time by a registered cost contract: its declared HBM bytes over
    the memory rate against its declared FLOPs at the peak rate of the
    operands' type."""
    t_bytes = spec.hbm_bytes(*operands) / HBM_BYTES_PER_S * 1e3
    t_ops = spec.flops(*operands) / PEAK_FLOPS[dtype_name(operands[0].dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_reference_kernels(torch):
    """K6 (softmax(x @ w)) and K7 (acc += delta) through their public
    wrappers, the counts read around that drive; then each against its plain
    version. K6 at the selfcheck shape (8, 128) @ (128, 256), at the
    decode-logits shape (8, 2048) @ (2048, 32000) in f32 and bf16, and at
    the ragged (16, 300) @ (300, 1500) bf16 (rows of 600 and 3,000 bytes:
    the ring's 8-byte copies) and (8, 2048) @ (2048, 1000) bf16 (8 tiles:
    the contraction in 8 splits, joined by ticket): every probability within SOFTMAX_TOL
    (|ref| + RMS(ref)) (f32 sums in another order), rows summing to 1
    within 1e-5, two calls bit-equal. K7 at [8, 256] and [4096, 4096], f32
    and bf16, and [8, 1001] bf16: equal bit for bit to ``acc.add_(delta)``
    (one f32 add, one rounding, as torch's add), two calls alike. Times
    (CUDA events, L2 flushed) beside the bound from each kernel's
    registered cost contract, the bound with every input read once and the
    output written once, the plain version's time and one library call's
    (F.softmax(x @ w) is two; acc.add_(delta)); beside the 16-bit K6 cases
    the product ``x @ w`` alone, the floor a fused kernel competes with."""
    from accelerate_tpu_torch.kernels import reference as ref
    from accelerate_tpu_torch.kernels.contracts import registered_spec

    gen = torch.Generator(device="cuda").manual_seed(23)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    soft_spec, acc_spec = registered_spec("block_matmul_softmax"), registered_spec("block_accumulate")
    check(soft_spec.flops(torch.empty(8, 128), torch.empty(128, 256)) == 552_960,
          "the registered K6 contract declares 552,960 FLOPs at the selfcheck shape")

    def operands(shape_x, shape_w, dtype):
        x = torch.randn(*shape_x, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(*shape_w, generator=gen, device="cuda") / shape_w[0] ** 0.5).to(dtype)
        return x, w

    # the drive: a user's calls, counted
    ref.launches_matmul_softmax = ref.launches_accumulate = 0
    x, w = operands((8, 2048), (2048, 32000), torch.bfloat16)
    acc = torch.zeros(8, 32000, device="cuda")
    for _ in range(4):
        probs = ref.block_matmul_softmax(x, w)
        ref.block_accumulate(acc, probs)
    torch.cuda.synchronize()
    launches = {"matmul_softmax": ref.launches_matmul_softmax, "accumulate": ref.launches_accumulate}
    check(launches == {"matmul_softmax": 4, "accumulate": 4}, f"reference kernels launched once a call: {launches}")
    check(bool(torch.isfinite(acc).all()) and float((acc.sum(-1) - 4.0).abs().max()) < 1e-4,
          "four accumulated softmaxes sum to 4 a row")

    rows = {"phase": "reference_kernels", "launches": launches, "matmul_softmax": {}, "accumulate": {}}
    for name, shape_x, shape_w, dtype in (
        ("selfcheck-f32", (8, 128), (128, 256), torch.float32),
        ("logits-f32", (8, 2048), (2048, 32000), torch.float32),
        ("logits-bf16", (8, 2048), (2048, 32000), torch.bfloat16),
        ("ragged-bf16", (16, 300), (300, 1500), torch.bfloat16),
        ("split-bf16", (8, 2048), (2048, 1000), torch.bfloat16),
    ):
        x, w = operands(shape_x, shape_w, dtype)
        got, again, want = ref.block_matmul_softmax(x, w), ref.block_matmul_softmax(x, w), ref.block_matmul_softmax_plain(x, w)
        torch.cuda.synchronize()
        err, over = flash_err(torch, got, want, SOFTMAX_TOL)
        check(over <= 1.0, f"K6 vs plain ({name}): {over} x its tolerance")
        check(float((got.sum(-1) - 1.0).abs().max()) < 1e-5 and float(got.min()) >= 0.0, f"K6 rows sum to 1 ({name})")
        check(torch.equal(got, again), f"K6 two calls bit-equal ({name})")
        bound_ms, bound_by = spec_bound(soft_spec, x, w)
        # every input read once, the output written once, against the contract's operations
        t_bytes = (x.numel() * x.element_size() + w.numel() * w.element_size() + got.numel() * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = soft_spec.flops(x, w) / PEAK_FLOPS[dtype_name(dtype)] * 1e3
        rows["matmul_softmax"][name] = {
            "max_abs_err": err, "err_over_tol": over, "plan": list(ref._softmax_plan(x, w)),
            "copy_bytes": ref._softmax_copy_bytes(x, w),
            "ms": time_ms(torch, lambda: ref.block_matmul_softmax(x, w), flush=flush),
            "plain_ms": time_ms(torch, lambda: ref.block_matmul_softmax_plain(x, w), flush=flush),
            "library_ms": time_ms(torch, lambda: torch.softmax(x.float() @ w.float(), dim=-1), flush=flush),
            "matmul_ms": time_ms(torch, lambda: x @ w, flush=flush) if dtype != torch.float32 else None,
            "spec_bound_ms": bound_ms, "spec_bound_by": bound_by, "spec_flops": soft_spec.flops(x, w),
            "spec_hbm_bytes": soft_spec.hbm_bytes(x, w), "spec_smem_bytes": soft_spec.smem_bytes(x, w),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    for name, shape, dtype in (("small-f32", (8, 256), torch.float32), ("small-bf16", (8, 256), torch.bfloat16),
                               ("4096-f32", (4096, 4096), torch.float32), ("4096-bf16", (4096, 4096), torch.bfloat16),
                               ("ragged-bf16", (8, 1001), torch.bfloat16)):
        acc = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        delta = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        want = ref.block_accumulate_plain(acc.clone(), delta)
        again = acc.clone()
        got = ref.block_accumulate(acc, delta)
        ref.block_accumulate(again, delta)
        torch.cuda.synchronize()
        check(got is acc and torch.equal(acc, want), f"K7 in place and equal to acc.add_(delta) ({name})")
        check(torch.equal(again, acc), f"K7 two calls alike ({name})")
        err = float((acc.float() - want.float()).abs().max())
        bound_ms, bound_by = spec_bound(acc_spec, acc, delta)  # the contract's bytes are the least: 2 reads, 1 write
        rows["accumulate"][name] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ref.block_accumulate(acc, delta), flush=flush),
            "plain_ms": time_ms(torch, lambda: ref.block_accumulate_plain(acc, delta), flush=flush),
            "library_ms": time_ms(torch, lambda: acc.add_(delta), flush=flush),
            "spec_bound_ms": bound_ms, "spec_bound_by": bound_by, "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit(rows)
    return rows


def quantize_for_serving(torch, model):
    """The bf16 model's projections quantized to int4 (group 128) by
    load_and_quantize_model: ``(quantized model, seconds it took, bytes of
    the bf16 parameters)``. The embedding, norms and LM head are shared."""
    from accelerate_tpu_torch import QuantizationConfig, load_and_quantize_model
    from accelerate_tpu_torch.ops.qdense import QuantDense
    from accelerate_tpu_torch.utils.quantization import quantized_bytes

    t0 = time.perf_counter()
    qmodel = load_and_quantize_model(model, QuantizationConfig(method="int4", group_size=128))
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check(sum(isinstance(mod, QuantDense) for mod in qmodel.module.modules()) == 7 * qmodel.config.num_hidden_layers,
          "every projection is a QuantDense")
    return qmodel, quantize_s, quantized_bytes(model.params)


def phase_quant_serve(torch, qmodel, serve, quantize_s, bf16_bytes):
    """The serve phase's engine and prompts on the int4 model (the bf16
    model freed beforehand, so the peak memory is the int4 model's own): K5
    launches == 154 x the forwards the engine ran, K4 == 22 x decode steps;
    beside the bf16 serve phase's numbers from this run."""
    from accelerate_tpu_torch.utils.quantization import quantized_bytes

    row = serve_run(torch, qmodel, "quant_serve", "TinyLlama-1.1B shape, int4 g128 projections, bf16 stream")
    row.update({
        "quantize_s": quantize_s, "quantized_bytes": quantized_bytes(qmodel.params), "bf16_parameter_bytes": bf16_bytes,
        "bf16_serve": {k: serve[k] for k in ("tokens_per_s", "ttft_ms_mean", "ttft_ms_p50", "itl_ms_p50",
                                             "peak_memory_gb", "wall_s")},
    })
    emit(row)
    return row


def generate_run(torch, m, name):
    """generate (batch 8, prompt 32, 32 new tokens, greedy) and
    per_token_latency (batch 8, prompt 32) on one model: K5 launches == 154
    x the forwards of an int4 model, none for a float one."""
    from accelerate_tpu_torch import generate, per_token_latency
    from accelerate_tpu_torch.ops import qmatmul

    ids = np.random.default_rng(6).integers(1, m.config.vocab_size, size=(8, 32)).astype(np.int32)
    forwards = [0]
    hook = m.module.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    qmatmul.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(m, ids, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(out.shape) == (8, 64) and bool((out[:, :32].cpu().numpy() == ids).all()), f"generate shape ({name})")
    check(int(out.min()) >= 0 and int(out.max()) < m.config.vocab_size, f"generated ids in the vocabulary ({name})")
    check(forwards[0] == 32, f"generate ran 32 forwards ({name}): {forwards[0]}")
    latency = per_token_latency(m, batch_size=8, prompt_len=32, n_tokens=8)
    hook.remove()
    per_forward = 7 * m.config.num_hidden_layers if m.config.quant_method == "int4" else 0
    check(qmatmul.launches == per_forward * forwards[0],
          f"int4 launches {qmatmul.launches} == {per_forward} x {forwards[0]} forwards ({name})")
    return {"generate_wall_s": wall, "generate_tokens_per_s": 8 * 32 / wall, "per_token_latency_ms": latency * 1e3,
            "forwards": forwards[0], "int4_launches": qmatmul.launches}


def phase_quant_consistency(torch):
    """TinyLlama widths, 2 layers, f32 stream, int4 g128: greedy serving (K5
    + K4) and generate (K5 + the dense cache) against a no-cache greedy loop
    over the same model with each QuantDense replaced by an nn.Linear
    holding the decoded weight. K5 rounds its input to bf16 and the
    reference does not, so a token may differ where the reference's top-2
    logit gap is under 0.05 (that ends the request's comparison), and
    logprobs agree within 0.05: a few times the differences read on the card
    (PERF.md)."""
    from torch import nn

    from accelerate_tpu_torch import (LlamaConfig, QuantizationConfig, ServingEngine, create_llama_model, generate,
                                      load_and_quantize_model)
    from accelerate_tpu_torch.ops import qmatmul
    from accelerate_tpu_torch.ops.qdense import QuantDense
    from accelerate_tpu_torch.utils.quantization import grouped_dequantize

    gap_limit = lp_limit = 0.05
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 2})
    model = create_llama_model(cfg, seed=3, dtype=torch.float32)
    qmodel = load_and_quantize_model(model, QuantizationConfig(method="int4", group_size=128))
    # the reference: the float model with every projection's weight replaced by the decoded one
    for name, mod in qmodel.module.named_modules():
        if isinstance(mod, QuantDense):
            w = grouped_dequantize(mod.qdata, mod.qscale, "int4").reshape(mod.in_features, mod.features)
            linear = model.module.get_submodule(name)
            check(isinstance(linear, nn.Linear), f"{name} is an nn.Linear in the float model")
            linear.weight.data = w.T.contiguous()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (7, 70, 300)]
    n_new = 16
    qmatmul.launches = 0
    eng = ServingEngine(qmodel, num_slots=2, prompt_buckets=(64, 256), paged_block_size=16, tick_block=8)
    uids = [eng.submit(p, n_new) for p in prompts]
    eng.run()
    check(qmatmul.launches == 7 * 2 * (eng.prefill_forwards + eng.decode_steps), "the engine's projections ran K5")
    served = [(p, eng.poll(uid)[len(p):], eng.logprobs(uid)) for uid, p in zip(uids, prompts)]
    compared, near_ties, max_lp_err = greedy_against_reference(torch, model, served, gap_limit)
    check(max_lp_err < lp_limit, f"served logprob vs reference {max_lp_err} < {lp_limit}")

    ids = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    out = generate(qmodel, ids, max_new_tokens=8).cpu().numpy()
    with torch.no_grad():
        lps = torch.log_softmax(model(torch.as_tensor(out[:, :-1], device="cuda").long()).float(), -1)
    gen_lps = lps.gather(-1, torch.as_tensor(out[:, 1:], device="cuda").long()[..., None])[..., 0][:, 15:].cpu().numpy()
    generated = [(ids[i], out[i, 16:], gen_lps[i]) for i in range(2)]
    g_compared, g_ties, _ = greedy_against_reference(torch, model, generated, gap_limit)
    row = {
        "phase": "quant_consistency", "config": "TinyLlama widths, 2 layers, f32 stream, int4 g128",
        "prompts": [len(p) for p in prompts], "tokens_compared": compared, "stopped_at_near_tie": near_ties,
        "max_logprob_err": max_lp_err, "gap_limit": gap_limit, "logprob_limit": lp_limit,
        "generate_tokens_compared": g_compared, "generate_stopped_at_near_tie": g_ties,
    }
    emit(row)
    return row


def bound_of(torch, nbytes: float, flops: float, dtype) -> tuple:
    """``(ms, "bytes" or "operations")``: the larger of the bytes over the
    memory rate and the operations over the type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def meta_llama(torch):
    """The TinyLlama shape with every parameter on ``meta``: what the
    analyzer traces at full width without a byte on the card."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models.llama import LlamaModel

    cfg = LlamaConfig(**TINYLLAMA)
    with torch.device("meta"):
        module = LlamaModel(cfg)
    return Model(module.to(torch.bfloat16), cfg)


def analysis_model_traces(torch, acc):
    """kernel_check over the serving decode step and the training step of the
    TinyLlama shape, traced on meta at full width (no probe: the serve and
    train phases run them): the sites must be the launches those phases
    count, K4 once a layer, K1 twice a layer (remat) and K2, K3 once, each
    unregistered (TPU1005), as the reference's ops kernels are."""
    from accelerate_tpu_torch import causal_lm_loss
    from accelerate_tpu_torch.ops.paged_kv import PagedKVCache

    model = meta_llama(torch)
    layers = model.config.num_hidden_layers

    def decode_step(params, ids, key_pool, value_pool, table, index):
        cache = PagedKVCache(key_pool, value_pool, table, index)
        return model.apply_fn(params, ids, decode=True, cache=cache)[0]

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    pool = meta(layers, 1025, 16, 4, 64, dtype=torch.bfloat16)
    decode = acc.kernel_check(decode_step, model.params, meta(8, 1), pool, pool, meta(8, 128), meta(8), probe=False)
    from accelerate_tpu_torch.ops.paged_attention import _split_plan

    k4_grid = _split_plan(8, 32, 4, 16, 128)[1]  # what the serve phases launch at this shape
    check([(s.kernel_name, s.count, s.grid) for s in decode.sites] == [("paged_decode_attention", layers, k4_grid)],
          f"the decode step's trace lists K4 once a layer: {[(s.kernel_name, s.count) for s in decode.sites]}")

    model.module.train()
    params = {k: v.detach().float().requires_grad_(True) for k, v in model.params.items()}

    def train_step(params, ids):
        loss = causal_lm_loss({k: v.to(torch.bfloat16) for k, v in params.items()}, {"input_ids": ids}, model.apply_fn)
        loss.backward()
        return loss

    train = acc.kernel_check(train_step, params, meta(8, 2048), probe=False)
    got = {s.kernel_name: s.count for s in train.sites}
    want = {"flash_attention_fwd": 2 * layers, "flash_attention_dq": layers, "flash_attention_dkv": layers}
    check(got == want, f"the train step's trace lists K1-K3 as the train phase launches them: {got}")
    for report in (decode, train):
        check({f.rule for f in report.findings} == {"TPU1005"}, "the ops kernels are unregistered (TPU1005) only")
    return {"decode_sites": {s.kernel_name: s.count for s in decode.sites}, "train_sites": got}


def phase_analysis(torch):
    """The kernel-check path (slice 4) on the card. The analyzer's
    shared-memory capacity against the card's own; its selfcheck; then the
    main path, counted: ``Accelerator().kernel_check`` over every K8
    fixture and both clean twins (K6, K7), each probed on the card (the
    hog's launch refused, the rest launched: tile_copy 3, tile_add 1,
    tile_scale 1), and over the TinyLlama decode and train steps traced on
    meta. Then each fixture launched on its own with its outcome asserted
    (the hog refused with its cudaError beside TPU1001's prediction; the
    copies and the scale bit-equal to their plain versions; the gap left
    NaN and the raced tile one of its two sources; the aliased add one of
    its two orderings, and its gap to plain ``a + d`` measured), every
    declared shared-memory occupancy against the built kernel's static
    shared memory plus the dynamic bytes its launch asks for, and the three
    K8 bodies held bit for bit to their plain versions at the fixture
    shapes (the add on a map free of hazards) and timed there (CUDA events,
    L2 flushed) beside their byte bounds, plain versions and one library
    call each."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.analysis import run_kernel_selfcheck
    from accelerate_tpu_torch.analysis.costmodel import device_generation, smem_bytes
    from accelerate_tpu_torch.analysis.kernelmodel import kernel_check, smem_occupancy_bytes
    from accelerate_tpu_torch.analysis.selfcheck import _kernel_clean_fixtures, _kernel_fixtures, drift_contract
    from accelerate_tpu_torch.kernels import build, fixtures
    from accelerate_tpu_torch.kernels.contracts import register_kernel_cost, unregister_kernel_cost

    t0 = time.perf_counter()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    generation = device_generation()
    check(generation == "h100", f"generation=None resolves to h100 on {torch.cuda.get_device_name(0)}: {generation}")
    check(smem_bytes() == optin == smem_bytes("h100") == 232_448,
          f"the capacity read from the card ({smem_bytes()}), the card's per-block opt-in maximum ({optin}) and "
          f"the H100 row a trace without a card is judged against ({smem_bytes('h100')}) agree")
    ok, lines = run_kernel_selfcheck()
    check(ok, "kernel selfcheck on the card:\n" + "\n".join(lines))

    # the main path: a user's kernel_check calls, each probed on the card
    fixture_set, drifty = _kernel_fixtures()
    twins = _kernel_clean_fixtures()
    acc = Accelerator()
    fixtures.launches_copy = fixtures.launches_add = fixtures.launches_scale = 0
    register_kernel_cost(drift_contract(drifty))
    try:
        reports = {rule: acc.kernel_check(fn, *args) for rule, (fn, args) in sorted(fixture_set.items())}
        twin_reports = {}
        for name, rule in (("block_matmul_softmax", "TPU1001"), ("block_accumulate", "TPU1004")):
            fn, args = twins[rule]
            twin_reports[name] = acc.kernel_check(fn, *args)
    finally:
        unregister_kernel_cost(drifty)
    torch.cuda.synchronize()
    launches = {"tile_copy": fixtures.launches_copy, "tile_add": fixtures.launches_add,
                "tile_scale": fixtures.launches_scale}
    check(launches == {"tile_copy": 3, "tile_add": 1, "tile_scale": 1}, f"K8 launches on the main path: {launches}")
    traces = analysis_model_traces(torch, acc)
    for rule, report in reports.items():
        check(rule in {f.rule for f in report.findings}, f"{rule} fires on its fixture through Accelerator.kernel_check")
        refused = rule == "TPU1001"
        check(report.interpret_probe.startswith("failed on cuda: RuntimeError: tile_copy launch refused: cudaError"
                                                if refused else "ran on cuda"),
              f"{rule}'s probe on the card: {report.interpret_probe}")
    for name, report in twin_reports.items():
        check(not report.findings and report.interpret_probe == "ran on cuda: outputs finite",
              f"{name} (clean twin) on the card: {report.interpret_probe}, {[f.rule for f in report.findings]}")

    # each fixture on its own, its outcome asserted
    gen = torch.Generator(device="cuda").manual_seed(41)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    requests = {}
    refused = None
    try:
        fixture_set["TPU1001"][0](torch.zeros(1024, 512, device="cuda"))
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "cudaError" in refused, "vmem_hog's launch is refused")
    requests["TPU1001"] = fixtures.last_copy_smem_request
    predicted = next(f.message for f in reports["TPU1001"].findings if f.rule == "TPU1001")
    x, xr = rand(16, 128), rand(16, 100)
    check(torch.equal(fixture_set["TPU1002"][0](xr), xr), "ragged_tile bit-equal to its plain version (a copy)")
    requests["TPU1002"] = fixtures.last_copy_smem_request
    check(torch.equal(fixture_set["TPU1005"][0](x), x), "unregistered_call bit-equal to its plain version (a copy)")
    requests["TPU1005"] = fixtures.last_copy_smem_request
    check(torch.equal(fixture_set["TPU1006"][0](x), fixtures.tile_scale_plain(x)), "drifting_call bit-equal to 2 x")
    out = torch.full_like(x, float("nan"))
    fixture_set["TPU1003"][0](x, out=out)
    torch.cuda.synchronize()
    requests["TPU1003"] = fixtures.last_copy_smem_request
    check(bool(out[8:].isnan().all()), "gapped_map leaves the uncovered tile (1, 0) as it was (NaN)")
    from_0, from_1 = out[:8] == x[:8], out[:8] == x[8:]
    check(bool((from_0 | from_1).all()), "the raced tile (0, 0) holds, element by element, one of its two sources")
    gap = {"uncovered_tile_nan": True, "raced_tile": "block 0's (x rows 0-7)" if bool(from_0.all())
           else "block 1's (x rows 8-15)" if bool(from_1.all())
           else f"mixed: {int(from_0.sum())} elements from block 0, {int((~from_0).sum())} from block 1"}
    a, d = rand(16, 128), rand(16, 128)
    a0 = a.clone()
    fixture_set["TPU1004"][0](a, d)
    torch.cuda.synchronize()
    check(torch.equal(a[:8], a0[:8] + d[:8]), "hazardous_alias: block 0's tile is a + d")
    before, after = a0[:8] + d[8:], (a0[:8] + d[:8]) + d[8:]  # block 1 read a before / after block 0 wrote it
    read_before, read_after = a[8:] == before, a[8:] == after
    check(bool((read_before | read_after).all()), "hazardous_alias: block 1's tile is one of the two orderings")
    alias = {"ordering": "block 1 read a before block 0 wrote it" if bool(read_before.all())
             else "block 1 read a after block 0 wrote it" if bool(read_after.all())
             else f"mixed: {int(read_before.sum())} elements read before, {int((~read_before).sum())} after",
             "matches_hazard_free_plain": bool(torch.equal(a, fixtures.tile_add_plain(a0, d))),
             "max_abs_err_to_plain": float((a - fixtures.tile_add_plain(a0, d)).abs().max())}

    # declared shared memory against what nvcc built plus what each launch asks for
    def occupancy(fn, args):
        return smem_occupancy_bytes(kernel_check(fn, *args, probe=False).sites[0])

    attrs = {"block_matmul_softmax": build.func_attributes("reference_kernels", 0),
             "block_accumulate": build.func_attributes("reference_kernels", 2),
             "tile_copy": build.func_attributes("kernel_fixtures", 0),
             "tile_add": build.func_attributes("kernel_fixtures", 1),
             "tile_scale": build.func_attributes("kernel_fixtures", 2)}
    smem = []
    k6_dynamic = build.load("reference_kernels").block_matmul_softmax_smem(0)  # the f32 twin's ring and tile
    for label, kernel, (fn, args), dynamic in (
        ("K6 clean twin", "block_matmul_softmax", twins["TPU1001"], k6_dynamic),
        ("K7 clean twin", "block_accumulate", twins["TPU1004"], 0),
        ("vmem_hog", "tile_copy", fixture_set["TPU1001"], requests["TPU1001"]),
        ("ragged_tile", "tile_copy", fixture_set["TPU1002"], requests["TPU1002"]),
        ("gapped_map", "tile_copy", fixture_set["TPU1003"], requests["TPU1003"]),
        ("hazardous_alias", "tile_add", fixture_set["TPU1004"], 0),
        ("unregistered_call", "tile_copy", fixture_set["TPU1005"], requests["TPU1005"]),
        ("drifting_call", "tile_scale", fixture_set["TPU1006"], 0),
    ):
        declared = occupancy(fn, args)
        built = attrs[kernel]["shared_size_bytes"] + dynamic
        check(declared == built, f"{label}: declared shared memory {declared} == built {built}")
        smem.append({"fixture": label, "kernel": kernel, "declared_bytes": declared,
                     "static_bytes": attrs[kernel]["shared_size_bytes"], "dynamic_bytes": dynamic,
                     "num_regs": attrs[kernel]["num_regs"]})

    # the three K8 bodies at the fixture shapes: each call's output against its plain version, then timed.
    # tile_add is measured and timed with a map free of hazards (block i reads and writes tile i), where plain
    # a + d is its answer; the hazardous fixture's gap to plain is alias["max_abs_err_to_plain"]
    def clean_add(a, d):
        return fixtures.tile_add(a, d, tile=(8, 128), grid=(2,), a_map=lambda i: (i, 0), d_map=lambda i: (i, 0),
                                 out_map=lambda i: (i, 0), alias=True)

    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    x, a, d, out = rand(16, 128), rand(16, 128), rand(16, 128), torch.empty(16, 128, device="cuda")
    nbytes = x.numel() * 4
    timing = {}
    for name, case, kernel, plain, library, moved, flops in (
        ("tile_copy", "unregistered_call (16, 128) f32", lambda: fixture_set["TPU1005"][0](x),
         lambda: fixtures.tile_copy_plain(x), lambda: out.copy_(x), 2 * nbytes, 0),
        ("tile_add", "aliased add, maps agree (16, 128) f32", lambda: clean_add(a, d),
         lambda: fixtures.tile_add_plain(a, d), lambda: a + d, 3 * nbytes, x.numel()),
        ("tile_scale", "drifting_call (16, 128) f32", lambda: fixture_set["TPU1006"][0](x),
         lambda: fixtures.tile_scale_plain(x), lambda: torch.mul(x, 2), 2 * nbytes, x.numel()),
    ):
        want = plain()  # before the kernel: the aliased add overwrites a
        got = kernel()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err == 0.0, f"{name} ({case}) bit-equal to its plain version: max_abs_err {err}")
        bound_ms, bound_by = bound_of(torch, moved, flops, torch.float32)
        timing[name] = {
            "case": case, "max_abs_err": err,
            "ms": time_ms(torch, kernel, flush=flush), "plain_ms": time_ms(torch, plain, flush=flush),
            "library_ms": time_ms(torch, library, flush=flush), "bound_ms": bound_ms, "bound_by": bound_by,
        }
    row = {
        "phase": "analysis", "generation": generation, "smem_per_block_optin": optin, "selfcheck": lines,
        "launches": launches, "probes": {rule: r.interpret_probe for rule, r in reports.items()},
        "vmem_hog": {"refused": refused, "smem_requested": requests["TPU1001"], "tpu1001_predicted": predicted},
        "gapped_map": gap, "hazardous_alias": alias, "smem": smem, "model_traces": traces, "timing": timing,
        "seconds": time.perf_counter() - t0,
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

    # `--only paged,flash,int4,reference,analysis,serve,consistency,train,bert` runs some groups of phases
    # while a kernel is being worked on; it prints no kernels line and no "ok"
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv else set()

    phase_build()
    print(smi, flush=True)
    if not only or "paged" in only:
        kernel = phase_kernel(torch)
        phase_kernel_sweep(torch)
    if not only or "flash" in only:
        flash = phase_flash_kernel(torch)["bf16"]  # the training slice's dtype and shapes
        phase_flash_sweep(torch)
        phase_flash_launch(torch)
    if not only or "int4" in only:
        int4 = phase_int4_kernel(torch)[INT4_MAIN_CASE]
        phase_int4_sweep(torch)
        phase_int4_host_cost(torch)
    if not only or "reference" in only:
        reference = phase_reference_kernels(torch)
    if not only or "analysis" in only:
        analysis = phase_analysis(torch)
    if not only or "serve" in only:
        serve, model = phase_serve(torch)
        phase_profile(torch, model)
        quant_generate = {"phase": "quant_generate", "batch": 8, "prompt_len": 32, "max_new_tokens": 32,
                          "bf16": generate_run(torch, model, "bf16")}
        qmodel, quantize_s, bf16_bytes = quantize_for_serving(torch, model)
        del model  # the bf16 projections go; the int4 model keeps the shared embedding, norms and LM head
        free_memory(torch)
        quant_serve = phase_quant_serve(torch, qmodel, serve, quantize_s, bf16_bytes)
        phase_profile(torch, qmodel, phase="quant_profile", what="TinyLlama shape, int4 g128 projections, bf16 stream")
        quant_generate["int4"] = generate_run(torch, qmodel, "int4")
        emit(quant_generate)
        del qmodel
        free_memory(torch)
    if not only or "consistency" in only:
        phase_consistency(torch)
        tiny = phase_tiny_serve(torch)
        phase_quant_consistency(torch)
    if not only or "train" in only:
        train, acc, model, step, batches = phase_train(torch)
        phase_train_profile(torch, step, batches)
        del acc, model, step, batches
        torch.cuda.empty_cache()
        phase_train_consistency(torch, "no")
        phase_train_consistency(torch, "bf16")
        phase_flash_crossover(torch)
    if not only or "bert" in only:
        phase_bert_finetune(torch)
        phase_bert_bench(torch)
        phase_bert_consistency(torch)
    if only:
        emit({"partial": sorted(only)})
        return 0

    main_case = kernel["bf16"]  # the serving slice's dtype and shapes
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/pallas_paged_attention.py:40",
        # the serving paths: the bf16 model's, the int4 model's and LlamaConfig.tiny()'s (head dim 16)
        "launches": serve["kernel_launches"] + quant_serve["kernel_launches"] + tiny["kernel_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
    }]
    for kind, name, line in (("fwd", "flash_attention_fwd", 89), ("dq", "flash_attention_dq", 177),
                             ("dkv", "flash_attention_dkv", 210)):
        row = flash[kind]
        source = "flash_fwd_sm90.cu" if kind == "fwd" else "flash_bwd_sm90.cu"  # bf16: the Hopper kernels
        kernels.append({
            "name": name, "route": "cuda", "source": f"accelerate_tpu_torch/csrc/{source}",
            "replaces": f"accelerate_tpu/ops/pallas_attention.py:{line}",
            "launches": train["launches"][kind], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # K1: scaled_dot_product_attention's forward; K2, K3: its backward, one call for dq, dk and dv
            "library_ms": flash["library_fwd_ms"] if kind == "fwd" else flash["library_bwd_ms"],
        })
    kernels.append({
        "name": "int4_matmul", "route": "cuda", "source": "accelerate_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "accelerate_tpu/ops/pallas_qmatmul.py:41", "case": INT4_MAIN_CASE,
        # the main path's launches: the int4 model served, then decoded by generate and per_token_latency
        "launches": quant_serve["int4_launches"] + quant_generate["int4"]["int4_launches"],
        "max_abs_err": int4["max_abs_err"], "ms": int4["ms"], "plain_ms": int4["plain_ms"],
        "bound_ms": int4["bound_ms"], "bound_by": int4["bound_by"],
        # torch.ops.aten._weight_int4pack_mm on the same codes (null, with the error in int4_kernel, if it refused)
        "library_ms": int4["library_ms"],
    })
    for key, name, line, case in (("matmul_softmax", "block_matmul_softmax", 79, "logits-bf16"),
                                  ("accumulate", "block_accumulate", 139, "4096-f32")):
        row = reference[key][case]
        kernels.append({
            "name": name, "route": "cuda", "source": "accelerate_tpu_torch/csrc/reference_kernels.cu",
            "replaces": f"accelerate_tpu/kernels/reference.py:{line}", "case": case,
            "launches": reference["launches"][key], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # K7: acc.add_(delta); K6: no single call (F.softmax(x @ w) is two, timed in reference_kernels)
            "library_ms": row["library_ms"] if key == "accumulate" else None,
        })
    for name, line in (("tile_copy", 1156), ("tile_add", 1159), ("tile_scale", 1235)):
        row = analysis["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "accelerate_tpu_torch/csrc/kernel_fixtures.cu",
            "replaces": f"accelerate_tpu/analysis/selfcheck.py:{line}", "case": row["case"],
            # the main path's launches: Accelerator.kernel_check's probes of the six fixtures
            "launches": analysis["launches"][name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],  # out.copy_(x), a + d, torch.mul(x, 2)
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
