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
  padded attention is the einsum path, as in the JAX package;
* checkpointing: the same BERT-base fine-tune and the Llama train step
  (TinyLlama widths, 4 layers: K1-K3) saved mid-run with ``save_state``
  (synchronous, and async while training goes on), resumed in a fresh
  Accelerator with ``load_state()``: every restored tensor bit-equal to
  the saved one and on the card, the resumed batches the unbroken run's,
  the resumed steps launching K1-K3 as the unbroken ones do, and the
  resumed run bit-equal to the unbroken one where a repeat from the same
  checkpoint is (else within twice the repeat's spread); save, async and
  load seconds and bytes;
* the imperative loop and mutable state: the train phase's TinyLlama
  shape trained through ``accumulate`` / ``backward`` / ``optimizer.step``
  (accumulation 4 over 8 microbatches of 2 x 2048) and through
  ``build_train_step`` from the same weights on the same batches, the two
  bit-equal in every loss, parameter and AdamW tensor and each launching
  K1-K3 as the train step does, and a run clipping in the loop;
  examples/torch_cv_example.py's loop at its full configuration
  (ResNet-50 v1.5, 37 classes, 224 px, batch 64, bf16 compute, the
  BatchNorm statistics through ``build_train_step(has_state=True)``) for
  one epoch with its eval pass, its step traced (convolutions are cuDNN's:
  no kernel of the JAX package runs there); small ResNets held card
  against CPU; the statistics saved, zeroed and restored bit for bit;
* the Llama-knob families: Gemma-2B at full width (seeded random weights,
  bf16) served with the serving traffic (K4 at head dim 256; greedy
  tokens against a no-cache loop; one tick profiled) and trained at batch
  2 x 2048 (K1-K3 at head dim 256; one step profiled), Gemma3-1B trained
  likewise (its 512-key band on five layers in six), every family at its
  published widths cut to 2 layers held on the card to the CPU (logits,
  greedy generate), and Phi-3-mini's widths (head dim 96, a 2047-key
  band) trained through the kernels against the einsum path. K1-K3 are
  held to their plain versions at D 96 and 256 too, and swept over head
  dims 16 to 256. The banded families' 2-layer cuts (Mistral, Phi-3,
  Gemma3) are served paged on the card and held to the CPU engine; Gemma2
  on the paged engine raises, naming the dense layout;
* the paged engine's memory and scheduling (``--only sched``):
  Mistral-7B-v0.1 at full width, 8 of its 32 layers (seeded random
  weights, bf16) behind the engine, every decode step's attention through K4 in its
  4096-key band, held at that shape against its plain version (NaN in
  every expired entry): 12 prompts of 300-7,900 tokens on a pool sized
  by the band, blocks expiring mid-decode (``mistral_serve``, greedy
  tokens against the dense cache); a 1,536-token system prompt shared by
  16 requests against the same requests in full (``prefix_serve``); four
  priority-0 arrivals preempting priority-1 decodes that resume by
  recompute, against an unpreempted control, and a structured
  ``ShedError`` (``preempt_serve``);
* the dense serving layout, speculative serving and beam search (``--only
  dense``): Gemma-2-9B at full width, 14 of its 42 layers (seeded random
  weights, bf16; its softcaps and its 4096-key band on alternate layers) served on
  the dense layout (``gemma2_serve``: 12 prompts of 16-2,000 tokens and
  one of 3,000, 64 new, greedy tokens against the teacher-forced dense
  reference, one tick traced), with a Gemma-2-2B draft (8 of its 26 layers)
  (``gemma2_spec_serve``, tokens against the plain run's), as its own
  draft (``gemma2_self_spec``: acceptance at least 0.9, every rejection
  at a near tie), through ``speculative_generate`` and ``beam_search``,
  and 2-layer f32 cuts held card against CPU (``dense_consistency``). No
  kernel of the JAX package lies on these paths: the dense cache's
  attention is an einsum in both packages;
* fp8 mixed precision and the run's telemetry (``--only fp8``): the
  three products of every projection of the TinyLlama train step through
  ``torch._scaled_mm`` held to their plain version, the codes bit-equal
  to the CPU's, timed beside ``torch.matmul`` in bf16 (``fp8_matmul``);
  the TinyLlama shape trained in fp8 under both recipes from the train
  phase's weights and batches, K1-K3 and the fp8 products launched as
  counted, losses within 0.1 of bf16's, one history entry a step, one
  step traced (``fp8_train``, ``fp8_train_profile``); the BERT-base
  fine-tune in fp8 (``fp8_bert``); a 4-layer fp8 step under
  ``accelerator.telemetry`` with the JSONL tracker (``telemetry``); and
  2-layer cuts of both models held card against CPU step by step
  (``fp8_consistency``). The fp8 products are library GEMMs, as the JAX
  package's are XLA dots: they add no row to the kernels line.

Each phase prints one JSON line; any failed check exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since the
    script started, so each group's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
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
# flash against einsum training (loss, grad norm relative errors): phase_train_consistency
CONSISTENCY_TOL = {"no": (1e-5, 1e-4), "bf16": (1e-4, 2e-3)}


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


# K1-K3's cases at the shapes the main paths give them: (name, dtype, [B, S, H, H_kv, D], window, timed
# runs). The training slice's (TinyLlama: D 64), then Phi-3-mini's attention (D 96, MHA, its 2047-key
# band) and Gemma-2B's (D 256, MQA), each at seq 2048 (the families phases' shapes).
FLASH_CASES = [
    ("bf16", "bfloat16", [8, 2048, 32, 4, 64], None, 30),
    ("fp16", "float16", [8, 2048, 32, 4, 64], None, 30),
    ("f32", "float32", [8, 2048, 32, 4, 64], None, 5),
    ("bf16-d128", "bfloat16", [8, 2048, 32, 4, 128], None, 30),
    ("bf16-d96", "bfloat16", [8, 2048, 32, 32, 96], 2047, 10),
    ("bf16-d256", "bfloat16", [2, 2048, 8, 1, 256], None, 30),
    ("fp16-d256", "float16", [2, 2048, 8, 1, 256], None, 10),
    ("f32-d256", "float32", [2, 2048, 8, 1, 256], None, 3),
]


def phase_flash_kernel(torch, cases=FLASH_CASES):
    """K1-K3 against their plain versions at the training slice's attention
    shape (B 8, H 32, H_kv 4, D 64, S 2048, causal, bf16), again in fp16 and
    f32 and at D 128, and at the families' head dims: D 96 (Phi-3-mini, H
    32/32, band 2047) and D 256 (Gemma-2B, H 8/1) in bf16, D 256 in fp16 and
    f32 as well; their times beside the bound, the plain version's and
    scaled_dot_product_attention's (forward; backward, which computes dq,
    dk and dv in one call; the band as a boolean mask), with each one's
    achieved TFLOP/s and share of its bound. Tolerances: FLASH_TOL."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    results = {}
    for name, dtype_name_, (b, s, h, h_kv, d), window, reps in cases:
        dtype = getattr(torch, dtype_name_)
        q, k, v, do = flash_inputs(torch, gen, b, s, s, h, h_kv, d, dtype)
        errs, (out, lse, delta) = flash_compare(torch, fa, q, k, v, do, True, window)
        check_flash(errs, name)
        scale = d**-0.5
        kernels = {
            "fwd": lambda: fa.flash_fwd_kernel(q, k, v, True, scale, window),
            "dq": lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, True, scale, window),
            "dkv": lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, True, scale, window),
        }
        plains = {
            "fwd": lambda: fa.flash_attention_plain(q, k, v, True, scale, window),
            "dq": lambda: fa.flash_attention_plain_dq(q, k, v, do, lse, delta, True, scale, window),
            "dkv": lambda: fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, True, scale, window),
        }
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        if window is None:
            lib_kw = {"is_causal": True}
        else:  # the band as the mask scaled_dot_product_attention takes
            rows, cols = torch.arange(s, device="cuda")[:, None], torch.arange(s, device="cuda")[None, :]
            lib_kw = {"attn_mask": (cols <= rows) & (cols > rows - window)}
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw)
        lib_err = (lib_out.transpose(1, 2).float() - out.float()).abs().max().item()
        dot = do.transpose(1, 2).contiguous()
        library = {
            "fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw),
            "bwd": lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True),
        }
        row = {"phase": "flash_kernel", "case": name, "shape": [b, s, h, h_kv, d], "causal": True, "window": window,
               "library_max_abs_err_fwd": lib_err}
        for kind in kernels:
            bound_ms, bound_by = flash_bound(kind, q, k, True, window)
            ms = time_ms(torch, kernels[kind], reps=reps, flush=flush)
            row[kind] = {
                "max_abs_err": errs[kind][0], "err_over_tol": errs[kind][1], "ms": ms,
                "plain_ms": time_ms(torch, plains[kind], reps=min(reps, 5), warmup=1, flush=flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flash_flops(kind, q, k, True, window) / (ms * 1e-3) / 1e12, "share_of_bound": bound_ms / ms,
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
    100 keys; then the head dims run at a wider built width (16, 48, 96, 160,
    208) and D 256, at groups 1 and 8 and without the 2048 shape."""
    import itertools

    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    shapes = ((1, 1), (100, 100), (2048, 2048), (100, 300), (300, 100))
    masks = ((False, None), (True, None), (True, 1), (True, 100))
    worst, n = {}, 0
    sweep = itertools.chain(
        itertools.product(dtypes, (1, 4, 8), (64, 128), shapes, masks),
        itertools.product(dtypes, (1, 8), (16, 48, 96, 160, 208, 256), shapes[:2] + shapes[3:], masks),
    )
    for dtype, g, d, (sq, sk), (causal, window) in sweep:
        q, k, v, do = flash_inputs(torch, gen, 1, sq, sk, 2 * g, 2, d, dtype)
        errs, _ = flash_compare(torch, fa, q, k, v, do, causal, window)
        check_flash(errs, f"sweep {dtype} G{g} D{d} {sq}x{sk} causal={causal} W{window}")
        for kind, (_, over) in errs.items():
            key = f"{str(dtype).split('.')[-1]} {kind}"
            worst[key] = max(worst.get(key, 0.0), over)
        n += 1
    emit({"phase": "flash_sweep", "cases": n, "worst_err_over_tol": worst})


def phase_flash_launch(torch):
    """K1-K3's launches for every dtype x D (64, 96, 128, 256), three ways: what the C launcher
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
        for d in (64, 96, 128, 256):
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
    the attention scores (2 S^2 x heads x head dim a layer forward, x3 with
    the backward, halved by causality; a banded layer counts its live
    (query, key) pairs instead), plus a tied head's 6 x tokens x hidden x
    vocab."""
    from accelerate_tpu_torch.models.llama import _head_dim, _layer_kinds

    n_params = sum(p.numel() for name, p in module.named_parameters() if "embed" not in name)
    batch = tokens // seq_len
    width = cfg.num_attention_heads * _head_dim(cfg)
    pairs = [0.5 * seq_len**2 if window is None else live_pairs(seq_len, seq_len, True, window)
             for window, _ in _layer_kinds(cfg)]
    attn = 12.0 * batch * width * sum(pairs)
    lm_head = 6.0 * tokens * cfg.hidden_size * cfg.vocab_size if cfg.tie_word_embeddings else 0.0
    return 6.0 * n_params * tokens + attn + lm_head


def token_batches(torch, n, b, s, vocab, seed):
    """Token ids with a skewed (Pareto) unigram distribution, made with numpy:
    something a model can learn in a few steps."""
    rng = np.random.default_rng(seed)
    ids = (rng.pareto(1.2, size=(n, b, s)) * 50).astype(np.int64) % vocab
    return torch.as_tensor(ids, device="cuda")


def build_trainer(torch, cfg, mixed_precision, seed=0, lr=3e-4, project_dir=None):
    """A fresh Accelerator (checkpointing into ``project_dir`` with automatic
    naming, when given), a Llama from ``seed``, AdamW and the train step."""
    from accelerate_tpu_torch import Accelerator, ProjectConfiguration, causal_lm_loss, create_llama_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    project = ProjectConfiguration(project_dir=project_dir, automatic_checkpoint_naming=True) if project_dir else None
    acc = Accelerator(mixed_precision=mixed_precision, project_config=project)
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


def phase_train_profile(torch, step, batches, phase="train_profile",
                        what="one train step, TinyLlama shape, batch 8 x 2048, bf16 compute, remat"):
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
        "phase": phase, "what": what,
        "step_wall_ms": wall_ms, "step_wall_ms_unprofiled": plain_wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if busy else None,
        "flash_ms": flash, "flash_share": sum(flash.values()) / busy if busy else None,
        "gemm_ms": gemm, "gemm_share": gemm / busy if busy else None,
        "kernels_traced": sum(n for _, n in by_name.values()), "trace_attempts": attempts, "trace_lead_lost": lost,
        "top": [[name[:90], ms, n] for name, (ms, n) in top],
    }
    emit(row)
    return row


def consistency_runs(torch, cfg, mixed_precision) -> dict:
    """``cfg`` (2 layers) trained three steps at batch 1 x seq 2048, where
    the flash path dispatches by itself, through the kernels and then from
    the same weights on the einsum attention path (FLASH_MIN_SEQ raised
    above the sequence for that run only): each path's losses, grad norms
    and K1 launches (2 layers x 2 with remat x 3 steps through the kernels,
    none on the einsum path)."""
    from accelerate_tpu_torch.ops import attention
    from accelerate_tpu_torch.ops import flash_attention as fa

    check(cfg.num_hidden_layers == 2, "a consistency run trains 2 layers")
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
    return runs


def rel_errs(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_train_consistency(torch, mixed_precision):
    """TinyLlama widths, 2 layers, batch 1 x seq 2048 (consistency_runs). In
    f32 (the kernels' CUDA-core path) losses agree within 1e-5 relative and
    grad norms within 1e-4. In bf16 compute (the tensor-core path) the
    einsum path rounds its scores to bf16 where the kernels keep them f32:
    losses within 1e-4, grad norms within 2e-3, about twice the differences
    read on the card (PERF.md)."""
    from accelerate_tpu_torch import LlamaConfig

    loss_tol, norm_tol = CONSISTENCY_TOL[mixed_precision]
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 2}, remat=True)
    runs = consistency_runs(torch, cfg, mixed_precision)
    loss_err = rel_errs(runs["flash"]["losses"], runs["einsum"]["losses"])
    norm_err = rel_errs(runs["flash"]["grad_norms"], runs["einsum"]["grad_norms"])
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
# the Llama-knob families: Gemma-2B served and trained at full width,
# Gemma3-1B trained, every family's card against the CPU
# ---------------------------------------------------------------------------

# Published configurations (seeded random weights): google/gemma-2b and
# google/gemma-3-1b-pt config.json, as GemmaConfig.gemma_2b and
# Gemma3Config.gemma3_1b give them; the other families' presets name theirs
# (mistralai/Mistral-7B-v0.1, Qwen/Qwen2-7B, Qwen/Qwen3-8B,
# allenai/OLMo-2-1124-7B, google/gemma-2-9b, microsoft/Phi-3-mini-4k-instruct).
FAMILY_PRESETS = (("mistral", "MistralConfig", "mistral_7b_v1"), ("qwen2", "Qwen2Config", "qwen2_7b"),
                  ("qwen3", "Qwen3Config", "qwen3_8b"), ("olmo2", "Olmo2Config", "olmo2_7b"),
                  ("gemma", "GemmaConfig", "gemma_2b"), ("gemma2", "Gemma2Config", "gemma2_9b"),
                  ("gemma3", "Gemma3Config", "gemma3_1b"), ("phi3", "Phi3Config", "phi3_mini_4k"))
# greedy bf16 serving against the no-cache loop: the two paths round the bf16
# stream in different places (K4 keeps P in f32, the einsum path its scores
# in bf16), which moves Gemma-2B's f32 logits by up to a few hundredths
SERVE_BF16_GAP = 0.1
# Mistral-7B-v0.1's served logprobs (bf16) against the dense reference fed the
# same tokens, and between two engine runs: rounding in other places moved them
# by 0.040-0.060 on the H100 (PERF.md), a lost or misplaced position of context
# by whole nats
SERVE_LP_LIMIT = 0.15


def family_config(family: str, preset: str, **kw):
    from accelerate_tpu_torch import models

    name = dict((f, c) for f, c, _ in FAMILY_PRESETS)[family]
    return getattr(getattr(models, name), preset)(**kw)


def phase_gemma_serve(torch):
    """Gemma-2B (google/gemma-2b's shape: vocab 256,000, hidden 2048, 18
    layers, 8/1 heads, head dim 256, GeGLU, tied head) in bf16 on seeded
    random weights, served by the paged engine with the serve phase's
    traffic (8 slots, 12 prompts of 5-400 tokens, 64 new, greedy): every
    decode step's attention through K4 at D 256 (launches == 18 x decode
    steps, counted from 0 for the run), every request's greedy tokens
    against a no-cache loop over the full forward (a token may differ only
    at a top-2 logit gap under SERVE_BF16_GAP, which ends the request's
    comparison), logprobs finite; one decode tick profiled for its idle
    share."""
    from accelerate_tpu_torch.models import create_gemma_model

    cfg = family_config("gemma", "gemma_2b")
    t0 = time.perf_counter()
    model = create_gemma_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    row = serve_run(torch, model, "gemma_serve", "Gemma-2B shape, bf16, seeded random weights")
    eng, rng = serve_engine(model), np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 130, 400)]
    uids = [eng.submit(p, 32) for p in prompts]
    eng.run()
    served = [(p, eng.poll(uid)[len(p):], eng.logprobs(uid)) for uid, p in zip(uids, prompts)]
    compared, near_ties, max_lp_err = greedy_against_reference(torch, model, served, gap_limit=SERVE_BF16_GAP)
    check(compared > 0, "gemma serve: tokens compared against the no-cache loop")
    del eng
    free_memory(torch)
    profile = phase_profile(torch, model, phase="gemma_profile", what="Gemma-2B shape bf16")
    row.update(model_build_s=build_s, head_dim=cfg.head_dim, heads=[cfg.num_attention_heads, cfg.num_key_value_heads],
               reference_prompts=[len(p) for p in prompts], tokens_compared=compared, stopped_at_near_tie=near_ties,
               max_logprob_err=max_lp_err, tick_idle_share=profile["idle_share"],
               tick_wall_ms=profile["tick_wall_ms"])
    emit(row)
    del model
    free_memory(torch)
    return row


def train_family(torch, phase, cfg, what, b=2, s=2048, warmup=2, timed=10, profile=False):
    """``cfg`` at full width and depth, f32 masters, bf16 compute, remat,
    AdamW(3e-4, weight decay 0.01), batch ``b`` x ``s``: ``warmup`` + ``timed``
    steps through build_train_step. Losses finite and falling; every layer's
    attention through the flash kernels (K1 twice a layer a step, K2 and K3
    once), counted from 0 for the run; K1-K3 held against their plain
    versions on the first step's last-layer q, k, v and dO (that layer's
    band). With ``profile`` one more step is traced (phase_train_profile)."""
    from accelerate_tpu_torch.models.llama import _layer_kinds
    from accelerate_tpu_torch.ops import flash_attention as fa

    free_memory(torch)
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
    peak = torch.cuda.max_memory_allocated() / 1e9
    n, layers = warmup + timed, cfg.num_hidden_layers
    check(all(np.isfinite(losses)), f"{phase}: losses finite: {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss falls over {n} steps: {losses[0]} -> {losses[-1]}")
    check(launches == {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n},
          f"{phase}: flash launches {launches} == K1 2 x {layers} x {n}, K2/K3 {layers} x {n}")
    q, k, v, do = seen[0]
    window = _layer_kinds(cfg)[-1][0]
    model_errs, _ = flash_compare(torch, fa, q, k, v, do, True, window)
    check_flash(model_errs, f"{phase}: the train step's own last-layer inputs")
    shapes = [list(q.shape), list(k.shape)]
    del seen, q, k, v, do
    step_ms = sorted(times[warmup:])
    flops = llama_step_flops(model.module, cfg, b * s, s)
    med = statistics.median(step_ms)
    row = {
        "phase": phase, "config": what, "params": model.num_parameters(), "batch": b, "seq": s,
        "warmup_steps": warmup, "timed_steps": timed, "tokens_per_s": b * s / (med / 1e3), "step_ms_median": med,
        "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1], "step_flops": flops,
        "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak,
        "memory_total_gb": torch.cuda.get_device_properties(0).total_memory / 1e9, "losses": losses,
        "launches": launches, "last_layer_qk_shapes": shapes, "last_layer_window": window,
        "flash_vs_plain_on_model_inputs": {kind: {"max_abs_err": a, "err_over_tol": o}
                                           for kind, (a, o) in model_errs.items()},
    }
    emit(row)
    if profile:
        phase_train_profile(torch, step, batches, f"{phase}_profile", f"one train step, {what}, batch {b} x {s}")
    del acc, model, step, batches
    free_memory(torch)
    return row


def phase_gemma_train(torch):
    """Gemma-2B at full width and depth (18 layers, head dim 256, MQA 8/1,
    2.51 B parameters): batch 2 x 2048, train_family's recipe. At batch 2
    the f32 masters, grads and AdamW moments take about 40 GB and each f32
    copy of the 256,000-wide logits about 4.2 GB."""
    cfg = family_config("gemma", "gemma_2b", remat=True)
    return train_family(torch, "gemma_train", cfg, "Gemma-2B shape, 18 layers, f32 masters + bf16 compute, remat",
                        profile=True)


def phase_gemma3_train(torch):
    """Gemma3-1B (google/gemma-3-1b-pt's shape: 26 layers, hidden 1152, 4/1
    heads, head dim 256, a 512-key band on five layers in six, dual rope
    bases, qk-norms) at full width and depth, train_family's recipe."""
    cfg = family_config("gemma3", "gemma3_1b", remat=True)
    return train_family(torch, "gemma3_train", cfg, "Gemma3-1B shape, 26 layers, f32 masters + bf16 compute, remat")


def attention_op_errors(torch, b, s, h, hkv, d, window) -> dict:
    """Causal attention (with ``window``) forward and backward on seeded bf16
    q, k, v and dO in bf16 through the kernels (use_flash=True) and through
    the einsum path, each against the einsum path in f32 on the same
    values: ``{path: [relative error (Frobenius) of out, dq, dk, dv]}``."""
    from accelerate_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = flash_inputs(torch, gen, b, s, s, h, hkv, d, torch.bfloat16)
    ref, errs = None, {}
    for name, flash, dtype in (("f32", False, torch.float32), ("bf16-flash", True, torch.bfloat16),
                               ("bf16-einsum", False, torch.bfloat16)):
        qq, kk, vv = (x.to(dtype).detach().requires_grad_() for x in (q, k, v))
        out = dot_product_attention(qq, kk, vv, causal=True, window=window, use_flash=flash)
        out.backward(do.to(dtype))
        got = [t.detach().float() for t in (out, qq.grad, kk.grad, vv.grad)]
        if ref is None:
            ref = got
        else:
            errs[name] = [float((a - r).norm() / r.norm()) for a, r in zip(got, ref)]
    return errs


# the banded families' 2-layer cuts served paged, card against CPU: prompts that cross Phi-3's 2047-key band and
# Gemma3's 512-key one (blocks expire on Phi-3; Gemma3's full layer keeps them); Mistral's 4096-key band is crossed
# at full depth in mistral_serve, where a CPU run would take minutes
BANDED_SERVE = {"mistral": (5, 300), "phi3": (5, 2100), "gemma3": (5, 600)}


def banded_serve_card_vs_cpu(torch, cpu, card, family) -> dict:
    """``family``'s 2-layer cut served by the paged engine on the card and on
    the CPU (2 slots, blocks of 16, 20 new tokens, greedy, f32): K4 launches
    == layers x decode steps, the pool drained, and the card's tokens equal
    the CPU engine's, a request's comparison ending only at a top-2 logit
    gap under 1e-3 of the CPU's forward on the shared context."""
    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, cpu.config.vocab_size, size=n).astype(np.int32) for n in BANDED_SERVE[family]]
    kw = dict(num_slots=2, prompt_buckets=(64, 512), paged_block_size=16, tick_block=4, max_len=4096)
    want = ServingEngine(cpu, device="cpu", **kw).generate_many(prompts, 20)
    eng = ServingEngine(card, **kw)
    pa.launches = 0
    uids = [eng.submit(p, 20) for p in prompts]
    freed = False
    while eng.queue or eng.active_count:
        done, free = len(eng.done), eng.pool_free_blocks
        eng.step()
        freed |= len(eng.done) == done and eng.pool_free_blocks > free
    launches = pa.launches
    check(launches == cpu.config.num_hidden_layers * eng.decode_steps > 0,
          f"{family} paged on the card: K4 launches {launches} == layers x decode steps")
    check(eng.pool_free_blocks == eng._pcfg.num_blocks - 1, f"{family} paged on the card: pool drained")
    compared = near = 0
    for p, w, uid in zip(prompts, want, uids):
        g = eng.poll(uid)
        diff = np.nonzero(w != g)[0]
        upto = int(diff[0]) if len(diff) else len(w)
        compared += upto - len(p)
        if len(diff):
            with torch.no_grad():
                row = cpu(torch.as_tensor(w[None, :upto]))[0, -1]
            top2 = torch.topk(row, 2).values
            gap = float(top2[0] - top2[1])
            check(gap < 1e-3, f"{family} paged: card token {upto - len(p)} differs from the CPU's with gap {gap}")
            near += 1
    return {"prompts": list(BANDED_SERVE[family]), "window": card.config.sliding_window, "kernel_launches": launches,
            "decode_steps": eng.decode_steps, "blocks_expired_mid_decode": freed, "tokens_compared": compared,
            "stopped_at_near_tie": near}


def phase_families_consistency(torch):
    """Each family at its published widths cut to 2 layers (Gemma3 keeps one
    sliding and one full layer), f32, built on the CPU and copied to the
    card: the card's forward logits (batch 2 x 64) within 1e-4 of the CPU's
    RMS; greedy generate of 8 tokens after 16 equal to the CPU's, a token
    differing only where the CPU's top-2 logit gap on that prefix is under
    1e-3 (which ends that row's comparison). The banded families (Mistral,
    Phi-3, Gemma3) are served paged on the card and on the CPU, tokens
    equal (banded_serve_card_vs_cpu); Gemma2 on the paged engine raises,
    naming the dense layout. Then Phi-3-mini's widths, 2 of
    32 layers, train three flash-length steps at seq 2048 (D 96, its
    2047-key band) against the einsum path (consistency_runs): in f32 at
    train_consistency's tolerances; in bf16 compute each step's flash loss
    and grad norm no farther from the f32 run's than the einsum path's,
    plus train_consistency's bf16 tolerances: there the einsum path, which
    rounds its scores to bf16, is the farther of the two, as the attention
    alone at that shape shows first (attention_op_errors: the kernels no
    farther from f32 than the einsum path in out, dq, dk and dv)."""
    import copy

    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models.llama import create_llama_model

    rows = []
    rng = np.random.default_rng(12)
    for family, _, preset in FAMILY_PRESETS:
        kw = {"num_hidden_layers": 2}
        if family == "gemma3":
            kw["layer_types"] = ("sliding_attention", "full_attention")
        cfg = family_config(family, preset, **kw)
        t0 = time.perf_counter()
        cpu = create_llama_model(cfg, seed=5, device="cpu")
        card = Model(copy.deepcopy(cpu.module).to("cuda"), cfg, name=cpu.name)
        ids = rng.integers(1, cfg.vocab_size, size=(2, 64)).astype(np.int32)
        with torch.no_grad():
            want = cpu(torch.as_tensor(ids))
            got = card(torch.as_tensor(ids, device="cuda")).cpu()
        rms = float(want.pow(2).mean().sqrt())
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= 1e-4 * rms,
              f"{family}: card logits within 1e-4 of the CPU's RMS: {err} vs {rms}")
        prompt = ids[:, :16]
        want_tok = generate(cpu, prompt, max_new_tokens=8).numpy()
        got_tok = generate(card, prompt, max_new_tokens=8).cpu().numpy()
        compared, near_ties = 0, 0
        for r in range(2):
            diff = np.nonzero(want_tok[r, 16:] != got_tok[r, 16:])[0]
            upto = int(diff[0]) if len(diff) else 8
            compared += upto
            if len(diff):
                with torch.no_grad():
                    row_logits = cpu(torch.as_tensor(want_tok[r:r + 1, :16 + upto]))[0, -1]
                top2 = torch.topk(row_logits, 2).values
                gap = float(top2[0] - top2[1])
                check(gap < 1e-3, f"{family}: generated token {upto} differs with top-2 gap {gap}")
                near_ties += 1
        serve = None
        if family in BANDED_SERVE:
            serve = banded_serve_card_vs_cpu(torch, cpu, card, family)
        elif family == "gemma2":
            from accelerate_tpu_torch import ServingEngine

            try:
                ServingEngine(card, paged_block_size=16)
                serve = "served"
            except NotImplementedError as exc:
                serve = str(exc)
            check("softcapping" in serve and "dense engine layout" in serve,
                  f"gemma2 on the paged engine raises, naming the dense layout: {serve}")
        rows.append({"family": family, "preset": preset, "head_dim": cfg.head_dim or cfg.hidden_size //
                     cfg.num_attention_heads, "params": cpu.num_parameters(), "logits_max_abs_err": err,
                     "logits_rms": rms, "tokens_compared": compared, "stopped_at_near_tie": near_ties,
                     "paged_serve": serve, "seconds": time.perf_counter() - t0})
        del cpu, card
        free_memory(torch)
    phi3 = family_config("phi3", "phi3_mini_4k", num_hidden_layers=2, remat=True)
    ops = attention_op_errors(torch, 1, 2048, 32, 32, 96, 2047)
    check(all(f <= e for f, e in zip(ops["bf16-flash"], ops["bf16-einsum"])),
          f"phi3 attention in bf16: the kernels no farther from f32 than the einsum path: {ops}")
    runs = {mp: consistency_runs(torch, phi3, mp) for mp in ("no", "bf16")}
    tol = CONSISTENCY_TOL
    f32 = {"loss": rel_errs(runs["no"]["flash"]["losses"], runs["no"]["einsum"]["losses"]),
           "grad_norm": rel_errs(runs["no"]["flash"]["grad_norms"], runs["no"]["einsum"]["grad_norms"])}
    check(f32["loss"] <= tol["no"][0] and f32["grad_norm"] <= tol["no"][1],
          f"phi3 f32: flash vs einsum {f32} within {tol['no']}")
    # bf16: the einsum path rounds its scores to bf16, the kernels keep them f32, and at Phi-3's shape the
    # einsum path is the farther of the two from the f32 run (PERF.md). Each step's flash loss (grad norm)
    # may be no farther from the f32 run's than the einsum path's is, plus train_consistency's bf16 tolerance.
    bf16 = {}
    for key, t in (("losses", tol["bf16"][0]), ("grad_norms", tol["bf16"][1])):
        ref = runs["no"]["flash"][key]
        flash = [abs(a - r) / abs(r) for a, r in zip(runs["bf16"]["flash"][key], ref)]
        einsum = [abs(a - r) / abs(r) for a, r in zip(runs["bf16"]["einsum"][key], ref)]
        bf16[key] = {"flash_vs_f32": flash, "einsum_vs_f32": einsum,
                     "flash_vs_einsum": rel_errs(runs["bf16"]["flash"][key], runs["bf16"]["einsum"][key])}
        check(all(f <= e + t for f, e in zip(flash, einsum)),
              f"phi3 bf16 {key}: flash {flash} no farther from the f32 run than einsum {einsum} + {t}")
    row = {"phase": "families_consistency", "families": rows,
           "phi3_attention_rel_err_vs_f32": ops,
           "phi3_train": {"runs": runs, "f32_flash_vs_einsum": f32, "bf16": bf16}}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the paged engine's memory and scheduling: Mistral-7B-v0.1 at full width (8 of
# its 32 layers) behind the engine (windowed block expiry, prefix caching, preemption
# with resume by recompute, SLO shedding), K4 in its 4096-key band
# ---------------------------------------------------------------------------

# mistralai/Mistral-7B-v0.1 config.json: MistralConfig.mistral_7b_v1()'s defaults (vocab 32000, hidden 4096,
# intermediate 14336, 32 layers, 32/8 heads, head dim 128, 32,768 positions, sliding_window 4096, theta 1e4)
MISTRAL_ENGINE = dict(num_slots=8, prompt_buckets=(256, 2048), paged_block_size=16, tick_block=8, max_len=8192)
# the windowed need: a request in its band holds at most 266 blocks at 128 new tokens
MISTRAL_POOL = 8 * 266 + 1
# Mistral-7B-v0.1's 32 layers cut to 8 (its widths, band and engine kept) since PR 15: the whole script must end
# within its 1,200 s, and at full depth the three sched phases took 251 s of a 1,035 s run (PERF.md §4)
SCHED_LAYERS = 8
MISTRAL_LENGTHS = (300, 1200, 2500, 3968, 4000, 4090, 4500, 5000, 5600, 6100, 7000, 7900)


# K4 at Mistral's shape against its plain version: each element within t (|ref|
# + RMS(ref)) (flash_err). Both round an f32 result to bf16 and may part by an
# ulp, 2^-8 of the value; a key let in or dropped at the band's edge moves an
# element by its softmax weight times (v - out), a wrong in-band block by more.
# Each of those three faults is planted in the plain version, and the kernel's
# output must fail against each (PERF.md).
MISTRAL_K4_TOL = 8e-3


def mistral_kernel_inputs(torch, gen, rng, frontiers, poison):
    """K4's inputs at Mistral's serving shape: 8 rows, H 32/8, D 128, bf16,
    blocks of 16, 2,048 table entries (32,768 positions). Each row's in-band
    entries (the blocks holding positions cur - 4095 .. cur) point at
    distinct pool blocks; the expired entries below the band and the
    entries past the frontier point at the trash sink, block 0. With
    ``poison`` block 0 holds NaN: a split that read an expired or pad entry
    would turn its row to NaN."""
    b, heads, kv_heads, dim, bs, mb, window = 8, 32, 8, 128, 16, 2048, 4096
    cur = np.asarray(frontiers, np.int64)
    lo = np.maximum(0, cur - window + 1) // bs
    n_live = cur // bs - lo + 1
    nb = int(n_live.sum()) + 1
    q = torch.randn(b, heads, dim, generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn(nb, bs, kv_heads, dim, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(nb, bs, kv_heads, dim, generator=gen, device="cuda").to(torch.bfloat16)
    kp[0] = float("nan") if poison else 0.0
    vp[0] = float("nan") if poison else 0.0
    table = np.zeros((b, mb), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    used = 0
    for i in range(b):
        table[i, lo[i] : lo[i] + n_live[i]] = perm[used : used + n_live[i]]
        used += n_live[i]
    return q, kp, vp, torch.as_tensor(table, device="cuda"), torch.as_tensor(cur.astype(np.int32), device="cuda")


def phase_kernel_mistral(torch):
    """K4 at Mistral-7B-v0.1's decode shape (mistral_kernel_inputs), frontiers
    3,000-8,000 in a 4096-key band, against its plain version
    (MISTRAL_K4_TOL), two calls bit-equal, and failing against the plain
    version of each planted fault: the band one key wider (position cur -
    4096 let in), one key narrower (cur - 4095 dropped), and one in-band
    entry of one row pointed at another row's block. Timed beside its plain
    version, its bound and one scaled_dot_product_attention call over each
    row's band gathered beforehand (4,112 keys a row, the rest masked).
    Then the same shape with NaN in the trash sink (every expired and pad
    entry) and two rows whose live keys are fewer than the launch's splits
    (frontiers 0 and 2): the kernel's output finite and within
    MISTRAL_K4_TOL of the plain version on the clean pool, so no split reads
    an expired entry and short rows join correctly."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(13)
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    t, window, bs = MISTRAL_K4_TOL, 4096, 16
    frontiers = np.sort(rng.integers(3000, 8001, size=8))
    q, kp, vp, table, cur = mistral_kernel_inputs(torch, gen, rng, frontiers, poison=False)

    def kernel():
        return pa.paged_decode_attention(q, kp, vp, table, cur, sliding_window=window)

    def plain():
        return pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err, over = flash_err(torch, got, want, t)
    check(bool(torch.isfinite(got).all()), "mistral K4 output finite")
    check(over <= 1.0, f"mistral K4 vs plain: error {over} x its tolerance (max_abs_err {err})")
    check(torch.equal(got, again), "mistral K4: two calls bit-equal")
    wrong = table.clone()
    lo7 = (int(cur[7]) - window + 1) // bs
    wrong[7, lo7 + 10] = table[6, (int(cur[6]) - window + 1) // bs]
    planted = {
        "edge_key_let_in": pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window + 1),
        "edge_key_dropped": pa.paged_decode_attention_plain(q, kp, vp, table, cur, sliding_window=window - 1),
        "wrong_in_band_block": pa.paged_decode_attention_plain(q, kp, vp, wrong, cur, sliding_window=window),
    }
    planted = {name: flash_err(torch, got, fault, t) for name, fault in planted.items()}
    for name, (_, fault_over) in planted.items():
        check(fault_over > 1.0, f"mistral K4 tolerance fails the planted fault {name} ({fault_over} x)")

    # the library yardstick: each row's band (257 blocks from its first in-band one) gathered contiguous
    band_blocks = window // bs + 1
    lo = torch.clamp(cur.long() - window + 1, min=0) // bs
    idx = lo[:, None] + torch.arange(band_blocks, device="cuda")[None]
    blocks = table.long().gather(1, idx.clamp(max=table.shape[1] - 1))
    kg = kp[blocks].reshape(8, band_blocks * bs, 8, 128).transpose(1, 2).contiguous()
    vg = vp[blocks].reshape(8, band_blocks * bs, 8, 128).transpose(1, 2).contiguous()
    pos = lo[:, None] * bs + torch.arange(band_blocks * bs, device="cuda")[None]
    mask = ((pos <= cur[:, None].long()) & (pos > cur[:, None].long() - window))[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, enable_gqa=True)

    lib_err = (library()[:, :, 0].float() - want.float()).abs().max().item()
    bound_ms, bound_by = kernel_bound(q, kp, table, cur, window)
    splits = pa._split_plan(8, 32, 8, bs, table.shape[1])[0]
    timing = {"ms": time_ms(torch, kernel, flush=flush), "plain_ms": time_ms(torch, plain, flush=flush),
              "library_ms": time_ms(torch, library, flush=flush)}

    short = frontiers.copy()
    short[0], short[1] = 0, 2
    pq, pkp, pvp, ptable, pcur = mistral_kernel_inputs(torch, gen, rng, short, poison=True)
    clean_k, clean_v = pkp.clone(), pvp.clone()
    clean_k[0] = 0.0
    clean_v[0] = 0.0
    pgot = pa.paged_decode_attention(pq, pkp, pvp, ptable, pcur, sliding_window=window)
    pwant = pa.paged_decode_attention_plain(pq, clean_k, clean_v, ptable, pcur, sliding_window=window)
    torch.cuda.synchronize()
    poison_err, poison_over = flash_err(torch, pgot, pwant, t)
    check(bool(torch.isfinite(pgot).all()), "mistral K4 with NaN in every expired and pad entry: output finite")
    check(poison_over <= 1.0,
          f"mistral K4 with NaN trash and short rows vs plain: error {poison_over} x its tolerance")
    row = {
        "phase": "kernel", "case": "mistral-band", "shape": [8, 32, 8, 128, bs, int(table.shape[1])],
        "window": window, "frontiers": frontiers.tolist(), "splits": splits, "max_abs_err": err, "tol": t,
        "err_over_tol": over,
        "planted_faults": {name: {"max_abs_err": e, "err_over_tol": o} for name, (e, o) in planted.items()},
        "library_max_abs_err": lib_err, **timing, "bound_ms": bound_ms, "bound_by": bound_by,
        "poisoned_trash": {"frontiers": short.tolist(), "max_abs_err": poison_err, "err_over_tol": poison_over},
    }
    emit(row)
    del flush, kg, vg
    free_memory(torch)
    return row


def mistral_engine(model, **kw):
    from accelerate_tpu_torch import ServingEngine

    return ServingEngine(model, **{**MISTRAL_ENGINE, "pool_blocks": MISTRAL_POOL, **kw})


def dense_forced(torch, model, prompt, served, rows=MISTRAL_ENGINE["max_len"], chunk=1024):
    """``generate``'s dense-cache path (the band as a mask; no K4, no block
    table) over a cache of ``rows`` rows, the prompt fed in ``chunk``-token
    pieces (``generate``'s one-shot prefill of a 7,900-token prompt would
    hold 33 GB of f32 scores against the model's 32,768 cache rows), then
    ``served`` one token at a time. For each served token, the reference's
    view of the position it fills: ``(argmax, top-2 logit gap, max logit
    minus the served token's, the served token's log-probability)``."""
    from accelerate_tpu_torch.ops.kv_cache import KVCache

    cfg = model.config
    cache = KVCache.empty(cfg, 1, rows, model.dtype, "cuda")
    ids = torch.as_tensor(np.asarray(prompt), device="cuda")[None].long()
    out = []
    with torch.no_grad():
        for s in range(0, ids.shape[1], chunk):
            part = ids[:, s : s + chunk]
            positions = torch.arange(s, s + part.shape[1], device="cuda")[None]
            logits, cache = model(part, positions=positions, decode=True, cache=cache)
        for i, tok in enumerate(int(t) for t in served):
            row = logits[0, -1].float()
            top2 = torch.topk(row, 2).values
            out.append((int(torch.argmax(row)), float(top2[0] - top2[1]), float(top2[0] - row[tok]),
                        float(torch.log_softmax(row, -1)[tok])))
            if i + 1 < len(served):
                positions = torch.tensor([[ids.shape[1] + i]], device="cuda")
                logits, cache = model(torch.tensor([[tok]], device="cuda"), positions=positions, decode=True,
                                      cache=cache)
    return out


def against_dense(torch, model, prompt, got, got_lps, rows=MISTRAL_ENGINE["max_len"]) -> tuple:
    """Served greedy tokens against the dense reference fed the same tokens
    (dense_forced): every served token is the reference's argmax, or within
    SERVE_BF16_GAP of its max logit (a near tie, where bf16 rounding in
    another place may pick the other token). ``(tokens compared, near ties
    taken, max logprob error)``."""
    ref = dense_forced(torch, model, prompt, got, rows=rows)
    near = 0
    for i, (tok, (top, _, behind, _)) in enumerate(zip(got, ref)):
        if int(tok) != top:
            check(behind < SERVE_BF16_GAP, f"token {i}: {int(tok)} is {behind} below the reference's max logit")
            near += 1
    return len(got), near, float(max(abs(lp - r[3]) for lp, r in zip(got_lps, ref)))


def against_run(torch, model, full, got, got_lps, want, want_lps, rows=MISTRAL_ENGINE["max_len"]) -> tuple:
    """One request's generated tokens in two engine runs: equal, but where
    they part the top-2 gap on the shared context (dense_forced's path)
    must be under SERVE_BF16_GAP. ``(tokens compared, parted at a near tie,
    max logprob difference over the tokens compared)``."""
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    n = int(diff[0]) if len(diff) else len(got)
    lp_diff = float(np.max(np.abs(np.asarray(got_lps[:n]) - np.asarray(want_lps[:n])))) if n else 0.0
    if len(diff):
        gap = dense_forced(torch, model, full, want[: n + 1], rows=rows)[n][1]
        check(gap < SERVE_BF16_GAP, f"runs part at token {n} with top-2 gap {gap}")
    return n, int(len(diff) > 0), lp_diff


def kv_bytes_per_token(cfg) -> int:
    """K and V of every layer for one position, in bf16."""
    return 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * (cfg.hidden_size // cfg.num_attention_heads) * 2


def phase_mistral_serve(torch, model):
    """Mistral-7B-v0.1 served by the paged engine (MISTRAL_ENGINE, greedy,
    a pool of 8 x 266 + 1 blocks, the windowed need): 12 prompts of
    300-7,900 tokens, 128 new each. Eight requests decode in one tick; free
    blocks rise during decode before any request retires (expiry behind the
    4096-key band); the pool drains; K4 launches == layers x decode steps. The
    300-, 2,500-, 5,000- and 7,900-token requests' 128 greedy tokens are
    held to the dense reference fed the same tokens (dense_forced over the
    engine's 8,192 rows; over generate's 32,768 it follows generate's
    tokens on the 300-token prompt), each its argmax or a near tie (within
    SERVE_BF16_GAP of its max logit), logprobs within SERVE_LP_LIMIT. The
    pool's high-water mark and the most slots a tick decoded come from the
    engine's metrics."""
    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = model.config
    mistral_engine(model).generate_many([np.arange(1, 9, dtype=np.int32), np.arange(1, 300, dtype=np.int32)], 9)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in MISTRAL_LENGTHS]
    max_new = 128
    free_memory(torch)
    eng = mistral_engine(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new) for p in prompts]
    freed_before_retire, prev_free = 0, None
    while eng.queue or eng.active_count:
        eng.step()
        if not eng.done and prev_free is not None and eng.pool_free_blocks > prev_free:
            freed_before_retire += eng.pool_free_blocks - prev_free
        prev_free = eng.pool_free_blocks
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches == cfg.num_hidden_layers * eng.decode_steps > 0,
          f"mistral serve: K4 launches {launches} == layers x decode steps {eng.decode_steps}")
    snap = eng.metrics.snapshot()
    check(snap["decode_slots_high_water"] == 8,
          f"mistral serve: eight requests decode in one tick ({snap['decode_slots_high_water']})")
    check(freed_before_retire > 0, "mistral serve: blocks freed by the band during decode before any retirement")
    check(eng.pool_free_blocks == MISTRAL_POOL - 1, f"mistral serve: pool drained ({eng.pool_free_blocks})")
    served = {}
    for uid, p in zip(uids, prompts):
        out, lps = eng.poll(uid), eng.logprobs(uid)
        check(out is not None and len(out) == len(p) + max_new and bool(np.isfinite(lps).all()),
              f"mistral serve: request {uid} complete, logprobs finite")
        served[len(p)] = (out[len(p):], lps)
    steps, prefill_tokens = eng.decode_steps, eng.prefill_tokens
    del eng
    free_memory(torch)

    short = prompts[0]
    gen_short = generate(model, short[None], max_new_tokens=16)[0, len(short):].cpu().numpy()
    ref_short = dense_forced(torch, model, short, gen_short, rows=cfg.max_position_embeddings)
    check(all(tok == ref[0] for tok, ref in zip(gen_short, ref_short)),
          "dense_forced over generate's 32,768 cache rows follows its greedy tokens on the 300-token request")
    checked = []
    for n in (300, 2500, 5000, 7900):
        compared, near, lp_err = against_dense(torch, model, prompts[MISTRAL_LENGTHS.index(n)], *served[n])
        check(lp_err <= SERVE_LP_LIMIT, f"mistral serve: {n}-token request's logprobs within {SERVE_LP_LIMIT} "
              f"of the dense reference's ({lp_err})")
        checked.append({"prompt": n, "tokens_compared": compared, "near_ties": near, "max_logprob_err": lp_err})
    free_memory(torch)
    row = {
        "phase": "mistral_serve", "config": "Mistral-7B-v0.1 shape, bf16, seeded random weights",
        "params": model.num_parameters(), "engine": MISTRAL_ENGINE, "pool_blocks": MISTRAL_POOL,
        "requests": len(prompts), "prompt_lengths": list(MISTRAL_LENGTHS), "max_new_tokens": max_new,
        "generated_tokens": snap["tokens_generated"], "wall_s": wall, "tokens_per_s": snap["tokens_generated"] / wall,
        "ttft_ms_mean": snap["ttft_ms_mean"], "ttft_ms_p50": snap["ttft_ms_p50"], "ttft_ms_p95": snap["ttft_ms_p95"],
        "itl_ms_p50": snap["itl_ms_p50"], "decode_steps": steps, "prefill_tokens": prefill_tokens,
        "kernel_launches": launches, "max_decoding_in_a_tick": snap["decode_slots_high_water"],
        "blocks_freed_before_first_retirement": freed_before_retire,
        "pool_high_water_blocks": snap["pool_high_water_blocks"],
        "pool_high_water_gb": snap["pool_high_water_blocks"] * 16 * kv_bytes_per_token(cfg) / 1e9,
        "pool_gb": MISTRAL_POOL * 16 * kv_bytes_per_token(cfg) / 1e9, "peak_memory_gb": peak, "reference": checked,
    }
    emit(row)
    return row


def drive(eng, submits, on_step=None):
    """Tick ``eng`` to the end. ``submits``: ``{tick: [(prompt, max_new,
    kwargs), ...]}``, submitted before that tick (0 first). Returns
    ``({(tick, i): uid}, {uid: TTFT ms})``, TTFT read on the host clock
    after each tick."""
    uids, sub_ts, ttft = {}, {}, {}
    tick = 0
    while True:
        for i, (p, n, kw) in enumerate(submits.get(tick, ())):
            uid = eng.submit(p, n, **kw)
            uids[(tick, i)], sub_ts[uid] = uid, time.perf_counter()
        if not (eng.queue or eng.active_count) and tick > max(submits):
            break
        eng.step()
        tick += 1
        now = time.perf_counter()
        for uid, t in sub_ts.items():
            if uid not in ttft and (uid in eng.done or len(eng.partial(uid))):
                ttft[uid] = (now - t) * 1e3
        if on_step is not None:
            on_step(eng)
    return uids, ttft


def phase_prefix_serve(torch, model):
    """A 1,536-token system prompt registered once (its 96 full blocks
    shared) on MISTRAL_ENGINE; 16 requests with its prefix_id (suffixes of
    16-512 tokens, and two of 3,000 whose band passes the shared blocks, so
    their references drop mid-decode), 128 new each; then the same 16 as
    full prompts on a fresh engine. Tokens equal up to a near tie (gap <
    SERVE_BF16_GAP on the shared context), logprobs within SERVE_LP_LIMIT;
    the engine's prefix counters; TTFT and prefill tokens each way;
    after unregister_prefix no refcount is left and the pool is full."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = model.config
    rng = np.random.default_rng(22)
    system = rng.integers(1, cfg.vocab_size, size=1536).astype(np.int32)
    lengths = [3000, 3000] + rng.integers(16, 513, size=14).tolist()
    suffixes = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    max_new = 128
    free_memory(torch)
    eng = mistral_engine(model)
    pa.launches = 0
    t0 = time.perf_counter()
    pid = eng.register_prefix(system)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    register_tokens = eng.prefill_tokens
    shared_blocks = len(eng._prefixes[pid]["block_ids"])
    refs = []

    def count_refs(e):
        if not e.done:
            refs.append(sum(e._shared_refs.values()))

    t0 = time.perf_counter()
    uids, ttft = drive(eng, {0: [(s, max_new, {"prefix_id": pid}) for s in suffixes]}, count_refs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    check(launches == cfg.num_hidden_layers * eng.decode_steps > 0,
          f"prefix serve: K4 launches {launches} == layers x decode steps {eng.decode_steps}")
    check(any(b < a for a, b in zip(refs, refs[1:])),
          "prefix serve: shared-block references dropped mid-decode, before any retirement")
    with_prefix = [(eng.poll(uids[(0, i)]), eng.logprobs(uids[(0, i)])) for i in range(len(suffixes))]
    snap = eng.metrics.snapshot()
    check(snap["prefix_registrations"] == 1 and snap["prefix_hits"] == len(suffixes)
          and snap["prefix_tokens_reused"] == len(suffixes) * len(system),
          f"prefix serve: the engine counted 1 registration and {len(suffixes)} hits of {len(system)} tokens "
          f"({snap['prefix_registrations']}, {snap['prefix_hits']}, {snap['prefix_tokens_reused']})")
    tokens_with, steps = eng.prefill_tokens - register_tokens, eng.decode_steps
    eng.unregister_prefix(pid)
    check(not eng._shared_refs and eng.pool_free_blocks == MISTRAL_POOL - 1,
          f"prefix serve: no reference left, pool full after unregister ({eng.pool_free_blocks})")
    del eng
    free_memory(torch)

    eng = mistral_engine(model)
    fulls = [np.concatenate([system, s]) for s in suffixes]
    pa.launches = 0
    t0 = time.perf_counter()
    uids2, ttft2 = drive(eng, {0: [(f, max_new, {}) for f in fulls]})
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2 = pa.launches
    check(launches2 == cfg.num_hidden_layers * eng.decode_steps,
          f"prefix serve (full prompts): K4 launches {launches2} == layers x decode steps")
    without = [(eng.poll(uids2[(0, i)]), eng.logprobs(uids2[(0, i)])) for i in range(len(suffixes))]
    snap2 = eng.metrics.snapshot()
    tokens_without, steps2 = eng.prefill_tokens, eng.decode_steps
    del eng
    free_memory(torch)

    compared = near = 0
    lp_diff = 0.0
    for full, (a, alp), (b, blp) in zip(fulls, with_prefix, without):
        check(np.array_equal(a[: len(full)], full) and np.array_equal(b[: len(full)], full),
              "prefix serve: outputs start with prefix + suffix")
        n, parted, d = against_run(torch, model, full, a[len(full):], alp, b[len(full):], blp)
        compared, near, lp_diff = compared + n, near + parted, max(lp_diff, d)
    check(compared > 0, "prefix serve: tokens compared")
    check(lp_diff <= SERVE_LP_LIMIT,
          f"prefix serve: logprobs within {SERVE_LP_LIMIT} of the full prompts' ({lp_diff})")
    row = {
        "phase": "prefix_serve", "config": "Mistral-7B-v0.1 shape, bf16; MISTRAL_ENGINE", "prefix_tokens": 1536,
        "shared_blocks": shared_blocks, "suffix_lengths": lengths, "max_new_tokens": max_new,
        "register_s": register_s, "register_prefill_tokens": register_tokens,
        "prefix_hits": snap["prefix_hits"], "prefix_tokens_reused": snap["prefix_tokens_reused"],
        "with_prefix": {"wall_s": wall, "ttft_ms_mean": float(np.mean(list(ttft.values()))),
                        "ttft_ms_mean_metrics": snap["ttft_ms_mean"], "prefill_tokens": tokens_with,
                        "tokens_per_s": snap["tokens_generated"] / wall, "decode_steps": steps,
                        "kernel_launches": launches},
        "full_prompts": {"wall_s": wall2, "ttft_ms_mean": float(np.mean(list(ttft2.values()))),
                         "ttft_ms_mean_metrics": snap2["ttft_ms_mean"], "prefill_tokens": tokens_without,
                         "tokens_per_s": snap2["tokens_generated"] / wall2, "decode_steps": steps2,
                         "kernel_launches": launches2},
        "tokens_compared": compared, "parted_at_near_tie": near, "max_logprob_diff": lp_diff,
        "kernel_launches": launches + launches2,
    }
    emit(row)
    return row


def note_resumes(marks: dict):
    """An ``on_step`` for drive: for each preempted request waiting in the
    queue, the count of tokens it had generated when it was evicted. Its
    resume recomputes all but the last of them and decodes on from there,
    so every later token is a post-resume one."""

    def on_step(eng):
        for req in eng.queue:
            if req.preempted and req.out_tokens:
                marks.setdefault(req.uid, set()).add(len(req.out_tokens))

    return on_step


def phase_preempt_serve(torch, model):
    """Four slots with SchedulerConfig(enable_preemption=True) on
    MISTRAL_ENGINE's settings: 6 priority-1 requests (prompts of 512-2,048
    tokens, 256 new), and after two ticks 4 priority-0 requests (64-256
    tokens, 64 new), which evict the youngest decodes; the victims resume
    by recompute. Every token of each resumed request is held to the dense
    reference fed the same tokens (dense_forced): its argmax or a near tie,
    logprobs within SERVE_LP_LIMIT; each resumed request's count of tokens
    compared after its resume is reported. Against a control run of the
    same schedule without preemption: every request's tokens equal up to a
    near tie, logprobs within SERVE_LP_LIMIT over the tokens compared;
    decode_preemptions >= 1 and resumes == decode_preemptions; K4 launches
    == layers x decode steps in each run; TTFT of each class each way and the
    recomputed tokens. Then max_queue_depth=2 on one slot: a third
    priority-1 submission raises the structured ShedError, a priority-0 one
    is taken."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.scheduling import SchedulerConfig, ShedError

    cfg = model.config
    rng = np.random.default_rng(23)
    low = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in rng.integers(512, 2049, size=6)]
    high = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in rng.integers(64, 257, size=4)]
    submits = {0: [(p, 256, {"priority": 1}) for p in low], 2: [(p, 64, {"priority": 0}) for p in high]}
    runs, outs, marks = {}, {}, {}
    for name, sched in (("preempt", SchedulerConfig(enable_preemption=True)), ("control", SchedulerConfig())):
        free_memory(torch)
        eng = mistral_engine(model, num_slots=4, pool_blocks=None, scheduler=sched)
        pa.launches = 0
        t0 = time.perf_counter()
        uids, ttft = drive(eng, submits, note_resumes(marks) if name == "preempt" else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(pa.launches == cfg.num_hidden_layers * eng.decode_steps,
              f"preempt serve ({name}): K4 launches {pa.launches} == layers x decode steps")
        check(eng.pool_free_blocks == eng._pcfg.num_blocks - 1, f"preempt serve ({name}): pool drained")
        outs[name] = {key: (uid, eng.poll(uid), eng.logprobs(uid)) for key, uid in uids.items()}
        snap = eng.metrics.snapshot()
        runs[name] = {
            "wall_s": wall, "kernel_launches": pa.launches, "decode_steps": eng.decode_steps,
            "decode_preemptions": snap["decode_preemptions"], "resumes": snap["resumes"],
            "recomputed_tokens": eng.recomputed_tokens, "prefill_tokens": eng.prefill_tokens,
            "ttft_ms_priority0": [ttft[uids[(2, i)]] for i in range(len(high))],
            "ttft_ms_priority1": [ttft[uids[(0, i)]] for i in range(len(low))],
            "tokens_per_s": snap["tokens_generated"] / wall,
        }
        del eng
    free_memory(torch)
    pre, ctl = runs["preempt"], runs["control"]
    check(pre["decode_preemptions"] >= 1 and pre["resumes"] == pre["decode_preemptions"],
          f"preempt serve: preemptions {pre['decode_preemptions']} >= 1, resumes {pre['resumes']} equal")
    check(sum(len(m) for m in marks.values()) == pre["decode_preemptions"],
          f"preempt serve: each preemption seen in the queue ({marks})")
    check(ctl["decode_preemptions"] == 0, "preempt serve: the control run preempts nothing")
    compared = near = 0
    lp_diff = 0.0
    resumed = []
    for key, (uid, out, lps) in outs["preempt"].items():
        _, c_out, c_lps = outs["control"][key]
        n_prompt = len(out) - len(lps)
        check(np.array_equal(out[:n_prompt], c_out[:n_prompt]), "preempt serve: same prompts")
        n, parted, d = against_run(torch, model, out[:n_prompt], out[n_prompt:], lps, c_out[n_prompt:], c_lps)
        compared, near, lp_diff = compared + n, near + parted, max(lp_diff, d)
        if uid in marks:
            n_ref, ties, lp_err = against_dense(torch, model, out[:n_prompt], out[n_prompt:], lps)
            after = len(lps) - min(marks[uid])
            check(after > 0 and lp_err <= SERVE_LP_LIMIT,
                  f"preempt serve: request {uid}'s {after} tokens after its resume compared, logprobs within "
                  f"{SERVE_LP_LIMIT} of the dense reference's ({lp_err})")
            resumed.append({"prompt": n_prompt, "generated": len(lps), "evicted_after": sorted(marks[uid]),
                            "tokens_compared": n_ref, "tokens_after_resume_compared": after, "near_ties": ties,
                            "max_logprob_err": lp_err})
    check(lp_diff <= SERVE_LP_LIMIT, f"preempt serve: logprobs within {SERVE_LP_LIMIT} of the control's ({lp_diff})")

    free_memory(torch)
    eng = mistral_engine(model, num_slots=1, pool_blocks=None, scheduler=SchedulerConfig(max_queue_depth=2))
    short = [rng.integers(1, cfg.vocab_size, size=32).astype(np.int32) for _ in range(4)]
    for p in short[:2]:
        eng.submit(p, 4, priority=1)
    shed = None
    try:
        eng.submit(short[2], 4, priority=1)
    except ShedError as err:
        shed = {"reason": err.reason, "priority": err.priority, "queue_depth": err.queue_depth, "message": str(err)}
    check(shed is not None and shed["priority"] == 1 and shed["queue_depth"] == 2 and
          "max_queue_depth" in shed["reason"], f"preempt serve: structured ShedError at depth 2 ({shed})")
    eng.submit(short[3], 4, priority=0)  # below the shed floor: taken
    eng.run()
    check(len(eng.done) == 3 and eng.metrics.requests_shed == 1, "preempt serve: the other three served")
    del eng
    free_memory(torch)
    row = {
        "phase": "preempt_serve", "config": "Mistral-7B-v0.1 shape, bf16; 4 slots, MISTRAL_ENGINE's settings",
        "low_prompts": [len(p) for p in low], "high_prompts": [len(p) for p in high],
        "preempt": pre, "control": ctl, "tokens_compared": compared, "parted_at_near_tie": near,
        "max_logprob_diff": lp_diff, "resumed_against_dense": resumed, "shed": shed,
        "kernel_launches": pre["kernel_launches"] + ctl["kernel_launches"],
    }
    emit(row)
    return row


def phase_sched(torch):
    """Mistral-7B-v0.1 at its widths, cut to SCHED_LAYERS layers (seeded
    random weights, bf16), built once and served by mistral_serve,
    prefix_serve and preempt_serve."""
    from accelerate_tpu_torch.models import MistralConfig, create_mistral_model

    free_memory(torch)
    t0 = time.perf_counter()
    model = create_mistral_model(MistralConfig.mistral_7b_v1(num_hidden_layers=SCHED_LAYERS), seed=0,
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    free_memory(torch)
    rows = {"mistral_serve": phase_mistral_serve(torch, model), "prefix_serve": phase_prefix_serve(torch, model),
            "preempt_serve": phase_preempt_serve(torch, model)}
    emit({"phase": "sched_model", "params": model.num_parameters(), "model_build_s": build_s})
    del model
    free_memory(torch)
    return rows


# ---------------------------------------------------------------------------
# the dense serving layout, speculative serving and beam search: Gemma-2-9B at
# full width, 14 of 42 layers (its softcaps, its 4096-key band on alternate layers)
# with a Gemma-2-2B draft; no kernel of the JAX package lies on these paths
# (the dense cache's attention is an einsum there as here)
# ---------------------------------------------------------------------------

# google/gemma-2-2b config.json, the draft: vocab 256,000, hidden 2,304, intermediate 9,216, 26 layers, 8/4
# heads, head dim 256, query_pre_attn_scalar 256, sliding_window 4,096, softcaps 50/30, tied embeddings (the
# rest Gemma2Config's defaults, which are google/gemma-2-9b's config.json: Gemma2Config.gemma2_9b())
GEMMA2_2B = dict(hidden_size=2304, intermediate_size=9216, num_hidden_layers=26, num_attention_heads=8,
                 num_key_value_heads=4, head_dim=256, query_pre_attn_scalar=256.0, sliding_window=4096)
# Gemma-2-9B's 42 layers cut to 14 and the draft's 26 to 8 (widths, softcaps and the alternating band kept)
# since PR 15, for the script's 1,200 s: the group's serving phases took 151 s of a 1,035 s run at full depth
DENSE_TARGET_LAYERS, DENSE_DRAFT_LAYERS = 14, 8
DENSE_ENGINE = dict(num_slots=8, prompt_buckets=(256, 2048), tick_block=8, max_len=4096)
DENSE_LENGTHS = (16, 128, 200, 333, 512, 700, 1000, 1234, 1500, 1750, 1900, 2000)
DENSE_LONG = 3000  # past the largest bucket: chunked prefill, plain serving only (speculation takes bucket-sized)
DENSE_NEW = 64
DENSE_CHECKED = (16, 512, 1234, 2000)  # gemma2_serve's requests held to the teacher-forced dense reference
DENSE_GENERATE_PROMPT, DENSE_BEAM_PROMPT = 512, 128  # speculative_generate's prompt and beam_search's
DENSE_GAMMA = 4


def dense_prompts(seed: int, vocab: int) -> tuple:
    """The dense group's prompt set, made from ``seed``: 12 prompts of
    DENSE_LENGTHS tokens and one of DENSE_LONG."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32) for n in DENSE_LENGTHS]
    return prompts, rng.integers(1, vocab, size=DENSE_LONG).astype(np.int32)


def kernel_kind(name: str) -> str:
    n = name.lower()
    for kind, keys in (("gemm", ("gemm", "xmma", "cutlass", "matmul", "nvjet")), ("softmax", ("softmax",)),
                       ("copy", ("copy", "cat")), ("index", ("index", "scatter", "gather")),
                       ("reduce", ("reduce",))):
        if any(k in n for k in keys):
            return kind
    return "elementwise"


def dense_tick_profile(torch, model, prompts) -> dict:
    """One dense decode tick (8 slots decoding 200-token prompts, 8 steps)
    timed without the profiler, the next traced (``traced``): the device's
    busy time, its idle share, and the busy time by kernel kind."""
    from accelerate_tpu_torch import ServingEngine

    eng = ServingEngine(model, **DENSE_ENGINE)
    for p in prompts[-8:]:
        eng.submit(p[:200], DENSE_NEW)
    eng.step()  # admits and prefills all 8, then one tick
    eng.step()  # a warm tick
    check(all(ph == "decode" for ph in eng.slot_phase), "dense profile: all 8 slots decoding")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events, traced_ms, attempts, lost = traced(torch, eng.step)
    by_name, by_kind = {}, {}
    for ev in events:
        ms = ev.time_range.elapsed_us() / 1e3
        t, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (t + ms, n + 1)
        by_kind[kernel_kind(ev.name)] = by_kind.get(kernel_kind(ev.name), 0.0) + ms
    busy = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    del eng
    free_memory(torch)
    return {"what": "one dense decode tick, 8 slots x 8 steps, 200-token prompts", "tick_wall_ms": wall_ms,
            "tick_wall_ms_profiled": traced_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "busy_ms_by_kind": by_kind, "kernels_traced": len(events), "trace_attempts": attempts,
            "trace_lead_lost": lost, "top": [[name[:80], ms, n] for name, (ms, n) in top]}


def phase_gemma2_serve(torch, model, prompts, long_prompt):
    """Gemma-2-9B served on the dense layout (DENSE_ENGINE, greedy, 64 new):
    the 12 prompts and the 3,000-token one (chunked prefill). Eight
    requests decode in one tick; every request completes with finite
    logprobs; DENSE_CHECKED's requests are held token by token to the
    dense reference fed the same tokens (dense_forced over the engine's
    4,096 rows): each its argmax or within SERVE_BF16_GAP of its max logit,
    logprobs within SERVE_LP_LIMIT. One tick traced for its time split."""
    from accelerate_tpu_torch import ServingEngine

    ServingEngine(model, **DENSE_ENGINE).generate_many([prompts[0], prompts[3]], 9)  # warm-up
    free_memory(torch)
    eng = ServingEngine(model, **DENSE_ENGINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    every = prompts + [long_prompt]
    uids = [eng.submit(p, DENSE_NEW) for p in every]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    snap = eng.metrics.snapshot()
    check(eng.pool_free_blocks is None and snap["kv_block_utilization"] is None, "gemma2 serve: the dense layout")
    check(snap["decode_slots_high_water"] == 8, f"gemma2 serve: eight decode in one tick ({snap['decode_slots_high_water']})")
    served = {}
    for uid, p in zip(uids, every):
        out, lps = eng.poll(uid), eng.logprobs(uid)
        check(out is not None and len(out) == len(p) + DENSE_NEW and bool(np.isfinite(lps).all()),
              f"gemma2 serve: request {uid} complete, logprobs finite")
        served[len(p)] = (out[len(p):], lps)
    steps, forwards, prefill_tokens = eng.decode_steps, eng.prefill_forwards, eng.prefill_tokens
    del eng
    free_memory(torch)
    checked = []
    for n in DENSE_CHECKED:
        compared, near, lp_err = against_dense(torch, model, prompts[DENSE_LENGTHS.index(n)], *served[n],
                                               rows=DENSE_ENGINE["max_len"])
        check(lp_err <= SERVE_LP_LIMIT, f"gemma2 serve: {n}-token request's logprobs within {SERVE_LP_LIMIT} ({lp_err})")
        checked.append({"prompt": n, "tokens_compared": compared, "near_ties": near, "max_logprob_err": lp_err})
    profile = dense_tick_profile(torch, model, prompts)
    row = {
        "phase": "gemma2_serve", "config": "Gemma-2-9B shape, bf16, seeded random weights, dense layout",
        "params": model.num_parameters(), "engine": DENSE_ENGINE, "requests": len(every),
        "prompt_lengths": [len(p) for p in every], "max_new_tokens": DENSE_NEW,
        "generated_tokens": snap["tokens_generated"], "wall_s": wall, "tokens_per_s": snap["tokens_generated"] / wall,
        "ttft_ms_mean": snap["ttft_ms_mean"], "ttft_ms_p50": snap["ttft_ms_p50"], "ttft_ms_p95": snap["ttft_ms_p95"],
        "itl_ms_p50": snap["itl_ms_p50"], "decode_steps": steps, "prefill_forwards": forwards,
        "prefill_tokens": prefill_tokens, "peak_memory_gb": peak, "reference": checked, "tick": profile,
    }
    emit(row)
    return row, served


def phase_gemma2_spec_serve(torch, target, draft, prompts, plain):
    """The same engine with the Gemma-2-2B draft (gamma 4) on the 12
    prompts: each request's tokens those of gemma2_serve for its prompt,
    parting only where the plain stream's top-2 gap is under SERVE_BF16_GAP
    (against_run), logprobs within SERVE_LP_LIMIT over the tokens compared.
    spec_stats and the target forwards for each token are reported, not
    gated: two unrelated random-weight models agree on next to nothing."""
    from accelerate_tpu_torch import ServingEngine

    kw = dict(DENSE_ENGINE, draft_model=draft, gamma=DENSE_GAMMA)
    ServingEngine(target, **kw).generate_many([prompts[0], prompts[3]], 9)  # warm-up
    free_memory(torch)
    eng = ServingEngine(target, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    uids = [eng.submit(p, DENSE_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    snap, stats = eng.metrics.snapshot(), dict(eng.spec_stats)
    steps, forwards = eng.decode_steps, eng.prefill_forwards
    outs = [(eng.poll(u), eng.logprobs(u)) for u in uids]
    del eng
    free_memory(torch)
    compared = parted = 0
    lp_diff = 0.0
    for p, (out, lps) in zip(prompts, outs):
        check(out is not None and len(out) == len(p) + DENSE_NEW, "gemma2 spec serve: request complete")
        n, part, d = against_run(torch, target, p, out[len(p):], lps, *plain[len(p)], rows=DENSE_ENGINE["max_len"])
        compared, parted, lp_diff = compared + n, parted + part, max(lp_diff, d)
    check(lp_diff <= SERVE_LP_LIMIT, f"gemma2 spec serve: logprobs within {SERVE_LP_LIMIT} of plain serving ({lp_diff})")
    row = {
        "phase": "gemma2_spec_serve", "config": "Gemma-2-9B target, Gemma-2-2B draft, bf16, seeded random weights",
        "draft_params": draft.num_parameters(), "gamma": DENSE_GAMMA, "requests": len(prompts),
        "generated_tokens": snap["tokens_generated"], "wall_s": wall, "tokens_per_s": snap["tokens_generated"] / wall,
        "ttft_ms_mean": snap["ttft_ms_mean"], "ttft_ms_p50": snap["ttft_ms_p50"], "ttft_ms_p95": snap["ttft_ms_p95"],
        "itl_ms_p50": snap["itl_ms_p50"], "spec_stats": stats,
        "accept_rate": stats["accepted"] / max(1, DENSE_GAMMA * stats["steps"]),
        "tokens_per_slot_iteration": stats["emitted"] / max(1, stats["steps"]),
        "target_forwards_per_token": (forwards + steps) / snap["tokens_generated"],
        "tokens_compared_with_plain": compared, "parted_at_near_tie": parted, "max_logprob_diff": lp_diff,
        "peak_memory_gb": peak,
    }
    emit(row)
    return row


def phase_gemma2_self_spec(torch, target, prompts):
    """The target as its own draft (gamma 4) on 4 requests (16-2,000
    tokens, 61 new: the prefill's token and 12 full iterations): the
    acceptance rate is at least 0.9, and every rejection falls at a verify
    row whose top-2 gap is under SERVE_BF16_GAP (the draft's one-token
    forward and the verify forward round bf16 in other places). The verify
    forwards' top-2 gaps are read by wrapping the engine's step around a
    target that records them."""
    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.speculative import build_spec_step

    eng = ServingEngine(target, draft_model=target, gamma=DENSE_GAMMA, **DENSE_ENGINE)
    gaps, rejections = [], []

    def recording_target(ids, **kw):
        logits, cache = target(ids, **kw)
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append(top2[..., 0] - top2[..., 1])  # [slots, gamma + 1]
        return logits, cache

    core = build_spec_step(recording_target, target, DENSE_GAMMA)

    def spec_step(t_cache, d_cache, last, pos):
        emit_, lps, n_emit = core(t_cache, d_cache, last, pos)
        live = [s for s, ph in enumerate(eng.slot_phase) if ph == "decode"]
        for s in live:
            n_acc = int(n_emit[s]) - 1
            if n_acc < DENSE_GAMMA:
                rejections.append(float(gaps[-1][s, n_acc]))
        return emit_, lps, n_emit

    eng._spec_step = spec_step
    chosen = [prompts[DENSE_LENGTHS.index(n)] for n in DENSE_CHECKED]
    n_new = 1 + 12 * (DENSE_GAMMA + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate_many(chosen, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(eng.spec_stats)
    rate = stats["accepted"] / max(1, DENSE_GAMMA * stats["steps"])
    check(all(len(o) == len(p) + n_new for o, p in zip(outs, chosen)), "gemma2 self spec: requests complete")
    check(rate >= 0.9, f"gemma2 self spec: acceptance {rate} >= 0.9 ({stats})")
    worst = max(rejections, default=0.0)
    check(worst < SERVE_BF16_GAP, f"gemma2 self spec: every rejection at a top-2 gap under {SERVE_BF16_GAP} ({worst})")
    row = {"phase": "gemma2_self_spec", "config": "Gemma-2-9B as its own draft, bf16", "gamma": DENSE_GAMMA,
           "prompts": list(DENSE_CHECKED), "max_new_tokens": n_new, "spec_stats": stats, "accept_rate": rate,
           "tokens_per_target_forward": stats["emitted"] / max(1, stats["steps"]), "rejections": len(rejections),
           "max_rejection_gap": worst, "wall_s": wall}
    del eng
    free_memory(torch)
    emit(row)
    return row


def phase_gemma2_spec_generate(torch, target, draft, prompt):
    """``speculative_generate`` with the Gemma-2-2B draft (gamma 4) on the
    512-token prompt, 64 new, against ``generate``: tokens equal up to a
    near tie (where they part, the top-2 gap of generate's context under
    SERVE_BF16_GAP), both timed; its stats reported."""
    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.speculative import speculative_generate

    ids = prompt[None]
    generate(target, ids, max_new_tokens=4)  # warm-ups
    speculative_generate(target, draft, ids, max_new_tokens=4, gamma=DENSE_GAMMA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = generate(target, ids, max_new_tokens=DENSE_NEW)[0, len(prompt):].cpu().numpy()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, stats = speculative_generate(target, draft, ids, max_new_tokens=DENSE_NEW, gamma=DENSE_GAMMA,
                                      return_stats=True)
    got = got[0, len(prompt):].cpu().numpy()
    spec_s = time.perf_counter() - t0
    diff = np.nonzero(got != want)[0]
    n = int(diff[0]) if len(diff) else len(want)
    if len(diff):
        gap = dense_forced(torch, target, prompt, want[: n + 1])[n][1]
        check(gap < SERVE_BF16_GAP, f"speculative_generate parts from generate at token {n} with top-2 gap {gap}")
    row = {"phase": "gemma2_spec_generate", "prompt": len(prompt), "max_new_tokens": DENSE_NEW, "gamma": DENSE_GAMMA,
           "stats": stats, "tokens_equal": n, "parted_at_near_tie": int(len(diff) > 0),
           "generate_s": plain_s, "speculative_s": spec_s}
    emit(row)
    return row


def phase_gemma2_beam(torch, target, prompt):
    """``beam_search`` on the 128-token prompt, 32 new, length_penalty 1:
    num_beams=1 equals greedy ``generate`` up to a near tie; with 4 beams
    the reported score equals the teacher-forced log-probability of the
    returned tokens over their count (one forward, no cache) within
    SERVE_LP_LIMIT, and is no lower than greedy's, so computed, less that
    tolerance."""
    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.generation import beam_search

    ids, n_new, n_prompt = prompt[None], 32, len(prompt)

    def forced_mean(seq):
        with torch.no_grad():
            logp = torch.log_softmax(target(seq.long()).float(), dim=-1)[0]
        picked = logp[n_prompt - 1 : -1].gather(-1, seq[0, n_prompt:, None].long())
        return float(picked.sum()) / n_new

    greedy = generate(target, ids, max_new_tokens=n_new)
    one = beam_search(target, ids, max_new_tokens=n_new, num_beams=1)
    want, got = greedy[0, n_prompt:].cpu().numpy(), one[0, n_prompt:].cpu().numpy()
    diff = np.nonzero(got != want)[0]
    if len(diff):
        gap = dense_forced(torch, target, prompt, want[: int(diff[0]) + 1])[int(diff[0])][1]
        check(gap < SERVE_BF16_GAP, f"beam 1 parts from greedy at token {int(diff[0])} with top-2 gap {gap}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, score = beam_search(target, ids, max_new_tokens=n_new, num_beams=4, length_penalty=1.0, return_scores=True)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    score = float(score[0])
    forced, greedy_mean = forced_mean(out), forced_mean(greedy)
    check(abs(score - forced) <= SERVE_LP_LIMIT, f"beam score {score} vs teacher-forced {forced}")
    check(score >= greedy_mean - SERVE_LP_LIMIT, f"beam score {score} below greedy's {greedy_mean}")
    row = {"phase": "gemma2_beam", "prompt": n_prompt, "max_new_tokens": n_new, "num_beams": 4,
           "beam1_tokens_equal_greedy": int(diff[0]) if len(diff) else n_new, "score": score,
           "teacher_forced_score": forced, "greedy_score": greedy_mean, "beam_s": beam_s}
    emit(row)
    return row


def stream_vs_cpu(torch, cpu, prompt, want, got, want_lps, got_lps, what) -> tuple:
    """One request's tokens on the card against the CPU's: equal, a
    comparison ending only at a top-2 gap under 1e-3 of the CPU's forward
    on the shared context; logprobs within 1e-4 over the tokens compared.
    ``(tokens compared, stopped at a near tie)``."""
    diff = np.nonzero(want != got)[0]
    n = int(diff[0]) if len(diff) else len(want)
    if len(diff):
        with torch.no_grad():
            row = cpu(torch.as_tensor(np.concatenate([prompt, want[:n]])[None]).long())[0, -1]
        top2 = torch.topk(row, 2).values
        check(float(top2[0] - top2[1]) < 1e-3, f"{what}: card token {n} differs from the CPU's")
    err = float(np.max(np.abs(np.asarray(want_lps[:n]) - np.asarray(got_lps[:n])))) if n else 0.0
    check(err <= 1e-4, f"{what}: logprobs within 1e-4 of the CPU's ({err})")
    return n, int(len(diff) > 0)


def phase_dense_consistency(torch):
    """2-layer f32 cuts of TinyLlama's and Gemma-2-9B's widths, built on the
    CPU and copied to the card, each with a 1-layer cut as its draft: the
    dense engine plain (a 100-token prompt through chunk windows) and
    speculative (gamma 3), and beam search (2 prompts, 3 beams), on the card
    and on the CPU: tokens equal (stream_vs_cpu), logprobs and beam scores
    within 1e-4."""
    import copy

    from accelerate_tpu_torch import LlamaConfig, ServingEngine
    from accelerate_tpu_torch.generation import beam_search
    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models import Gemma2Config
    from accelerate_tpu_torch.models.llama import create_llama_model

    rows = []
    rng = np.random.default_rng(15)
    for name, cfg, dcfg in (
        ("tinyllama", LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 2}),
         LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 1})),
        ("gemma2_9b", Gemma2Config.gemma2_9b(num_hidden_layers=2), Gemma2Config.gemma2_9b(num_hidden_layers=1)),
    ):
        t0 = time.perf_counter()
        cpu, dcpu = create_llama_model(cfg, seed=5, device="cpu"), create_llama_model(dcfg, seed=6, device="cpu")
        card, dcard = (Model(copy.deepcopy(m.module).to("cuda"), m.config, name=m.name) for m in (cpu, dcpu))
        prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 40, 100)]
        kw = dict(num_slots=2, prompt_buckets=(16, 64), tick_block=4, max_len=512)
        row = {"model": name, "params": cpu.num_parameters(), "draft_params": dcpu.num_parameters()}
        for mode, extra, ps in (("plain", {}, prompts), ("speculative", {"gamma": 3}, prompts[:2])):
            outs = []
            for dev, m, d in (("cpu", cpu, dcpu), ("cuda", card, dcard)):
                eng = ServingEngine(m, device=dev, draft_model=d if extra else None, **kw, **extra)
                uids = [eng.submit(p, 12) for p in ps]
                eng.run()
                outs.append([(eng.poll(u)[len(p):], eng.logprobs(u)) for u, p in zip(uids, ps)])
            compared = near = 0
            for p, (w, wl), (g, gl) in zip(ps, *outs):
                n, tie = stream_vs_cpu(torch, cpu, p, w, g, wl, gl, f"{name} {mode}")
                compared, near = compared + n, near + tie
            row[mode] = {"prompts": [len(p) for p in ps], "tokens_compared": compared, "stopped_at_near_tie": near}
        ids = np.stack([prompts[1][:16], prompts[2][:16]])
        want, want_score = beam_search(cpu, ids, max_new_tokens=8, num_beams=3, return_scores=True)
        got, score = beam_search(card, ids, max_new_tokens=8, num_beams=3, return_scores=True)
        check(np.array_equal(got.cpu().numpy(), want.numpy()), f"{name} beam: card tokens equal the CPU's")
        err = float((score.cpu() - want_score).abs().max())
        check(err <= 1e-4, f"{name} beam: scores within 1e-4 of the CPU's ({err})")
        row.update(beam_score_err=err, seconds=time.perf_counter() - t0)
        rows.append(row)
        del cpu, dcpu, card, dcard
        free_memory(torch)
    row = {"phase": "dense_consistency", "models": rows}
    emit(row)
    return row


def phase_dense(torch, seed: int):
    """Gemma-2-9B and the Gemma-2-2B draft at their widths, cut to
    DENSE_TARGET_LAYERS and DENSE_DRAFT_LAYERS layers (seeded random
    weights, bf16), built once, for gemma2_serve, gemma2_spec_serve,
    gemma2_spec_generate, gemma2_self_spec and gemma2_beam on one prompt
    set made from ``seed``; then dense_consistency."""
    from accelerate_tpu_torch.models import Gemma2Config, create_gemma2_model

    t_group = time.perf_counter()
    free_memory(torch)
    t0 = time.perf_counter()
    target = create_gemma2_model(Gemma2Config.gemma2_9b(num_hidden_layers=DENSE_TARGET_LAYERS), seed=0,
                                 dtype=torch.bfloat16)
    draft = create_gemma2_model(Gemma2Config(**{**GEMMA2_2B, "num_hidden_layers": DENSE_DRAFT_LAYERS}), seed=1,
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    free_memory(torch)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    params = {"params": target.num_parameters(), "draft_params": draft.num_parameters()}
    prompts, long_prompt = dense_prompts(seed, target.config.vocab_size)
    rows = {}
    rows["gemma2_serve"], plain = phase_gemma2_serve(torch, target, prompts, long_prompt)
    rows["gemma2_spec_serve"] = phase_gemma2_spec_serve(torch, target, draft, prompts, plain)
    rows["gemma2_spec_generate"] = phase_gemma2_spec_generate(torch, target, draft,
                                                              prompts[DENSE_LENGTHS.index(DENSE_GENERATE_PROMPT)])
    del draft
    free_memory(torch)
    rows["gemma2_self_spec"] = phase_gemma2_self_spec(torch, target, prompts)
    rows["gemma2_beam"] = phase_gemma2_beam(torch, target, prompts[DENSE_LENGTHS.index(DENSE_BEAM_PROMPT)])
    emit({"phase": "dense_models", **params, "model_build_s": build_s, "weights_gb": weights_gb, "seed": seed})
    del target
    free_memory(torch)
    rows["dense_consistency"] = phase_dense_consistency(torch)
    emit({"phase": "dense_group", "seconds": time.perf_counter() - t_group})
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


def bert_accelerator(torch, mixed_precision, cpu=False, project_dir=None):
    """A fresh Accelerator; bf16 takes bench.py's policy, the softmax in bf16;
    with ``project_dir`` it checkpoints there with automatic naming."""
    from accelerate_tpu_torch import Accelerator, MixedPrecisionPolicy, ProjectConfiguration
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    handlers = [MixedPrecisionPolicy(softmax_dtype="bfloat16")] if mixed_precision == "bf16" else None
    project = ProjectConfiguration(project_dir=project_dir, automatic_checkpoint_naming=True) if project_dir else None
    return Accelerator(mixed_precision=mixed_precision, kwargs_handlers=handlers, cpu=cpu, project_config=project)


def bert_step_flops(module, tokens: int) -> float:
    """bench.py's _bert_step_flops: 6 x non-embedding params x tokens."""
    return 6.0 * sum(p.numel() for name, p in module.named_parameters() if "embed" not in name) * tokens


def phase_bert_finetune(torch, mixed_precision="bf16"):
    """examples/torch_nlp_example.py's loop on the card: BERT-base at full
    width and depth (seeded random weights), f32 masters and bf16 compute
    with the softmax in bf16 (``mixed_precision="fp8"``: the fp8 policy,
    every encoder dense layer's product in fp8, the softmax in f32; phase
    ``fp8_bert``), AdamW(2e-5, weight decay 0.01) decaying
    linearly, SyntheticMRPC(n=3668) at seq 128 through prepare_data_loader
    (batch 32, shuffled, seed 42): one epoch of 115 steps, the last batch
    20 real rows wrapped round to 32. Then the example's eval pass, whose
    gather_for_metrics must give back exactly 3668 predictions. The host
    time the loader takes to hand over each batch is read around each
    ``next``; three more steps on the epoch's last batches run under
    torch.profiler (``traced``) for the device's idle share."""
    from accelerate_tpu_torch import BertConfig, bert_classification_loss, create_bert_model, prepare_data_loader
    from accelerate_tpu_torch.ops import fp8

    example = bert_example()
    seq, batch_size, n = 128, 32, 3668
    free_memory(torch)  # earlier phases' models sit in reference cycles: out of this phase's peak
    acc = bert_accelerator(torch, mixed_precision)
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
    fp8.launches = 0

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
    fp8_launches = fp8.launches
    events, wall_ms, attempts, lost = traced(torch, lambda: [step(batch) for batch in last_batches])
    busy, _ = device_time(events)
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(all(np.isfinite(losses)), f"bert_finetune losses finite: {losses}")
    check(last < first, f"bert_finetune: mean of the last ten losses {last} < the first ten's {first}")
    check(n_steps == 115 and ends == [False] * 114 + [True],
          f"end_of_dataloader on the last of {n_steps} batches only")
    check(total == n, f"gather_for_metrics gave {total} predictions for {n} rows")
    check(on_card, "every batch arrived as CUDA tensors")
    # fp8: 6 dense layers a layer, each product forward, dlhs and drhs a train step and forward an eval batch
    want_fp8 = 6 * cfg.num_hidden_layers * (3 * n_steps + n_steps) if mixed_precision == "fp8" else 0
    check(fp8_launches == want_fp8, f"fp8 products launched {fp8_launches} times, want {want_fp8}")
    precision = "bf16 softmax" if mixed_precision == "bf16" else "fp8 dense products (dynamic recipe), f32 softmax"
    row = {
        "phase": "bert_finetune" if mixed_precision == "bf16" else f"{mixed_precision}_bert",
        "config": f"bert-base-uncased shape, seeded random weights, f32 masters + bf16 compute, {precision}",
        "fp8_launches": fp8_launches, "params": model.num_parameters(), "batch": batch_size, "seq": seq, "rows": n,
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


def ckpt_workdir() -> Path:
    """A fresh directory for one phase's checkpoints, in the checkout's
    git-ignored ``build/``; the phase removes it."""
    base = Path(__file__).resolve().parent / "build"
    base.mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=base))


def host_state(torch, model, opt) -> dict:
    """``{name: (CPU copy, device type)}`` of every parameter and every
    optimizer state tensor (``opt/<param index>/<key>``)."""
    tensors = {f"param/{k}": v for k, v in model.state_dict().items()}
    for i, state in opt.optimizer.state_dict()["state"].items():
        tensors.update({f"opt/{i}/{k}": v for k, v in state.items() if torch.is_tensor(v)})
    return {k: (v.detach().to("cpu", copy=True), v.device.type) for k, v in tensors.items()}


def check_restored(torch, saved: dict, model, opt, what: str) -> dict:
    """Every restored tensor bit-equal to its copy taken at the save, on the
    device it was on then, and on the card but for AdamW's ``step`` counts
    (torch keeps those on the CPU unless the optimizer is capturable or
    fused, in the unbroken run as after a load)."""
    got = host_state(torch, model, opt)
    check(got.keys() == saved.keys(), f"{what}: restored tensor names == saved ({len(got)} vs {len(saved)})")
    unequal = [k for k in saved if not torch.equal(got[k][0], saved[k][0])]
    moved = [k for k in saved if got[k][1] != saved[k][1]]
    off_card = [k for k in saved if got[k][1] != "cuda" and not k.endswith("/step")]
    check(not unequal, f"{what}: restored tensors bit-equal to the saved ones ({unequal[:3]} differ)")
    check(not moved and not off_card, f"{what}: restored tensors on their devices, on cuda ({moved[:3]}, {off_card[:3]})")
    return {"tensors": len(got), "on_cuda": sum(d == "cuda" for _, d in got.values()),
            "adamw_step_counts_on": sorted({d for k, (_, d) in got.items() if k.endswith("/step")})}


def params_cpu(model) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def run_continuation(torch, step, batches) -> tuple[list, list]:
    """The losses of ``step`` over ``batches`` and a digest of each batch's
    ``input_ids`` (what was trained on, in order)."""
    losses, digests = [], []
    for batch in batches:
        digests.append(hashlib.sha256(batch["input_ids"].cpu().numpy().tobytes()).hexdigest()[:16])
        losses.append(step(batch))
    return [float(x) for x in losses], digests


def continuation_verdict(a, b, b2, what: str) -> dict:
    """Holds the resumed continuation ``b`` to the unbroken ``a`` (each
    ``(losses, params)``) by the repeat ``b2``, a second load and run from the
    same checkpoint: if ``b`` and ``b2`` are bit-equal, ``b`` must equal ``a``
    bit for bit; otherwise ``a`` and ``b`` may differ by at most twice the
    spread between ``b`` and ``b2``."""
    def gap(x, y) -> float:
        loss = max(abs(p - q) for p, q in zip(x[0], y[0], strict=True))
        return max([loss] + [float((x[1][k] - y[1][k]).abs().max()) for k in x[1]])

    def bit_equal(x, y) -> bool:
        return x[0] == y[0] and x[1].keys() == y[1].keys() and all(x[1][k].equal(y[1][k]) for k in x[1])

    repeat_equal, spread = bit_equal(b, b2), gap(b, b2)
    resumed_equal, resumed_gap = bit_equal(a, b), gap(a, b)
    if repeat_equal:
        check(resumed_equal, f"{what}: the repeat is bit-equal, so the resumed run must be bit-equal to the "
                             f"unbroken one (gap {resumed_gap})")
    else:
        check(resumed_gap <= 2 * spread, f"{what}: resumed vs unbroken {resumed_gap} <= 2 x repeat spread {spread}")
    return {"repeat_bit_equal": repeat_equal, "repeat_spread": spread, "resumed_bit_equal": resumed_equal,
            "resumed_gap": resumed_gap}


def flagged_nondeterministic_ops(torch, run) -> list:
    """What torch names as nondeterministic on the card while ``run`` (one
    more step) runs under ``use_deterministic_algorithms(True, warn_only=True)``,
    which warns for each such op instead of raising."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:200] for w in caught if "determinis" in str(w.message)})


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def resume_checks(torch, acc, model, opt, saved, want_dir, steps, what) -> tuple[dict, float]:
    """Auto-resume in a fresh trainer: lands on ``want_dir``, every tensor
    restored, the step restored, the manifest deep-verifies. Returns the
    restore's checks and its seconds."""
    from accelerate_tpu_torch.ft import verify_manifest

    t0 = time.perf_counter()
    src = acc.load_state()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(src == want_dir, f"{what}: auto-resume found {src}, the newest checkpoint is {want_dir}")
    restored = check_restored(torch, saved, model, opt, what)
    check(acc.step == steps, f"{what}: step {acc.step} restored == {steps}")
    check(verify_manifest(src, deep=True) == [], f"{what}: the manifest deep-verifies")
    return restored, load_s


def phase_bert_resume(torch):
    """bert_finetune's configuration (BERT-base at full width and depth,
    bf16 compute with the softmax in bf16, batch 32 x 128,
    SyntheticMRPC(n=3668), AdamW decaying linearly, checkpointing into a
    temporary project directory with automatic naming): 40 steps into the
    epoch, then a synchronous save (checkpoint_0) and an async one
    (checkpoint_1) whose writes run while continuation A takes 20 more
    steps, then its drain. A fresh Accelerator auto-resumes (checkpoint_1:
    the async save, taken before A's steps updated the tensors in place)
    and runs the same 20 steps (B), through the loader's restored
    position; a second fresh load and run gives the repeat. Each restored
    tensor must equal its copy from the save, bit for bit, and sit on the
    card; B's batches must be A's; B is held to A by the repeat
    (:func:`continuation_verdict`)."""
    import itertools

    from accelerate_tpu_torch import BertConfig, bert_classification_loss, create_bert_model, prepare_data_loader

    example = bert_example()
    seq, batch_size, n, before, after = 128, 32, 3668, 40, 20

    def trainer(project_dir):
        acc = bert_accelerator(torch, "bf16", project_dir=project_dir)
        cfg = BertConfig.base()
        dataset = example.SyntheticMRPC(n=n, seq_len=seq, vocab_size=cfg.vocab_size)
        model = create_bert_model(cfg, seq_len=seq)
        optimizer = torch.optim.AdamW(model.module.parameters(), lr=2e-5, weight_decay=0.01)
        total_steps = len(dataset) // batch_size
        schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: max(0.0, 1.0 - s / total_steps))
        loader = prepare_data_loader(dataset, batch_size=batch_size, shuffle=True, seed=42)
        model, optimizer, loader, schedule = acc.prepare(model, optimizer, loader, schedule)
        step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
        return acc, model, optimizer, loader, step

    workdir = ckpt_workdir()
    try:
        free_memory(torch)
        acc, model, opt, loader, step = trainer(str(workdir))
        it = iter(loader)
        for batch in itertools.islice(it, before):
            step(batch)
        torch.cuda.synchronize()
        saved = host_state(torch, model, opt)
        t0 = time.perf_counter()
        sync_dir = acc.save_state()
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        async_dir = acc.save_state(async_save=True)
        async_return_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        a_losses, a_digests = run_continuation(torch, step, itertools.islice(it, after))
        continuation_s = time.perf_counter() - t0
        a = (a_losses, params_cpu(model))
        t0 = time.perf_counter()
        acc.wait_for_checkpoint()
        async_drain_s = time.perf_counter() - t0
        nbytes = dir_bytes(sync_dir)
        check(dir_bytes(async_dir) == nbytes, f"bert_resume: the sync and async checkpoints hold {nbytes} bytes each")
        del it, acc, model, opt, loader, step
        free_memory(torch)

        runs, loads, flagged = [], [], []
        for repeat in range(2):
            acc, model, opt, loader, step = trainer(str(workdir))
            restored, load_s = resume_checks(torch, acc, model, opt, saved, async_dir, before, "bert_resume")
            loads.append(load_s)
            check(loader.state_dict()["batches_yielded"] == before, "bert_resume: the loader's position restored")
            losses, digests = run_continuation(torch, step, itertools.islice(loader, after))
            check(digests == a_digests, f"bert_resume: the resumed batches are the unbroken run's ({digests[:2]} "
                                        f"vs {a_digests[:2]})")
            runs.append((losses, params_cpu(model)))
            if repeat:
                flagged = flagged_nondeterministic_ops(torch, lambda: step(next(iter(loader))))
            del acc, model, opt, loader, step
            free_memory(torch)
        verdict = continuation_verdict(a, runs[0], runs[1], "bert_resume")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    row = {
        "phase": "bert_resume", "config": "bert-base-uncased shape, seeded random weights, f32 masters + bf16 compute, "
        "bf16 softmax, batch 32 x 128, SyntheticMRPC(n=3668), AdamW", "steps_before_save": before,
        "continuation_steps": after, "checkpoint_bytes": nbytes, "save_sync_s": sync_s,
        "save_sync_gb_per_s": nbytes / sync_s / 1e9, "save_async_return_s": async_return_s,
        "save_async_drain_s_after_continuation": async_drain_s, "continuation_a_s": continuation_s,
        "load_s": loads, "load_gb_per_s": nbytes / min(loads) / 1e9, "restored": restored,
        "batches_equal": True, "losses_a": a_losses, "losses_b": runs[0][0], "losses_repeat": runs[1][0],
        **verdict, "flagged_nondeterministic_ops": flagged,
    }
    emit(row)
    return row


def phase_train_resume(torch):
    """The Llama train step at TinyLlama's full width (hidden 2048,
    intermediate 5632, 32/4 heads) cut to 4 layers (the f32 masters and
    AdamW's two moments come to about 3.7 GB a checkpoint; 22 layers would
    be about 13 GB), bf16 compute, remat, batch 8 x 2048: 3 steps, a
    synchronous save and an async one, 2 more steps (A) while the async
    writes run, the drain; then a fresh trainer auto-resumes and takes the
    same 2 steps (B), and a second one the repeat. The resumed steps must
    launch K1 2 x 4 x 2 times and K2 and K3 4 x 2 times each, as A does;
    B is held to A by the repeat (:func:`continuation_verdict`)."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.ops import flash_attention as fa

    b, s, before, after, layers = 8, 2048, 3, 2, 4
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": layers}, remat=True)
    want_launches = {"fwd": 2 * layers * after, "dq": layers * after, "dkv": layers * after}

    def continuation(step):
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses, _ = run_continuation(torch, step, ({"input_ids": batches[before + i]} for i in range(after)))
        return losses, {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv}

    workdir = ckpt_workdir()
    try:
        free_memory(torch)
        batches = token_batches(torch, before + after, b, s, cfg.vocab_size, seed=5)
        acc, model, step = build_trainer(torch, cfg, "bf16", project_dir=str(workdir))
        opt = acc._optimizers[-1]
        pre_losses = [float(step({"input_ids": batches[i]})) for i in range(before)]
        torch.cuda.synchronize()
        saved = host_state(torch, model, opt)
        t0 = time.perf_counter()
        sync_dir = acc.save_state()
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        async_dir = acc.save_state(async_save=True)
        async_return_s = time.perf_counter() - t0
        a_losses, a_launches = continuation(step)
        a = (a_losses, params_cpu(model))
        t0 = time.perf_counter()
        acc.wait_for_checkpoint()
        async_drain_s = time.perf_counter() - t0
        nbytes = dir_bytes(sync_dir)
        check(dir_bytes(async_dir) == nbytes, f"train_resume: the sync and async checkpoints hold {nbytes} bytes each")
        check(a_launches == want_launches, f"train_resume: unbroken flash launches {a_launches} == {want_launches}")
        del acc, model, opt, step
        free_memory(torch)

        runs, loads, flagged = [], [], []
        for repeat in range(2):
            acc, model, step = build_trainer(torch, cfg, "bf16", project_dir=str(workdir))
            opt = acc._optimizers[-1]
            restored, load_s = resume_checks(torch, acc, model, opt, saved, async_dir, before, "train_resume")
            loads.append(load_s)
            losses, launches = continuation(step)
            check(launches == want_launches, f"train_resume: resumed flash launches {launches} == K1 2 x {layers} x "
                                             f"{after}, K2/K3 {layers} x {after}")
            runs.append((losses, params_cpu(model)))
            if repeat:
                flagged = flagged_nondeterministic_ops(torch, lambda: step({"input_ids": batches[0]}))
            del acc, model, opt, step
            free_memory(torch)
        verdict = continuation_verdict(a, runs[0], runs[1], "train_resume")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(all(np.isfinite(pre_losses + a_losses)), f"train_resume: finite losses {pre_losses + a_losses}")
    row = {
        "phase": "train_resume", "config": "TinyLlama-1.1B widths, f32 masters + bf16 compute, remat, batch 8 x 2048, "
        "AdamW(3e-4, weight decay 0.01), seeded", "reduced": f"{layers} of 22 layers (checkpoint size)",
        "params": sum(v.numel() for k, (v, _) in saved.items() if k.startswith("param/")),
        "steps_before_save": before, "continuation_steps": after, "checkpoint_bytes": nbytes,
        "save_sync_s": sync_s, "save_sync_gb_per_s": nbytes / sync_s / 1e9, "save_async_return_s": async_return_s,
        "save_async_drain_s_after_continuation": async_drain_s, "load_s": loads,
        "load_gb_per_s": nbytes / min(loads) / 1e9, "restored": restored, "launches_resumed": launches,
        "losses_before_save": pre_losses, "losses_a": a_losses, "losses_b": runs[0][0], "losses_repeat": runs[1][0],
        **verdict, "flagged_nondeterministic_ops": flagged,
    }
    emit(row)
    return row


def imperative_trainer(torch, cfg, accum, seed=0, lr=3e-4):
    """A fresh Accelerator (bf16 compute, ``accum`` microbatches a step), a
    Llama from ``seed`` and AdamW, prepared together: no step built."""
    from accelerate_tpu_torch import Accelerator, create_llama_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=accum)
    model = create_llama_model(cfg, seed=seed, dtype=torch.float32)
    opt = torch.optim.AdamW(model.module.parameters(), lr=lr, weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt


def phase_imperative(torch):
    """The imperative loop at the train phase's shape (TinyLlama-1.1B, 22
    layers, f32 masters, bf16 compute, remat, AdamW(3e-4, weight decay
    0.01)): gradient accumulation 4 over 8 microbatches of 2 x 2048, so two
    optimizer steps, each microbatch ``with accumulate(model): backward(loss_fn,
    batch); optimizer.step(); optimizer.zero_grad()``; then
    ``build_train_step`` from the same weights on the same batches. The
    per-microbatch losses, every parameter and every AdamW tensor must be
    bit-equal between the two, and each path must launch K1 2 x 22 x 8
    times and K2 and K3 22 x 8 times. A third run calls
    ``clip_grad_norm_(model, 1.0)`` in the loop: finite losses, parameters
    that differ from the unclipped run's. Each path's optimizer-step
    windows (4 microbatches, fenced once, as a training loop runs) are
    timed beside the other's, and one more window of each runs under
    torch.profiler (``traced``): its device busy ms say whether a gap
    between the wall times is the host's or the card's."""
    from accelerate_tpu_torch import LlamaConfig, causal_lm_loss
    from accelerate_tpu_torch.ops import flash_attention as fa

    b, s, accum, micro = 2, 2048, 4, 8
    cfg = LlamaConfig(**TINYLLAMA, remat=True)
    layers = cfg.num_hidden_layers
    want = {"fwd": 2 * layers * micro, "dq": layers * micro, "dkv": layers * micro}
    free_memory(torch)
    batches = token_batches(torch, micro, b, s, cfg.vocab_size, seed=11)

    def drive(run):
        """``run(i)`` -> loss for each microbatch: (losses, wall ms a window, launches)."""
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses, windows = [], []
        for w in range(0, micro, accum):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += [run(i) for i in range(w, w + accum)]
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) * 1e3)
        launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv}
        return [float(x) for x in losses], windows, launches

    def traced_window(run):
        """One more window under torch.profiler (which may run it again)."""
        events, wall_ms, attempts, lost = traced(torch, lambda: [run(i) for i in range(accum)])
        busy, _ = device_time(events)
        return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
                "trace_attempts": attempts, "trace_lead_lost": lost}

    def imperative(clip=None):
        acc, model, opt = imperative_trainer(torch, cfg, accum)
        loss_fn = lambda p, batch: causal_lm_loss(p, batch, model.apply_fn)  # noqa: E731
        norms = []

        def run(i):
            with acc.accumulate(model):
                loss = acc.backward(loss_fn, {"input_ids": batches[i]})
                if clip is not None:
                    norms.append(float(acc.clip_grad_norm_(model, clip)))
                opt.step()
                opt.zero_grad()
            return loss

        return run, norms, model, opt

    def state_of(model, opt):
        tensors = {f"param/{k}": v for k, v in model.state_dict().items()}
        for i, st in opt.optimizer.state_dict()["state"].items():
            tensors.update({f"opt/{i}/{k}": v for k, v in st.items() if torch.is_tensor(v)})
        return tensors

    run, _, model, opt = imperative()
    i_losses, i_ms, i_launches = drive(run)
    kept = {k: v.clone() for k, v in state_of(model, opt).items()}  # the traced window trains on
    i_traced = traced_window(run)
    del run, model, opt
    free_memory(torch)
    acc, model2, opt2 = imperative_trainer(torch, cfg, accum)
    step = acc.build_train_step(lambda p, batch: causal_lm_loss(p, batch, model2.apply_fn))
    f_losses, f_ms, f_launches = drive(lambda i: step({"input_ids": batches[i]}))
    fused = state_of(model2, opt2)
    check(i_launches == want and f_launches == want,
          f"imperative: flash launches {i_launches} (imperative), {f_launches} (fused) == K1 2 x {layers} x {micro}, "
          f"K2/K3 {layers} x {micro}")
    check(all(np.isfinite(i_losses)), f"imperative: finite losses {i_losses}")
    check(i_losses == f_losses, f"imperative: per-microbatch losses bit-equal ({i_losses} vs {f_losses})")
    check(kept.keys() == fused.keys(), f"imperative: the same tensors ({len(kept)} vs {len(fused)})")
    unequal = [k for k in kept if not torch.equal(kept[k], fused[k])]
    check(not unequal, f"imperative: parameters and AdamW tensors bit-equal ({len(unequal)} differ: {unequal[:3]})")
    n_tensors = len(kept)
    del fused
    f_traced = traced_window(lambda i: step({"input_ids": batches[i]}))
    del acc, model2, opt2, step
    free_memory(torch)
    run, c_norms, model3, opt3 = imperative(clip=1.0)
    c_losses, _, c_launches = drive(run)
    clipped = state_of(model3, opt3)
    moved = sum(not torch.equal(kept[k], clipped[k]) for k in kept if k.startswith("param/"))
    check(all(np.isfinite(c_losses)), f"imperative: clipped run's losses finite {c_losses}")
    check(moved > 0, f"imperative: clip_grad_norm_(1.0) in the loop changed the parameters (pre-clip norms {c_norms})")
    del run, model3, opt3, clipped, kept
    free_memory(torch)
    row = {
        "phase": "imperative", "config": "TinyLlama-1.1B shape, 22 layers, f32 masters + bf16 compute, remat, "
        "AdamW(3e-4, weight decay 0.01), seeded", "batch": b, "seq": s, "accum": accum, "microbatches": micro,
        "optimizer_steps": micro // accum, "losses": i_losses,
        "bit_equal": {"losses": micro, "params_and_adamw_tensors": n_tensors},
        "launches": {"imperative": i_launches, "fused": f_launches},
        # the first window holds the kernels' first calls and the allocator's growth
        "window_ms": {"imperative": i_ms, "fused": f_ms},
        "traced_window": {"imperative": i_traced, "fused": f_traced},
        "clip": {"max_norm": 1.0, "losses": c_losses, "pre_clip_norms": c_norms, "params_changed": moved,
                 "launches": c_launches},
    }
    emit(row)
    return row


def cv_example():
    """examples/torch_cv_example.py of this checkout, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "torch_cv_example.py"
    spec = importlib.util.spec_from_file_location("torch_cv_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resnet_trainer(torch, example, config, dataset, batch_size, lr, total_steps, mixed_precision="bf16", cpu=False,
                   seed=0, model_device=None, project_dir=None):
    """examples/torch_cv_example.py's set-up: a fresh Accelerator, a ResNet
    from ``seed`` made on ``model_device`` (the card by default; the CPU
    for a card-vs-CPU pair, one generator and one set of weights, which
    ``prepare`` moves), SGD(momentum 0.9) under the one-cycle schedule, a
    shuffled loader (seed 42, last partial batch dropped), the has_state
    train step and the eval step on the running statistics."""
    from accelerate_tpu_torch import Accelerator, ProjectConfiguration, create_resnet_model, prepare_data_loader
    from accelerate_tpu_torch import resnet_classification_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    project = ProjectConfiguration(project_dir=project_dir) if project_dir else None
    acc = Accelerator(mixed_precision=mixed_precision, cpu=cpu, project_config=project)
    model = create_resnet_model(config, seed=seed, device=model_device)
    optimizer = torch.optim.SGD(model.module.parameters(), lr=lr, momentum=0.9)
    schedule = example.onecycle_schedule(total_steps, lr, pct_start=0.25)
    loader = prepare_data_loader(dataset, batch_size=batch_size, shuffle=True, seed=42, drop_last=True)
    model, optimizer, loader, schedule = acc.prepare(model, optimizer, loader, schedule)
    step = acc.build_train_step(lambda p, st, b: resnet_classification_loss(p, st, b, model.apply_fn), has_state=True)
    eval_step = acc.build_eval_step(lambda p, st, x: model.apply_fn(p, x, st, train=False))
    return acc, model, optimizer, loader, step, eval_step


def running_stats(model) -> dict:
    """``{name: copy}`` of every BatchNorm running statistic."""
    from accelerate_tpu_torch.modeling import flatten

    return {k: v.detach().clone() for k, v in flatten(model.state["batch_stats"]).items()}


def resnet_step_split(by_name: dict) -> dict:
    """Device ms of a traced ResNet step by kind of kernel: torch's fused
    batch norm (statistics, normalise, their backward), cuDNN's
    convolutions (forward, data and weight gradients), matmuls, reductions
    (the pool, the loss), and elementwise work."""
    kinds = {
        "batch_norm": ("batch_norm",),
        "convolution": ("conv", "xmma", "cudnn", "implicit_gemm", "fprop", "dgrad", "wgrad", "nhwc", "sm90_"),
        "matmul": ("gemm", "nvjet", "cutlass"),
        "reduction": ("reduce", "max_pool", "maxpool", "norm"),
        "elementwise": ("elementwise", "vectorized", "unrolled", "copy", "fill", "cat"),
    }
    split = dict.fromkeys([*kinds, "other"], 0.0)
    for name, (ms, _) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in kinds.items() if any(t in low for t in keys)), "other")
        split[kind] += ms
    return split


def phase_resnet_train(torch):
    """examples/torch_cv_example.py's loop on the card at its full
    configuration: ResNet-50 v1.5, 37 classes, 224 x 224 NHWC images, batch
    64, f32 masters and bf16 compute, SGD(momentum 0.9) under a one-cycle
    schedule peaking at 3e-2, has_state train step: one epoch of
    SyntheticPets(n=1024), 16 steps. The loss must be finite and fall
    (mean of the last four below that of the first four); every running
    mean and variance must have moved from its initial value; the eval pass
    on the running statistics must leave them unchanged and
    gather_for_metrics give back 1024 predictions. Three more steps on the
    epoch's last batches run under torch.profiler (``traced``): the idle
    share, and the device time of convolutions against the rest; one more
    step under ``FlopCounterMode`` counts the step's convolution and
    matmul operations (forward and backward) for its MFU."""
    from torch.utils.flop_counter import FlopCounterMode

    from accelerate_tpu_torch import ResNetConfig

    example = cv_example()
    batch_size, n, size, lr = 64, 1024, 224, 3e-2
    free_memory(torch)
    dataset = example.SyntheticPets(n=n, image_size=size, num_classes=37)
    config = ResNetConfig.resnet50(num_classes=37)
    acc, model, _, loader, step, eval_step = resnet_trainer(torch, example, config, dataset, batch_size, lr,
                                                            total_steps=n // batch_size)
    initial = running_stats(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, last_batches = [], [], []
    t0 = time.perf_counter()
    for batch in loader:
        s0 = time.perf_counter()
        losses.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - s0) * 1e3)
        last_batches = (last_batches + [batch])[-3:]
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    trained = running_stats(model)
    t0 = time.perf_counter()
    correct, total = example.evaluate(acc, eval_step, loader)
    eval_s = time.perf_counter() - t0
    after_eval = running_stats(model)
    events, wall_ms, attempts, lost = traced(torch, lambda: [step(batch) for batch in last_batches])
    busy, by_name = device_time(events)
    split = resnet_step_split(by_name)
    with FlopCounterMode(display=False) as counter:  # one more step: its convolution and matmul operations
        step(last_batches[-1])
    step_flops = counter.get_total_flops()
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    unmoved = [k for k in initial if torch.equal(initial[k], trained[k])]
    check(len(losses) == 16 and all(np.isfinite(losses)), f"resnet_train: 16 finite losses {losses}")
    check(last < first, f"resnet_train: mean of the last four losses {last} < the first four's {first}")
    check(not unmoved, f"resnet_train: every running statistic moved ({len(unmoved)} did not: {unmoved[:3]})")
    check(all(torch.equal(trained[k], after_eval[k]) for k in trained), "resnet_train: eval left the statistics")
    check(all(v.is_cuda for v in trained.values()), "resnet_train: the running statistics live on the card")
    check(total == n, f"resnet_train: gather_for_metrics gave {total} predictions for {n} rows")
    step_ms = sorted(times[2:])  # the first two hold cuDNN's algorithm search and the allocator's growth
    row = {
        "phase": "resnet_train", "config": "ResNet-50 v1.5, 37 classes, 224 x 224 NHWC, seeded random weights, "
        "f32 masters + bf16 compute, SGD(momentum 0.9), one-cycle peak 3e-2", "params": model.num_parameters(),
        "running_statistics": len(trained), "batch": batch_size, "rows": n, "steps": len(losses),
        "samples_per_s": len(losses) * batch_size / train_s, "train_s": train_s, "eval_s": eval_s,
        "step_ms_median": statistics.median(step_ms), "step_ms_first": times[:2],
        "samples_per_s_steady": batch_size / (statistics.median(step_ms) / 1e3), "step_flops": step_flops,
        "mfu": step_flops / (statistics.median(step_ms) / 1e3) / PEAK_FLOPS["bfloat16"],
        # the traced steps' convolution and matmul device time against their operations
        "conv_matmul_tflops": (step_flops * 3 / ((split["convolution"] + split["matmul"]) / 1e3) / 1e12
                               if split["convolution"] + split["matmul"] else None),
        "peak_memory_gb": peak_gb, "accuracy": correct / total, "predictions": total,
        "loss_first4": first, "loss_last4": last, "losses": losses,
        "traced_steps": 3, "traced_wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if busy else None, "device_ms_by_kind": split,
        "trace_attempts": attempts, "trace_lead_lost": lost,
        "top": [[name[:90], ms, k] for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]],
    }
    emit(row)
    del acc, model, loader, step, eval_step, last_batches, dataset
    free_memory(torch)
    return row


def phase_resnet_consistency(torch):
    """ResNetConfig.tiny() at 32 px and ResNet-50's widths cut to two stages
    of two blocks at 64 px, both f32, 37 and 10 classes: three has_state
    steps (SGD, momentum 0.9) on the card and the same three on the CPU from
    the same weights (built on the CPU; ``prepare`` moves them), then the
    eval logits on one batch. Logits, every parameter and every running
    statistic within 1e-4 of the CPU's, relative to the larger of the
    tensor's RMS and 1e-3."""
    from accelerate_tpu_torch import ResNetConfig

    example = cv_example()
    rows = []
    for name, config, size in (("tiny", ResNetConfig.tiny(), 32),
                               ("resnet50_widths_2_stages", ResNetConfig(stage_sizes=(2, 2), num_classes=37), 64)):
        dataset = example.SyntheticPets(n=48, image_size=size, num_classes=config.num_classes, seed=3)
        probe = {"images": torch.as_tensor(dataset.images[:8])}
        runs = {}
        for device in ("cuda", "cpu"):
            acc, model, _, loader, step, eval_step = resnet_trainer(
                torch, example, config, dataset, 16, 1e-2, total_steps=3, mixed_precision="no",
                cpu=device == "cpu", seed=5, model_device="cpu")
            losses = [float(step(b)) for b in loader]
            logits = eval_step(probe["images"].to(acc.device)).cpu()
            runs[device] = (losses, logits, {k: v.detach().cpu() for k, v in model.state_dict().items()})
            del acc, model, loader, step, eval_step
        (g_losses, g_logits, g_state), (c_losses, c_logits, c_state) = runs["cuda"], runs["cpu"]

        def err(a, b):
            return float((a - b).abs().max() / b.pow(2).mean().sqrt().clamp_min(1e-3))

        logit_err = err(g_logits, c_logits)
        param_err = max(err(g_state[k], v) for k, v in c_state.items() if not k.endswith((".mean", ".var")))
        stat_err = max(err(g_state[k], v) for k, v in c_state.items() if k.endswith((".mean", ".var")))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(g_losses, c_losses))
        check(len(g_losses) == 3 and all(np.isfinite(g_losses)), f"resnet_consistency {name}: 3 finite losses")
        for what, e in (("loss", loss_err), ("logits", logit_err), ("params", param_err), ("statistics", stat_err)):
            check(e <= 1e-4, f"resnet_consistency {name}: card vs CPU {what} err {e} <= 1e-4")
        rows.append({"model": name, "image_size": size, "losses_cuda": g_losses, "losses_cpu": c_losses,
                     "loss_rel_err": loss_err, "logits_err_over_rms": logit_err, "param_err_over_rms": param_err,
                     "statistics_err_over_rms": stat_err})
    # torch's flags as a user has them (cuDNN's TF32 on): mixed_precision="no" turns it off inside the steps
    row = {"phase": "resnet_consistency", "config": "f32, batch 16, 3 has_state SGD steps, card vs CPU",
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "runs": rows}
    emit(row)
    free_memory(torch)
    return row


def phase_resnet_resume(torch):
    """resnet_train's configuration (ResNet-50, 37 classes, 224 px, batch
    64, bf16 compute): three has_state steps, save_state into a temporary
    directory, every running statistic zeroed, load_state: each restored
    tensor (parameters, running statistics, SGD momenta) bit-equal to its
    copy from the save and on the card."""
    from accelerate_tpu_torch import ResNetConfig
    from accelerate_tpu_torch.modeling import nest

    example = cv_example()
    workdir = ckpt_workdir()
    try:
        free_memory(torch)
        dataset = example.SyntheticPets(n=192, image_size=224, num_classes=37, seed=4)
        acc, model, opt, loader, step, _ = resnet_trainer(torch, example, ResNetConfig.resnet50(num_classes=37),
                                                          dataset, 64, 3e-2, total_steps=16, project_dir=str(workdir))
        losses = [float(step(b)) for b in loader]
        torch.cuda.synchronize()
        saved = host_state(torch, model, opt)
        stats = running_stats(model)
        t0 = time.perf_counter()
        out = acc.save_state(str(workdir / "checkpoint"))
        save_s = time.perf_counter() - t0
        model.state = {"batch_stats": nest({k: torch.zeros_like(v) for k, v in stats.items()})}
        check(all(not v.any() for v in running_stats(model).values()), "resnet_resume: the statistics zeroed")
        t0 = time.perf_counter()
        acc.load_state(str(out))
        load_s = time.perf_counter() - t0
        restored = check_restored(torch, saved, model, opt, "resnet_resume")
        back = running_stats(model)
        check(all(torch.equal(back[k], v) for k, v in stats.items()) and all(v.is_cuda for v in back.values()),
              "resnet_resume: every running statistic bit-equal to the save's, on the card")
        nbytes = dir_bytes(out)
        del acc, model, opt, loader, step
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(len(losses) == 3 and all(np.isfinite(losses)), f"resnet_resume: 3 finite losses {losses}")
    row = {"phase": "resnet_resume", "config": "ResNet-50 v1.5, 37 classes, 224 px, batch 64, bf16 compute, SGD",
           "steps_before_save": 3, "running_statistics": len(stats), "checkpoint_bytes": nbytes, "save_s": save_s,
           "load_s": load_s, "restored": restored, "losses": losses}
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


# --------------------------------------------------------------------------- #
# fp8 mixed precision and the run's telemetry (``--only fp8``)
# --------------------------------------------------------------------------- #

FP8_PEAK_FLOPS = 1979e12  # H100 SXM dense fp8 tensor cores (datasheet, no sparsity)
# the TinyLlama train step's projections: (K, N) of x [16384, K] @ w^T, w [N, K]
FP8_SHAPES = {"q_o": (2048, 2048), "k_v": (2048, 256), "gate_up": (2048, 5632), "down": (5632, 2048)}
# _scaled_mm (cuBLASLt, use_fast_accum=False) against its plain version (the same codes, an f32 matmul), per
# element |got - want| <= t (|want| + RMS(want)). The products of the codes are exact in both; the tensor cores
# sum them in an accumulator narrower than f32 and promote it to f32 only now and then (fast accumulation off):
# the first H100 run read 4e-4 to 1.07e-3 over the twelve products, so t is three times the largest
FP8_MM_TOL = 3e-3
FP8_LOSS_BAR = 0.1  # tests/test_fp8.py::test_fp8_loss_parity_vs_bf16's bar, fp8 loss against bf16's


def fp8_mm_err(torch, got, want) -> float:
    """max |got - want| / (|want| + RMS(want)), in f32."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (want.abs() + want.square().mean().sqrt())).max())


def fp8_bound(m, k, n, out_bytes) -> tuple:
    """(bound ms, "bytes" | "operations") of one fp8 product: the codes read
    once, the output written once, against the fp8 peak."""
    by_bytes = (m * k + k * n + m * n * out_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = 2.0 * m * k * n / FP8_PEAK_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes > by_ops else (by_ops, "operations")


def phase_fp8_matmul(torch):
    """The three products of every projection of the TinyLlama train step
    (M = 8 x 2048 tokens) through ``fp8_mm`` (``torch._scaled_mm``) against
    its plain version on the same codes: the forward (e4m3 x e4m3), dlhs
    (e5m2 gradient x e4m3 weight) and drhs (e5m2 gradient^T x e4m3 input,
    contracting over the tokens). The codes made on the card are held bit
    for bit to the CPU's. Each product's time beside ``torch.matmul`` in
    bf16 at the same shape and its bound; the quantize pass (amax, then
    scale and cast) timed on the largest activations."""
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.utils.quantization import fp8_quantize

    m = 8 * 2048
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, errs = {}, {}
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 product in f32
    try:
        for name, (k, n) in FP8_SHAPES.items():
            x = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
            w = (torch.randn(n, k, generator=gen, device="cuda") / k**0.5).to(torch.bfloat16)
            g = (torch.randn(m, n, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
            (x8, sx), (w8, sw), (g8, sg) = fp8_quantize(x), fp8_quantize(w), fp8_quantize(g, torch.float8_e5m2)
            for t, (codes, inv), dtype in ((x, (x8, sx), torch.float8_e4m3fn), (w, (w8, sw), torch.float8_e4m3fn),
                                           (g, (g8, sg), torch.float8_e5m2)):
                cpu_codes, cpu_inv = fp8_quantize(t.cpu(), dtype)
                check(torch.equal(codes.cpu().view(torch.uint8), cpu_codes.view(torch.uint8))
                      and float(inv) == float(cpu_inv), f"fp8_matmul {name}: card codes and scale == the CPU's")
            products = {
                "fwd": (x8, w8.t(), sx * sw, (m, k, n), lambda: x @ w.t()),
                "dlhs": (g8, w8, sg * sw, (m, n, k), lambda: g @ w),
                "drhs": (g8.t(), x8, sx * sg, (n, m, k), lambda: g.t() @ x),
            }
            for kind, (a8, b8, scale, (pm, pk, pn), bf16) in products.items():
                got = fp8.fp8_mm(a8, b8, scale, torch.float32)
                want = fp8.fp8_mm_plain(a8, b8, scale, torch.float32)
                err = fp8_mm_err(torch, got, want)
                errs[f"{name}/{kind}"] = err
                bound_ms, bound_by = fp8_bound(pm, pk, pn, 2)
                ms = time_ms(torch, lambda: fp8.fp8_mm(a8, b8, scale, torch.bfloat16))
                rows[f"{name}/{kind}"] = {
                    "m": pm, "k": pk, "n": pn, "max_abs_err": float((got - want).abs().max()), "err_over_rms": err,
                    "ms": ms, "plain_ms": time_ms(torch, lambda: fp8.fp8_mm_plain(a8, b8, scale, torch.bfloat16),
                                                  reps=5, warmup=1),
                    "bf16_matmul_ms": time_ms(torch, bf16), "bound_ms": bound_ms, "bound_by": bound_by,
                    "tflops": 2.0 * pm * pk * pn / ms / 1e9,
                }
            del x, w, g, x8, w8, g8, products
        big = torch.randn(m, 5632, generator=gen, device="cuda", dtype=torch.bfloat16)
        quantize_ms = {"16384x5632": time_ms(torch, lambda: fp8_quantize(big)),
                       "16384x2048": time_ms(torch, lambda: fp8_quantize(big[:, :2048].contiguous()))}
        # a pass reads the bf16 tensor twice (amax, then scale and cast) and writes the codes once
        quantize_bound_ms = {"16384x5632": m * 5632 * (2 + 2 + 1) / HBM_BYTES_PER_S * 1e3,
                             "16384x2048": m * 2048 * (2 + 2 + 1) / HBM_BYTES_PER_S * 1e3}
        # the padding route: a shape off the 16 grid
        x8, sx = fp8_quantize(torch.randn(40, 72, generator=gen, device="cuda"))
        w8, sw = fp8_quantize(torch.randn(24, 72, generator=gen, device="cuda"))
        odd_err = fp8_mm_err(torch, fp8.fp8_mm(x8, w8.t(), sx * sw, torch.float32),
                             fp8.fp8_mm_plain(x8, w8.t(), sx * sw, torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    row = {"phase": "fp8_matmul", "m": m, "tol": FP8_MM_TOL, "products": rows, "quantize_ms": quantize_ms,
           "quantize_bound_ms": quantize_bound_ms, "odd_shape_err_over_rms": odd_err}
    emit(row)
    for what, err in {**errs, "40x72x24": odd_err}.items():
        check(err <= FP8_MM_TOL, f"fp8_matmul {what}: _scaled_mm vs plain err {err} <= {FP8_MM_TOL}")
    free_memory(torch)
    return row


def fp8_trainer(torch, cfg, recipe, seed=0, lr=3e-4, project_dir=None, telemetry=None, log_with=None):
    """A fresh Accelerator for ``recipe`` ("bf16", "dynamic" or "delayed"),
    the Llama built after it (the delayed recipe's projections are
    FP8Dense), AdamW and the train step (has_state under the delayed
    recipe, whose histories are the model's state)."""
    from accelerate_tpu_torch import (
        Accelerator, Fp8RecipeKwargs, ProjectConfiguration, causal_lm_loss, causal_lm_loss_state, create_llama_model,
    )
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    handlers = [h for h in (Fp8RecipeKwargs() if recipe == "delayed" else None, telemetry) if h is not None]
    project = ProjectConfiguration(project_dir=project_dir, automatic_checkpoint_naming=True) if project_dir else None
    acc = Accelerator(mixed_precision="bf16" if recipe == "bf16" else "fp8", kwargs_handlers=handlers,
                      project_config=project, log_with=log_with)
    model = acc.prepare_model(create_llama_model(cfg, seed=seed, dtype=torch.float32))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=lr, weight_decay=0.01))
    if recipe == "delayed":
        step = acc.build_train_step(lambda p, s, b: causal_lm_loss_state(p, s, b, model.apply_fn), has_state=True)
    else:
        step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    return acc, model, step


def history_entries(model) -> set:
    """The distinct counts of filled entries over the model's amax histories."""
    return {int(b.count_nonzero()) for name, b in model.module.named_buffers() if "amax_history" in name}


def phase_fp8_train(torch, bf16=None):
    """The train phase's shape (TinyLlama-1.1B, 22 layers, f32 masters,
    remat, batch 8 x 2048, AdamW 3e-4) for 2 + 10 steps in bf16 and in fp8
    under each recipe, from the same weights on the same batches (the
    bf16 run is the train phase's row, ``bf16``, when that phase ran in
    this process; else it runs here). Every
    fp8 loss within FP8_LOSS_BAR of bf16's; K1-K3 launched as in the train
    phase; the fp8 products 7 x 22 x 4 a step (forward, recompute, dlhs,
    drhs of each projection); under the delayed recipe one new history
    entry a step. Tokens/s, step ms, MFU over the bf16 peak (the JAX
    package's default) and peak memory for each."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import fp8

    b, s, warmup, timed = 8, 2048, 2, 10
    n = warmup + timed
    cfg = LlamaConfig(**TINYLLAMA, remat=True)
    layers = cfg.num_hidden_layers
    runs = {}
    if bf16 is not None:
        runs["bf16"] = {key: bf16[key] for key in ("losses", "tokens_per_s", "step_ms_median", "step_ms_p90",
                                                   "peak_memory_gb")}
        runs["bf16"].update(mfu_bf16_peak=bf16["mfu"], launches={**bf16["launches"], "fp8": 0},
                            history_entries=[], from_phase="train")
    for recipe in ("dynamic", "delayed") if bf16 is not None else ("bf16", "dynamic", "delayed"):
        free_memory(torch)
        acc, model, step = fp8_trainer(torch, cfg, recipe)
        batches = token_batches(torch, n, b, s, cfg.vocab_size, seed=3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        fp8.launches = 0
        losses, times = [], []
        for i in range(n):
            t0 = time.perf_counter()
            loss = step({"input_ids": batches[i]})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv, "fp8": fp8.launches}
        entries = sorted(history_entries(model))
        step_ms = sorted(times[warmup:])
        med = statistics.median(step_ms)
        flops = llama_step_flops(model.module, cfg, b * s, s)
        params = model.num_parameters()
        if recipe == "dynamic":  # where the fp8 step's time goes, beside train_profile's bf16 step
            phase_train_profile(torch, step, batches, phase="fp8_train_profile",
                                what="one fp8 train step (dynamic recipe), TinyLlama shape, batch 8 x 2048, remat")
        runs[recipe] = {
            "losses": losses, "tokens_per_s": b * s / (med / 1e3), "step_ms_median": med,
            "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1],
            "mfu_bf16_peak": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "history_entries": entries,
        }
        del acc, model, step, batches
    row = {"phase": "fp8_train", "config": "TinyLlama-1.1B shape, 22 layers, f32 masters, remat, batch 8 x 2048",
           "params": params, "step_flops": flops, "warmup_steps": warmup, "timed_steps": timed, **runs}
    emit(row)
    base = runs["bf16"]["losses"]
    for recipe in ("dynamic", "delayed"):
        r = runs[recipe]
        check(all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0], f"fp8 {recipe}: losses fall")
        gap = max(abs(a - c) for a, c in zip(r["losses"], base))
        check(gap < FP8_LOSS_BAR, f"fp8 {recipe}: losses within {FP8_LOSS_BAR} of bf16's (max gap {gap})")
        check(r["launches"] == {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n, "fp8": 7 * layers * 4 * n},
              f"fp8 {recipe}: launches {r['launches']}")
    check(runs["delayed"]["history_entries"] == [n], f"delayed: every history holds {n} entries, one a step")
    return row


def phase_telemetry(torch):
    """The fp8 train step (dynamic recipe, TinyLlama widths at 4 layers so
    that the save stays small, batch 8 x 2048) wrapped by
    ``accelerator.telemetry.wrap``, with ``log_with="jsonl"`` and
    ``TelemetryKwargs(nonfinite_every=5, forward_to_trackers_every=5)``:
    one step record a call in the JSONL event log, the telemetry's median
    step and MFU within 10% of the phase's own host timing, a forced input
    shape change firing the recompile watchdog exactly once, ``save_state``
    writing ``ckpt_commit``, and the tracker file holding the forwarded
    summaries."""
    from accelerate_tpu_torch import LlamaConfig, TelemetryKwargs
    from accelerate_tpu_torch.telemetry import read_events

    b, s, warmup, timed = 8, 2048, 2, 10
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 4}, remat=True)
    workdir = ckpt_workdir()
    try:
        free_memory(torch)
        handler = TelemetryKwargs(nonfinite_every=5, forward_to_trackers_every=5, warmup_steps=warmup)
        acc, model, step = fp8_trainer(torch, cfg, "dynamic", project_dir=str(workdir), telemetry=handler,
                                       log_with="jsonl")
        acc.init_trackers("fp8_telemetry", config={"recipe": "dynamic", "layers": 4})
        flops = llama_step_flops(model.module, cfg, b * s, s)
        tel = acc.telemetry
        tel.steps.flops_per_step, tel.steps.peak_flops_per_device = flops, PEAK_FLOPS["bfloat16"]
        wrapped = tel.wrap(step)
        batches = token_batches(torch, warmup + timed, b, s, cfg.vocab_size, seed=3)
        times = []
        for i in range(warmup + timed):
            t0 = time.perf_counter()
            wrapped({"input_ids": batches[i]})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        summary = tel.summary()
        before = tel.recompiles
        for _ in range(2):  # a new shape, then the same again: one event
            wrapped({"input_ids": batches[0][: b // 2]})
        recompiles = tel.recompiles - before
        acc.save_state()
        acc.end_training()
        tel.flush()
        events = read_events(tel.path)
        metrics = [json.loads(line) for line in (workdir / "fp8_telemetry" / "metrics.jsonl").read_text().splitlines()]
        med = statistics.median(times[warmup:])
        phase_mfu = flops / (med / 1e3) / PEAK_FLOPS["bfloat16"]
        spans = [e for e in events if e["kind"] == "span" and e["name"] == "step"]
        forwarded = [r for r in metrics if "telemetry/step_ms" in r]
        row = {
            "phase": "telemetry", "config": "TinyLlama widths, 4 layers, fp8 dynamic, batch 8 x 2048",
            "step_ms_median_phase": med, "p50_step_ms_telemetry": summary["p50_step_ms"],
            "mfu_phase": phase_mfu, "mfu_telemetry": summary.get("mfu"), "goodput": summary.get("goodput"),
            "mean_dispatch_ms": summary.get("mean_dispatch_ms"), "mean_execute_ms": summary.get("mean_execute_ms"),
            "step_records": len(spans), "recompile_events": recompiles,
            "ckpt_commits": sum(e["name"] == "ckpt_commit" for e in events),
            "nonfinite_probes": tel.nonfinite.probes, "forwarded_rows": len(forwarded),
            "observed_peak_hbm_bytes": tel.hbm.observed_peak_bytes, "event_names": sorted({e["name"] for e in events}),
        }
        emit(row)
        check(len(spans) == warmup + timed + 2, f"telemetry: {len(spans)} step records for {warmup + timed + 2} calls")
        check(abs(summary["p50_step_ms"] - med) <= 0.1 * med, f"telemetry p50 {summary['p50_step_ms']} vs phase {med}")
        check(summary.get("mfu") is not None and abs(summary["mfu"] - phase_mfu) <= 0.1 * phase_mfu,
              f"telemetry MFU {summary.get('mfu')} vs phase {phase_mfu}")
        check(recompiles == 1, f"telemetry: the shape change fired {recompiles} recompile events, want 1")
        check(row["ckpt_commits"] == 1, "telemetry: save_state wrote ckpt_commit")
        check(tel.nonfinite.probes >= 2 and tel.nonfinite.nonfinite_event is None, "telemetry: finite probes")
        check(len(forwarded) == 2 and all(r["telemetry/recompiles"] == 0 for r in forwarded),
              f"telemetry: the tracker holds the forwarded summaries ({forwarded})")
        del acc, model, step, wrapped, batches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free_memory(torch)
    return row


def fp8_consistency_run(torch, build, batches, starts=None):
    """Run ``build()``'s step over ``batches``. Without ``starts`` it
    trains freely and returns the losses and the state before and after
    every step (on the host); with ``starts`` every step first loads
    ``starts[i]`` (weights and fp8 histories), so each step is held alone."""
    model, step = build()
    losses, states = [], [{k: v.detach().cpu().clone() for k, v in model.state_dict().items()}]
    for i, batch in enumerate(batches):
        if starts is not None:
            model.load_state_dict(starts[i])
        losses.append(float(step(batch)))
        states.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
    return losses, states


def fp8_step_errs(before: dict, card: dict, cpu: dict) -> tuple:
    """(the update's error: ||card update - CPU update|| / ||CPU update||
    over the weights, the worst tensor's name, the largest relative
    difference of a filled amax-history entry)."""
    num = den = hist = 0.0
    worst, worst_err = None, -1.0
    for name, v in cpu.items():
        if "amax_history" in name:
            filled = v != 0
            if filled.any():
                hist = max(hist, float(((card[name] - v).abs()[filled] / v.abs()[filled]).max()))
            continue
        d, u = float((card[name] - v).pow(2).sum()), float((v - before[name]).pow(2).sum())
        num, den = num + d, den + u
        if u > 0 and d / u > worst_err:
            worst, worst_err = name, d / u
    return (num / den) ** 0.5 if den else 0.0, worst, hist


# card against CPU, each fp8 step from the same state (bf16 compute in both): the tensor cores' narrow
# accumulator (FP8_MM_TOL) and the two devices' bf16 kernels differ by about 1e-3 of a product, and the
# codes' 3 (e4m3) and 2 (e5m2) mantissa bits turn that into code flips, which a weight gradient summed over
# the tokens with cancellation feels most. The first H100 run read loss 3.9e-3, update 0.151 (a q_proj
# weight), history 0.038; the bars are about twice those. A wrong operand or scale reads 1 or more.
FP8_CONSISTENCY_TOL = {"loss_rel": 1e-2, "update_rel": 0.3, "history_rel": 0.1}


def phase_fp8_consistency(torch):
    """2-layer cuts of both models, three SGD steps on the card (the fp8
    products through _scaled_mm) and each step again on the CPU (the plain
    version) from the card's weights and histories before it: each step's
    loss, the weights' update and the new amax-history entries against the
    card's, to FP8_CONSISTENCY_TOL. The Llama at TinyLlama widths (batch 1
    x 256) in both recipes; BERT at BERT-base widths (batch 8 x 128), whose
    dense layers take the dynamic product under either recipe, as the JAX
    package's do."""
    from accelerate_tpu_torch import (
        Accelerator, BertConfig, Fp8RecipeKwargs, LlamaConfig, bert_classification_loss, causal_lm_loss,
        causal_lm_loss_state, create_bert_model, create_llama_model,
    )
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    llama_cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": 2}, remat=True)
    bert_cfg = BertConfig(**{**BERT_BASE, "num_hidden_layers": 2})
    rng = np.random.default_rng(9)
    token_ids = [rng.integers(0, llama_cfg.vocab_size, size=(1, 256)) for _ in range(3)]
    bert_rows = [{"input_ids": rng.integers(5, bert_cfg.vocab_size, size=(8, 128)),
                  "attention_mask": np.ones((8, 128), np.bool_), "labels": rng.integers(0, 2, size=(8,))}
                 for _ in range(3)]

    def builder(kind, recipe, device):
        def build():
            for cls in (AcceleratorState, GradientState, PartialState):
                cls._reset_state()
            handlers = [Fp8RecipeKwargs()] if recipe == "delayed" else None
            acc = Accelerator(mixed_precision="fp8", kwargs_handlers=handlers, cpu=device == "cpu")
            if kind == "llama":
                model = create_llama_model(llama_cfg, seed=5, device="cpu")
            else:
                model = create_bert_model(bert_cfg, seed=5, device="cpu")
            model, _ = acc.prepare(model, torch.optim.SGD(model.module.parameters(), lr=1e-2))
            if kind == "llama" and recipe == "delayed":
                return model, acc.build_train_step(lambda p, s, b: causal_lm_loss_state(p, s, b, model.apply_fn),
                                                   has_state=True)
            loss = causal_lm_loss if kind == "llama" else bert_classification_loss
            return model, acc.build_train_step(lambda p, b: loss(p, b, model.apply_fn))
        return build

    def batches_on(kind, device):
        if kind == "llama":
            return [{"input_ids": torch.as_tensor(ids, device=device)} for ids in token_ids]
        return [{k: torch.as_tensor(v, device=device) for k, v in row.items()} for row in bert_rows]

    cases = {}
    for kind, recipe in (("llama", "dynamic"), ("llama", "delayed"), ("bert", "dynamic")):
        card_losses, card_states = fp8_consistency_run(torch, builder(kind, recipe, "cuda"), batches_on(kind, "cuda"))
        cpu_losses, cpu_states = fp8_consistency_run(torch, builder(kind, recipe, "cpu"), batches_on(kind, "cpu"),
                                                     starts=card_states[:-1])
        errs = [fp8_step_errs(before, card, cpu)
                for before, card, cpu in zip(card_states[:-1], card_states[1:], cpu_states[1:])]
        cases[f"{kind}-{recipe}"] = {
            "losses_cuda": card_losses, "losses_cpu": cpu_losses,
            "loss_rel_err": max(abs(a - c) / abs(c) for a, c in zip(card_losses, cpu_losses)),
            "update_rel_err": max(e[0] for e in errs), "worst_tensor": max(errs)[1],
            "history_rel_err": max(e[2] for e in errs),
        }
        free_memory(torch)
    row = {"phase": "fp8_consistency", "config": "TinyLlama widths 2 layers batch 1 x 256, bert-base widths 2 layers "
           "batch 8 x 128, mixed_precision=fp8, SGD 1e-2, each step from the card's state",
           "tol": FP8_CONSISTENCY_TOL, **cases}
    emit(row)
    for name, c in cases.items():
        for key, tol in FP8_CONSISTENCY_TOL.items():
            check(c[f"{key}_err"] <= tol, f"fp8_consistency {name}: {key} err {c[f'{key}_err']} <= {tol}")
    return row


def phase_fp8(torch, bf16_train=None):
    """The fp8 group: the products, the train step in both recipes (beside
    ``bf16_train``, the train phase's row, when it ran), the BERT-base
    fine-tune, the telemetry, then card against CPU."""
    matmul = phase_fp8_matmul(torch)
    train = phase_fp8_train(torch, bf16_train)
    bert = phase_bert_finetune(torch, "fp8")
    telemetry = phase_telemetry(torch)
    consistency = phase_fp8_consistency(torch)
    return {"matmul": matmul, "train": train, "bert": bert, "telemetry": telemetry, "consistency": consistency}


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    # `--only paged,flash,int4,reference,analysis,serve,consistency,train,bert,ckpt,imperative,fp8,resnet,families,sched,
    # dense`
    # runs some groups of phases
    # while a kernel is being worked on; it prints no kernels line and no "ok". `--seed N` makes the dense
    # group's prompt set (default 0)
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv else set()
    seed = int(sys.argv[sys.argv.index("--seed") + 1]) if "--seed" in sys.argv else 0

    train = None  # the train phase's row, when it runs: the fp8 group's bf16 baseline
    phase_build()
    print(smi, flush=True)
    if not only or "paged" in only:
        kernel = phase_kernel(torch)
        phase_kernel_sweep(torch)
        phase_kernel_mistral(torch)
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
    if not only or "ckpt" in only:
        phase_bert_resume(torch)
        phase_train_resume(torch)
    if not only or "imperative" in only:
        phase_imperative(torch)
    if not only or "fp8" in only:
        fp8_group = phase_fp8(torch, train)
    if not only or "resnet" in only:
        phase_resnet_train(torch)
        phase_resnet_consistency(torch)
        phase_resnet_resume(torch)
    if not only or "families" in only:
        gemma_serve = phase_gemma_serve(torch)
        gemma_train = phase_gemma_train(torch)
        gemma3_train = phase_gemma3_train(torch)
        families = phase_families_consistency(torch)
    if not only or "sched" in only:
        if only:
            phase_kernel_mistral(torch)
        sched = phase_sched(torch)
    if not only or "dense" in only:
        phase_dense(torch, seed)
    if only:
        emit({"partial": sorted(only)})
        return 0

    main_case = kernel["bf16"]  # the serving slice's dtype and shapes
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/pallas_paged_attention.py:40",
        # the serving paths: the bf16 model's, the int4 model's, LlamaConfig.tiny()'s (head dim 16),
        # Gemma-2B's (head dim 256), the banded families' 2-layer cuts and Mistral-7B-v0.1's three phases
        "launches": serve["kernel_launches"] + quant_serve["kernel_launches"] + tiny["kernel_launches"]
        + gemma_serve["kernel_launches"]
        + sum(r["paged_serve"]["kernel_launches"] for r in families["families"] if r["family"] in BANDED_SERVE)
        + sum(r["kernel_launches"] for r in sched.values()),
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
            # the training paths: TinyLlama's (D 64) in bf16 and in fp8 (both recipes), Gemma-2B's and
            # Gemma3-1B's (D 256)
            "launches": train["launches"][kind] + gemma_train["launches"][kind] + gemma3_train["launches"][kind]
            + sum(fp8_group["train"][recipe]["launches"][kind] for recipe in ("dynamic", "delayed")),
            "max_abs_err": row["max_abs_err"],
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
