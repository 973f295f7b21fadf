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
  widths (8 of its 22 layers) trained through ``accumulate`` / ``backward`` / ``optimizer.step``
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
  published widths cut to 1 layer (Gemma3 2) held on the card to the CPU (logits,
  greedy generate), and Phi-3-mini's widths (head dim 96, a 2047-key
  band) trained through the kernels against the einsum path. K1-K3 are
  held to their plain versions at D 96 and 256 too, and swept over head
  dims 16 to 256. The banded families' cuts (Mistral, Phi-3,
  Gemma3) are served paged on the card and held to the CPU engine; Gemma2
  on the paged engine raises, naming the dense layout;
* the paged engine's memory and scheduling (``--only sched``):
  Mistral-7B-v0.1 at full width, 2 of its 32 layers (seeded random
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
  dense``): Gemma-2-9B at full width, 4 of its 42 layers (seeded random
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
  fine-tune in fp8 at FP8_BERT_LAYERS (4) of its 12 layers
  (``fp8_bert``); a 4-layer fp8 step under
  ``accelerator.telemetry`` with the JSONL tracker (``telemetry``); and
  2-layer cuts of both models held card against CPU step by step
  (``fp8_consistency``). The fp8 products are library GEMMs, as the JAX
  package's are XLA dots: they add no row to the kernels line;
* the MoE families (``--only moe``): K1-K3 at Qwen3-30B-A3B's attention
  (B 1, S 2048, H 32/4, D 128) against their plain versions
  (``moe_flash``); Qwen3-30B-A3B at full width, 4 of its 48 layers
  (seeded random weights, f32 masters and bf16 compute), trained 2 + 10
  steps at 1 x 2048 through ``build_train_step`` and
  ``qwen3_moe_lm_loss`` with its router aux loss, every layer's attention
  through K1-K3 (launches == layers x steps), the aux loss and the share
  of routed assignments dropped at capacity reported, one step traced by
  operator kind (``qwen3_moe_train``); 2-layer f32 cuts of Mixtral and
  Qwen3-MoE held card against CPU, their routing asserted clear of ties
  (``moe_consistency``). The routing is index tensors and library GEMMs,
  as the JAX package's is one-hot einsums: no kernel of its own;
* the GPT decoders (``--only gpt``): K4 at GPT-NeoX-20B's and GPT-2's
  decode shapes (``gpt_kernel``); GPT-NeoX-20B at full width (6 of its 44
  layers in the full script, all 44 under ``--only gpt``; bf16) served on
  the paged engine with the serving traffic, K4 at D 96 in every decode
  step, greedy tokens against a no-cache loop, one tick traced
  (``neox_serve``); GPT-2 small served on the paged and the dense layout
  (``gpt2_serve``) and trained at 8 x 1024 on the einsum attention
  (``gpt2_train``); 2-layer f32 cuts of both held card against CPU:
  logits, greedy generate, the paged engine (``gpt_consistency``);
* the in-process serving fleet (``--only fleet``): TinyLlama-1.1B's widths
  at 4 of its 22 layers behind ``FleetRouter``; 48 requests on one engine and on 2
  paged replicas with prefix reuse on and off (K4 == layers x each
  replica's decode steps; one tick traced, ``fleet_serve``);
  prefill, decode, decode with the handoff forced and ``"auto"``, moved
  bytes == predicted (``fleet_disagg``); a crash with 24 requests in
  flight failing over by recompute and by KV, greedy and sampled, and a
  poison, zero lost (``fleet_chaos``); the event log through
  ``summarize_file`` against the router's accounting, a trace a request,
  ``spin_up`` with 0 ``nvcc`` builds (``fleet_telemetry``);
* the multi-process fleet (``--only proc``): TinyLlama-1.1B's widths at
  PROC_LAYERS (4) of its 22 layers in worker processes behind
  ``ProcessSupervisor``, each worker on the card: the 48 requests on 2
  paged workers, tokens held to one in-process engine's, K4 == layers x
  each worker's decode steps (counted in
  the worker, read in its status replies), each worker's tick traced in
  the worker (``proc_serve``); faults with 24 requests in flight: SIGKILL
  at ``mid_decode`` (failover by recompute, greedy and sampled; then the
  last worker killed: its requests lost with a reason), SIGSTOP
  (degraded, quarantined, respawned with 0 ``nvcc`` builds), a dense
  ``shadow_kv`` pair killed once its snapshots carry rows (KV failover,
  moved bytes == predicted, bit-equal to no fault), free card memory
  beside each kill (``proc_chaos``); ``python -m
  accelerate_tpu_torch.commands.serve`` over HTTP: JSON and SSE with the
  same tokens, a cancel, ``/metrics``, ``/healthz`` 200 then 503, SIGTERM
  exiting 0 (``proc_http``);
* the encoder-decoder families (``--only s2s``): T5-large at full width
  and depth (seeded random weights, bf16) serving 8 sources of 64-512
  tokens right-padded to 512 through ``generate_seq2seq`` (greedy, 64
  tokens; the encoder once a call, counted on its stack; the tokens held
  to one teacher-forced forward under serve's gap rule; garbage under the
  mask giving the same tokens; encoder ms, ITL, tokens/s, peak memory;
  one decode step traced: ``t5_serve``), trained at 16 x 512 source and
  128 target tokens through ``build_train_step(seq2seq_lm_loss)`` (f32
  masters, bf16 compute; losses falling; MFU from the step's FLOP count;
  one step traced by kind: ``t5_train``); Whisper-large-v3 likewise on 8
  log-mel inputs of 3,000 frames (1,500 encoder positions; the traced
  step's casts of the f32 cross K/V timed: ``whisper_serve``); 2 + 2-layer
  f32 cuts of both card against CPU (logits, the cached decode step by
  step, ``generate_seq2seq``) and T5's bucket ids on the card equal to the
  CPU's over +-4,096 (``s2s_consistency``). No kernel of the JAX package
  lies on these paths (T5's attention is an einsum with its bias, Whisper's
  1,500 positions are under ``FLASH_MIN_SEQ``, and both decode on the dense
  cache): K1-K5's counters read the same after the group;
* the vision families (``--only vision``): ViT-B/16 and CLIP ViT-L/14 at
  their published widths (seeded random weights, f32 masters, bf16
  compute) trained 10 steps on one repeated batch of 64 through
  ``build_train_step`` (samples/s or pairs/s, MFU from the step's FLOP
  count, peak memory, one step traced; CLIP's zero-shot 8 x 8), and their
  2-layer f32 cuts card against CPU with one step's gradients
  (``vision_consistency``). Every sequence is under ``FLASH_MIN_SEQ``:
  K1-K8's counters read the same after the group;
* the diffusion family (``--only diffusion``): K1-K3 at Stable Diffusion
  v1.5's head dim 40 (built at 64) against their plain versions at the
  UNet's self- (4,096 keys) and cross-attention (77) shapes, bf16 and f32,
  beside the bound, the plain version and SDPA (``flash_d40``);
  ``text_to_image`` at SD v1.5's widths (CLIP ViT-L/14's text tower, the
  711.8 M UNet, the VAE; bf16): 4 prompts, guidance 7.5, 50 DDIM steps, K1
  == 10 x 50 a call, images finite [4, 512, 512, 3], the text-encode,
  denoising-step and VAE-decode ms, one step traced (``t2i_serve``); the
  UNet trained at 8 x 512² through ``latent_diffusion_loss`` with the
  frozen VAE encoder and text tower in the step, K1 = K2 = K3 = 10 a step
  (``ldm_train``); a one-level UNet cut (K1 at D 40 on the card, the
  einsum on the CPU), a 2-level VAE and a 4-step guided DDIM card against
  CPU in f32 (``diffusion_consistency``). K4-K8's counters read the same
  after the group; its K1-K3 launches join the kernels line;
* the HF checkpoint importers (``--only hub``): TinyLlama-1.1B's widths at
  HUB_LAYERS (4) of its 22 layers written here as an HF checkpoint from seeded tensors (bf16,
  two shards and ``model.safetensors.index.json``) and imported by
  ``load_hf_llama`` onto the card (seconds, GB/s; the q/k projections
  re-paired for the interleaved rope and the untouched tensors checked bit
  for bit), served by the paged engine (K4; greedy tokens against the
  no-cache loop), quantized to int4 and decoded by ``generate`` (K5), and,
  loaded again with f32 masters, fine-tuned 3 steps at 8 x 2048 (K1-K3),
  each kernel's launches counted in the group and joining the kernels line;
* compile management (``--only aot``): three subprocesses of this script
  on one executable store, each with a fresh, empty kernel build
  directory. ``aot_cold`` serves TinyLlama-1.1B's widths at AOT_LAYERS (4)
  of its 22 layers (bf16, paged, auto-bucketing from the seed bucket 32
  over prompts of 17 to 700 tokens) through a ``ProgramCache`` (K4 ==
  layers x decode steps, greedy tokens held to the no-cache loop) and
  trains it 3 steps at 8 x 2048 under ``CompileKwargs`` from a loader that
  wrap-pads a 5-row tail (K1 24, K2 = K3 12): misses == its distinct
  programs, nvcc builds > 0.
  ``aot_warm`` runs both paths again: 0 nvcc builds, 0 misses, every
  program deserialized, the same tokens, bit-equal losses. ``aot_poison``
  corrupts K4's library entry and makes one prefill program's header
  foreign, then serves: 2 rejections, K4 built once, the same tokens;
* the launcher (``--only launch``): this script started again as a
  user's training script by the port's launcher (``python -m
  accelerate_tpu_torch.commands.cli launch``), bf16 from the launcher's
  YAML file and gradient accumulation 2 from its command line, read by an
  ``Accelerator()`` given neither: TinyLlama-1.1B at all 22 layers (f32
  masters, bf16 compute, remat) in microbatches of 4 x 2048, every layer's
  attention through K1-K3, saved after step 2, crashed after step 3,
  restarted by the launcher (``--max_restarts 1``) and resumed at step 3
  with ``load_state()``, the resumed step held to the unbroken one by the
  repeat (``launch_train``); ``checkpoints list`` / ``verify`` /
  ``describe``, ``merge-weights`` and ``estimate-memory`` on that
  checkpoint (``launch_ckpt``); ``env`` and ``test`` on the card
  (``launch_env``). Its K1-K3 launches join the kernels line.

Each phase prints one JSON line; any failed check exits non-zero. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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


# K4's cases at the serving slice's shapes: name, dtype, heads, kv_heads, dim, window, atol
KERNEL_CASES = [
    ("f32", "float32", 32, 4, 64, None, 1e-4),
    ("bf16", "bfloat16", 32, 4, 64, None, 2e-2),
    ("bf16-window256", "bfloat16", 32, 4, 64, 256, 2e-2),
    ("bf16-d128", "bfloat16", 32, 4, 128, None, 2e-2),
]


def phase_kernel(torch, cases=KERNEL_CASES, phase="kernel"):
    """The kernel against its plain version at the shapes of ``cases`` (B 8,
    128 blocks of 16 rows a table)."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    b, bs, mb = 8, 16, 128
    one = torch.zeros(1, device="cuda")
    results = {}
    for name, dtype_name_, heads, kv_heads, dim, window, atol in cases:
        dtype = getattr(torch, dtype_name_)
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
            "phase": phase, "case": name, "shape": [b, heads, kv_heads, dim, bs, mb], "window": window,
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


def serve_run(torch, model, phase, config, engine=None):
    """The serving configuration on ``model``: 12 prompts of 5-400 tokens,
    64 new tokens each, greedy. Every decode step's attention must be K4
    (on the paged engine; the dense one, ``engine=dense_engine``, runs none),
    and for a quantized model every projection of every forward K5."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import qmatmul

    cfg = model.config
    engine = engine or serve_engine
    # warm-up outside the measured run (library handles, allocator)
    engine(model).generate_many(
        [np.arange(1, 9, dtype=np.int32), np.arange(1, 300, dtype=np.int32)], max_new_tokens=9
    )

    rng = np.random.default_rng(1)
    lengths = [5, 400, 37, 64, 130, 256, 300, 12, 90, 200, 350, 48]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    max_new = 64
    free_memory(torch)  # the warm-up engine's pools, and whatever an earlier phase dropped
    eng = engine(model)
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
    want = cfg.num_hidden_layers * eng.decode_steps if eng.paged else 0
    check(launches == want, f"kernel launches {launches} == layers x decode steps {want} (paged: {eng.paged})")
    forwards = eng.prefill_forwards + eng.decode_steps
    want_int4 = 7 * cfg.num_hidden_layers * forwards if getattr(cfg, "quant_method", None) == "int4" else 0
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


def traced(torch, run, leads=(256, 2048, 8192), record_shapes=False, on_trace=None):
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
    does. ``record_shapes`` records the operators' input shapes, and
    ``on_trace(prof)`` is handed the profile that was kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt, lead in enumerate(leads, 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=record_shapes) as prof:
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
            if on_trace is not None:
                on_trace(prof)
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


def phase_flash_kernel(torch, cases=FLASH_CASES, phase="flash_kernel"):
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
        row = {"phase": phase, "case": name, "shape": [b, s, h, h_kv, d], "causal": True, "window": window,
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


# the banded families' cuts served paged, card against CPU: prompts that cross Phi-3's 2047-key band and
# Gemma3's 512-key one (blocks expire on Phi-3; Gemma3's full layer keeps them); Mistral's 4096-key band is crossed
# at full depth in mistral_serve, where a CPU run would take minutes
BANDED_SERVE = {"mistral": (5, 300), "phi3": (5, 2100), "gemma3": (5, 600)}


def banded_serve_card_vs_cpu(torch, cpu, card, family, lengths=None) -> dict:
    """``family``'s cut served by the paged engine on the card and on
    the CPU (2 slots, blocks of 16, 20 new tokens, greedy, f32): K4 launches
    == layers x decode steps, the pool drained, and the card's tokens equal
    the CPU engine's, a request's comparison ending only at a top-2 logit
    gap under 1e-3 of the CPU's forward on the shared context. ``lengths``
    (default: ``BANDED_SERVE[family]``) are the prompts' lengths."""
    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.ops import paged_attention as pa

    lengths = lengths or BANDED_SERVE[family]
    rng = np.random.default_rng(14)
    prompts = [rng.integers(1, cpu.config.vocab_size, size=n).astype(np.int32) for n in lengths]
    kw = dict(num_slots=2, prompt_buckets=(64, 512), paged_block_size=16, tick_block=4,
              max_len=min(4096, cpu.config.max_position_embeddings))
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
    return {"prompts": list(lengths), "window": getattr(card.config, "sliding_window", None),
            "kernel_launches": launches,
            "decode_steps": eng.decode_steps, "blocks_expired_mid_decode": freed, "tokens_compared": compared,
            "stopped_at_near_tie": near}


def phase_families_consistency(torch):
    """Each family at its published widths cut to 1 layer (Gemma3 keeps one
    sliding and one full layer), f32, drawn on the card and copied to the
    CPU (drawing a billion parameters on the CPU took most of the phase): the
    card's forward logits (batch 2 x 64) within 1e-4 of the CPU's
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
        # one layer since PR 18 (two before; the script's 1,200 s): Gemma3 keeps one sliding and one full
        kw = {"num_hidden_layers": 1}
        if family == "gemma3":
            kw = {"num_hidden_layers": 2, "layer_types": ("sliding_attention", "full_attention")}
        cfg = family_config(family, preset, **kw)
        t0 = time.perf_counter()
        card = create_llama_model(cfg, seed=5, device="cuda")
        cpu = Model(copy.deepcopy(card.module).to("cpu"), cfg, name=card.name)
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
# Mistral-7B-v0.1's 32 layers cut to 2 (its widths, band and engine kept): the whole script must end within its
# 1,200 s, and at full depth the three sched phases took 251 s of a 1,035 s run (PERF.md §4 lists each cut)
SCHED_LAYERS = 2
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
# full width, 4 of 42 layers (its softcaps, its 4096-key band on alternate layers)
# with a Gemma-2-2B draft; no kernel of the JAX package lies on these paths
# (the dense cache's attention is an einsum there as here)
# ---------------------------------------------------------------------------

# google/gemma-2-2b config.json, the draft: vocab 256,000, hidden 2,304, intermediate 9,216, 26 layers, 8/4
# heads, head dim 256, query_pre_attn_scalar 256, sliding_window 4,096, softcaps 50/30, tied embeddings (the
# rest Gemma2Config's defaults, which are google/gemma-2-9b's config.json: Gemma2Config.gemma2_9b())
GEMMA2_2B = dict(hidden_size=2304, intermediate_size=9216, num_hidden_layers=26, num_attention_heads=8,
                 num_key_value_heads=4, head_dim=256, query_pre_attn_scalar=256.0, sliding_window=4096)
# Gemma-2-9B's 42 layers cut to 4 and the draft's 26 to 2 (widths, softcaps and the alternating band kept), for
# the script's 1,200 s: the group's serving phases took 151 s of a 1,035 s run at full depth (PERF.md §4)
DENSE_TARGET_LAYERS, DENSE_DRAFT_LAYERS = 4, 2
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
    """2-layer f32 cuts of TinyLlama's and Gemma-2-9B's widths, drawn on the
    card and copied to the CPU, each with a 1-layer cut as its draft: the
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
        card, dcard = create_llama_model(cfg, seed=5, device="cuda"), create_llama_model(dcfg, seed=6, device="cuda")
        cpu, dcpu = (Model(copy.deepcopy(m.module).to("cpu"), m.config, name=m.name) for m in (card, dcard))
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


def phase_bert_finetune(torch, mixed_precision="bf16", layers=None):
    """examples/torch_nlp_example.py's loop on the card: BERT-base at full
    width and depth, or ``layers`` of its 12 (seeded random weights), f32
    masters and bf16 compute with the softmax in bf16
    (``mixed_precision="fp8"``: the fp8 policy, every encoder dense layer's
    product in fp8, the softmax in f32; phase ``fp8_bert``), AdamW(2e-5, weight decay 0.01) decaying
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
    cfg = BertConfig(**{**BERT_BASE, "num_hidden_layers": layers or BERT_BASE["num_hidden_layers"]})
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
        "config": f"bert-base-uncased shape, {cfg.num_hidden_layers} layers, seeded random weights, f32 masters + "
        f"bf16 compute, {precision}",
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


# the imperative phase trains TinyLlama's widths at 4 of its 22 layers: the script's 1,200 s with the process
# fleet's and the aot groups (PERF.md §4)
IMPERATIVE_LAYERS = 4


def phase_imperative(torch):
    """The imperative loop at the train phase's widths (TinyLlama-1.1B,
    IMPERATIVE_LAYERS of its 22 layers, f32 masters, bf16 compute, remat, AdamW(3e-4, weight decay
    0.01)): gradient accumulation 4 over 8 microbatches of 2 x 2048, so two
    optimizer steps, each microbatch ``with accumulate(model): backward(loss_fn,
    batch); optimizer.step(); optimizer.zero_grad()``; then
    ``build_train_step`` from the same weights on the same batches. The
    per-microbatch losses, every parameter and every AdamW tensor must be
    bit-equal between the two, and each path must launch K1 2 x layers x 8
    times and K2 and K3 layers x 8 times. A third run calls
    ``clip_grad_norm_(model, 1.0)`` in the loop: finite losses, parameters
    that differ from the unclipped run's. Each path's optimizer-step
    windows (4 microbatches, fenced once, as a training loop runs) are
    timed beside the other's, and one more window of each runs under
    torch.profiler (``traced``): its device busy ms say whether a gap
    between the wall times is the host's or the card's."""
    from accelerate_tpu_torch import LlamaConfig, causal_lm_loss
    from accelerate_tpu_torch.ops import flash_attention as fa

    b, s, accum, micro = 2, 2048, 4, 8
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": IMPERATIVE_LAYERS}, remat=True)
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
        "phase": "imperative", "config": f"TinyLlama-1.1B widths, {layers} of 22 layers, f32 masters + bf16 compute, remat, "
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


# the fp8 BERT fine-tune's depth: 4 of BERT-base's 12 layers (cut to keep the whole script inside its 1,200 s)
FP8_BERT_LAYERS = 4


def phase_fp8(torch, bf16_train=None):
    """The fp8 group: the products, the train step in both recipes (beside
    ``bf16_train``, the train phase's row, when it ran), the BERT-base
    fine-tune, the telemetry, then card against CPU."""
    matmul = phase_fp8_matmul(torch)
    train = phase_fp8_train(torch, bf16_train)
    bert = phase_bert_finetune(torch, "fp8", layers=FP8_BERT_LAYERS)
    telemetry = phase_telemetry(torch)
    consistency = phase_fp8_consistency(torch)
    return {"matmul": matmul, "train": train, "bert": bert, "telemetry": telemetry, "consistency": consistency}


# ---------------------------------------------------------------------------
# the MoE and GPT decoder families: Qwen3-30B-A3B trained at full width
# (``--only moe``), GPT-NeoX-20B and GPT-2 served and GPT-2 trained (``--only gpt``)
# ---------------------------------------------------------------------------

# Qwen/Qwen3-30B-A3B config.json: Qwen3MoeConfig.qwen3_30b_a3b()'s defaults (vocab 151,936, hidden 2048, 48
# layers, 32/4 heads, head dim 128, 128 experts, top-8, expert width 768, qk-norm, norm_topk_prob). Cut to 4 of
# its 48 layers: a layer holds 623.1 M parameters (604 M of them experts), the embedding and the head 311.2 M
# each, so 4 layers are 3.11 B parameters, whose f32 masters, gradients, AdamW moments and bf16 copies peaked at
# 52.4 GB on the H100
MOE_LAYERS = 4
# K1-K3 at the MoE step's attention: [B, S, H, H_kv, D] = Qwen3-30B-A3B's at batch 1 x 2048
MOE_FLASH_CASES = [("bf16-d128-qwen3moe", "bfloat16", [1, 2048, 32, 4, 128], None, 30)]
# the card-vs-CPU cuts: Mixtral's tiny() widths, and Qwen3-MoE's structure (qk-norm, head dim 128, norm_topk) at
# hidden 512 with 16 experts, top-4: widths at which no top-k choice of the checked batch lies within
# MOE_TIE_MARGIN of a tie (asserted), so both devices route alike
MOE_TIE_MARGIN = 1e-6
# one SGD step's update, card against CPU (f32), over the tensor's largest CPU update: weights whose gradient is a
# sum over tokens with cancellation read up to 6.9e-4 on the H100 (the Qwen3-MoE cut's post_attn_norm; Mixtral's
# expert gate_proj 1.45e-4), about a third of the limit
MOE_UPDATE_TOL = 2e-3
# EleutherAI/gpt-neox-20b config.json: GPTNeoXConfig.neox_20b()'s defaults (vocab 50,432, hidden 6144, 44 layers,
# 64 heads of 96, rotary on 24 dims, parallel residual). Served at full depth under --only gpt; the full script
# cuts it to NEOX_LAYERS to end inside its 1,200 s (PERF.md §4)
NEOX_LAYERS = 3
# K4 at the GPT serves' decode shapes: GPT-NeoX-20B's 64 heads of 96 and GPT-2's 12 heads of 64, MHA
GPT_KERNEL_CASES = [
    ("bf16-neox20b", "bfloat16", 64, 64, 96, None, 2e-2),
    ("bf16-gpt2", "bfloat16", 12, 12, 64, None, 2e-2),
]


def moe_active_params(module, cfg) -> float:
    """The parameters a token uses: every non-embedding one (the head
    included), but only ``num_experts_per_tok`` of the ``num_local_experts``
    experts."""
    share = cfg.num_experts_per_tok / cfg.num_local_experts
    return sum(p.numel() * (share if ".experts." in name else 1.0)
               for name, p in module.named_parameters() if "embed" not in name)


def moe_step_flops(module, cfg, tokens: int, seq_len: int) -> float:
    """The model's FLOPs for one training step: 6 x the active parameters
    (moe_active_params) x tokens, plus the attention scores (12 x batch x
    heads x head dim x the causal S^2 / 2 a layer). The dispatch and combine
    are not counted: they are routing, not the model's arithmetic."""
    active = moe_active_params(module, cfg)
    width = cfg.num_attention_heads * (cfg.head_dim or cfg.hidden_size // cfg.num_attention_heads)
    attn = 12.0 * (tokens // seq_len) * width * 0.5 * seq_len**2 * cfg.num_hidden_layers
    return 6.0 * active * tokens + attn


@contextlib.contextmanager
def routing_spy(moe_ops):
    """Keep each routing call's kept and total assignments and its aux loss
    (device tensors, read once the block is done)."""
    real, seen = moe_ops.route, []

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append((r.keep.sum(), r.keep.numel(), r.aux.detach()))
        return r

    moe_ops.route = spy
    try:
        yield seen
    finally:
        moe_ops.route = real


def moe_op_kind(key: str, shapes, t: int, e: int, k: int, vocab: int) -> str:
    """The kind of an operator of the MoE step (``t`` tokens, ``e`` experts,
    top-``k``), from its name and input shapes."""
    dims = [list(s) for s in shapes if isinstance(s, (list, tuple))]
    first = dims[0] if dims else []
    gemm = key in ("aten::mm", "aten::addmm", "aten::matmul", "aten::linear")
    if key in ("aten::bmm", "aten::baddbmm"):
        return "expert products" if first[:1] == [e] else "combine contraction" if first[:1] == [t] else "other"
    if key.startswith("aten::index") or key in ("aten::_index_put_impl_", "aten::sort", "aten::nonzero"):
        return "dispatch/combine gather-scatter"
    if (gemm and any(vocab in s for s in dims)) or any(s[-1:] == [vocab] and s[0] in (1, t) for s in dims if s):
        return "f32 head and loss"
    if gemm:
        return "dense projections"
    if len(first) == 3 and first[0] == e:
        return "expert elementwise and casts"
    if any(s in ([t, e], [e], [k, t]) for s in dims):
        return "routing loop"
    return "other"


def moe_step_kinds(prof, t: int, e: int, k: int, vocab: int, time_attr="self_device_time_total") -> tuple:
    """``({kind: device ms}, top operators)`` of a traced MoE step: each
    host event's own device time, given to the nearest ``aten::`` operator
    at or above it (a launch the runtime held, "Command Buffer Full",
    belongs to the operator that launched it) and sorted by moe_op_kind;
    the optimizer's and the flash attention's (forward and backward) go by
    their enclosing event."""
    from torch.autograd import DeviceType

    by_kind, by_op = {}, {}
    for ev in prof.events():
        ms = getattr(ev, time_attr, 0.0) / 1e3
        if ms <= 0 or ev.device_type != DeviceType.CPU:
            continue
        chain, parent = [ev], ev.cpu_parent
        while parent is not None:
            chain.append(parent)
            parent = parent.cpu_parent
        op = next((node for node in chain if node.name.startswith("aten::")), ev)
        if any(node.name.startswith("Optimizer.") for node in chain):
            kind = "optimizer"
        elif any("FlashAttention" in node.name for node in chain):
            kind = "flash K1-K3"
        else:
            kind = moe_op_kind(op.name, op.input_shapes or [], t, e, k, vocab)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        key = (op.name, str(op.input_shapes)[:70], kind)
        by_op[key] = by_op.get(key, 0.0) + ms
    top = sorted(([*key, ms] for key, ms in by_op.items()), key=lambda r: -r[-1])[:15]
    return by_kind, top


def phase_moe_flash(torch):
    """K1-K3 at Qwen3-30B-A3B's attention (B 1, S 2048, H 32/4, D 128, causal,
    bf16) against their plain versions, FLASH_TOL unchanged, timed beside
    the bound and scaled_dot_product_attention (phase_flash_kernel)."""
    return phase_flash_kernel(torch, MOE_FLASH_CASES, phase="moe_flash")[MOE_FLASH_CASES[0][0]]


def phase_qwen3_moe_train(torch):
    """Qwen3-30B-A3B at full width, MOE_LAYERS of its 48 layers, f32 masters
    and bf16 compute, AdamW(3e-4, weight decay 0.01; ``foreach=False``: the
    foreach kernels' temporaries would copy every moment at once), batch 1 x
    2048 through ``Accelerator(mixed_precision="bf16")`` -> ``prepare_model``
    / ``prepare_optimizer`` -> ``build_train_step(lambda p, b:
    qwen3_moe_lm_loss(p, b, module=model.module))``: 2 warm-up and 10 timed
    steps. Losses finite and falling; every layer's attention through the
    flash kernels, K1 = K2 = K3 = layers x steps (no remat); the aux loss
    and the share of routed assignments dropped at capacity reported. One
    more step traced: device ms by operator kind (the dispatch and combine
    gather-scatter, the expert products, the routing loop, the f32 head,
    K1-K3)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import Qwen3MoeConfig, create_qwen3_moe_model, qwen3_moe_lm_loss
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import moe as moe_ops
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    b, s, warmup, timed = 1, 2048, 2, 10
    cfg = Qwen3MoeConfig.qwen3_30b_a3b(num_hidden_layers=MOE_LAYERS)
    free_memory(torch)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    t0 = time.perf_counter()
    acc = Accelerator(mixed_precision="bf16")
    model = acc.prepare_model(create_qwen3_moe_model(cfg, seed=0))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=3e-4, weight_decay=0.01, foreach=False))
    step = acc.build_train_step(lambda p, batch: qwen3_moe_lm_loss(p, batch, module=model.module))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batches = token_batches(torch, warmup + timed, b, s, cfg.vocab_size, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    losses, times = [], []
    with routing_spy(moe_ops) as routed:
        for i in range(warmup + timed):
            t1 = time.perf_counter()
            loss = step({"input_ids": batches[i]})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n, layers = warmup + timed, cfg.num_hidden_layers
    check(all(np.isfinite(losses)), f"qwen3_moe_train: losses finite: {losses}")
    check(losses[-1] < losses[0], f"qwen3_moe_train: loss falls over {n} steps: {losses[0]} -> {losses[-1]}")
    check(launches == {"fwd": layers * n, "dq": layers * n, "dkv": layers * n},
          f"qwen3_moe_train: flash launches {launches} == K1, K2, K3 {layers} x {n}")
    check(len(routed) == layers * n, f"qwen3_moe_train: {len(routed)} routing calls == layers x steps")
    kept = [float(k) / total for k, total, _ in routed]
    aux = [float(a) for _, _, a in routed]
    aux_by_step = [float(np.mean(aux[i * layers:(i + 1) * layers])) for i in range(n)]
    check(all(np.isfinite(aux_by_step)), f"qwen3_moe_train: aux losses finite: {aux_by_step}")
    step_ms = sorted(times[warmup:])
    med = statistics.median(step_ms)
    flops = moe_step_flops(model.module, cfg, b * s, s)

    # one more step traced: device time by kernel and by operator kind
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step({"input_ids": batches[0]})
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t1) * 1e3
    profs = []
    events, wall_ms, attempts, lost = traced(torch, lambda: step({"input_ids": batches[1]}), record_shapes=True,
                                             on_trace=profs.append)
    busy, by_name = device_time(events)
    flash_names = ("flash_fwd", "flash_dq", "flash_dkv")
    flash_ms = sum(ms for name, (ms, _) in by_name.items() if any(f in name for f in flash_names))
    by_kind, top_ops = moe_step_kinds(profs[0], b * s, cfg.num_local_experts, cfg.num_experts_per_tok,
                                      cfg.vocab_size)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    row = {
        "phase": "qwen3_moe_train",
        "config": f"Qwen3-30B-A3B widths, {layers} of 48 layers, f32 masters + bf16 compute, seeded",
        "reduced": {"num_hidden_layers": [layers, 48]}, "params": model.num_parameters(),
        "active_params_per_token": int(moe_active_params(model.module, cfg)),
        "batch": b, "seq": s, "warmup_steps": warmup, "timed_steps": timed, "model_build_s": build_s,
        "tokens_per_s": b * s / (med / 1e3), "step_ms_median": med,
        "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1], "step_flops": flops,
        "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak,
        "memory_total_gb": torch.cuda.get_device_properties(0).total_memory / 1e9, "losses": losses,
        "aux_loss_by_step": aux_by_step, "dropped_share": 1.0 - float(np.mean(kept)),
        "dropped_share_max_layer": 1.0 - min(kept), "launches": launches,
        "profile": {
            "step_wall_ms": wall_ms, "step_wall_ms_unprofiled": plain_wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else None, "flash_ms_by_kernel_name": flash_ms,
            "device_ms_by_kind": by_kind, "device_ms_by_kind_sum": sum(by_kind.values()),
            "kernels_traced": sum(c for _, c in by_name.values()),
            "trace_attempts": attempts, "trace_lead_lost": lost,
            "top_kernels": [[name[:90], ms, c] for name, (ms, c) in top], "top_ops": top_ops,
        },
    }
    emit(row)
    del acc, model, step, batches, profs
    free_memory(torch)
    return row


def routing_margin(torch, model, ids) -> float:
    """The smallest gap, over the layers and tokens of one forward of
    ``model`` on ``ids``, between consecutive router probabilities among
    each token's top k + 1 (the last choice and the first not chosen
    included): how far the routing is from a tie."""
    from accelerate_tpu_torch.ops import moe as moe_ops

    real, gaps = moe_ops.route, []

    def spy(logits, k, capacity, norm_topk=True):
        p = torch.softmax(logits.float(), -1).sort(-1, descending=True).values[:, : k + 1]
        gaps.append(float((p[:, :-1] - p[:, 1:]).min()))
        return real(logits, k, capacity, norm_topk)

    moe_ops.route = spy
    try:
        with torch.no_grad():
            model(ids)
    finally:
        moe_ops.route = real
    return min(gaps)


def moe_step_on(torch, cpu_model, device, batch, lr):
    """One SGD(lr) step of ``mixtral_lm_loss`` through an Accelerator on
    ``device`` (f32, TF32 off), from a copy of ``cpu_model``'s weights:
    ``(loss, {name: update on the CPU})``."""
    import copy

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models import mixtral_lm_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    model = Model(copy.deepcopy(cpu_model.module), cpu_model.config, name=cpu_model.name)
    acc = Accelerator(cpu=device == "cpu", mixed_precision="no")
    model = acc.prepare_model(model)
    acc.prepare_optimizer(torch.optim.SGD(model.module.parameters(), lr=lr))
    step = acc.build_train_step(lambda p, b: mixtral_lm_loss(p, b, module=model.module))
    before = {n: p.detach().cpu().clone() for n, p in model.module.named_parameters()}
    loss = float(step({"input_ids": batch.to(device)}))
    return loss, {n: p.detach().cpu() - before[n] for n, p in model.module.named_parameters()}


def phase_moe_consistency(torch):
    """2-layer f32 cuts of Mixtral (``tiny()`` widths) and Qwen3-MoE (its
    structure at hidden 512, 16 experts, top-4), built on the CPU and copied
    to the card, on a batch of 2 x 64 whose routing lies at least
    MOE_TIE_MARGIN from a tie (asserted on the CPU): the card's logits within
    1e-4 of the CPU's RMS, its per-layer aux losses within 1e-5, one SGD
    step's loss within 1e-5 relative and every parameter's update within
    MOE_UPDATE_TOL of that tensor's largest CPU update."""
    import copy

    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models import MixtralConfig, Qwen3MoeConfig, create_mixtral_model

    cuts = {
        "mixtral": MixtralConfig.tiny(),
        "qwen3_moe": Qwen3MoeConfig.qwen3_30b_a3b(num_hidden_layers=2, vocab_size=4096, hidden_size=512,
                                                  num_attention_heads=4, num_key_value_heads=2,
                                                  num_local_experts=16, num_experts_per_tok=4,
                                                  moe_intermediate_size=256),
    }
    rows = []
    for family, cfg in cuts.items():
        cpu = create_mixtral_model(cfg, seed=5, device="cpu")
        card = Model(copy.deepcopy(cpu.module).to("cuda"), cfg, name=cpu.name)
        ids = torch.as_tensor(np.random.default_rng(15).integers(1, cfg.vocab_size, size=(2, 64)))
        margin = routing_margin(torch, cpu, ids)
        check(margin > MOE_TIE_MARGIN, f"{family}: routing {margin} from a tie > {MOE_TIE_MARGIN}")
        with torch.no_grad():
            want, want_aux = cpu(ids, with_aux=True)
            got, got_aux = card(ids.cuda(), with_aux=True)
        got = got.cpu()
        rms = float(want.pow(2).mean().sqrt())
        err = float((got - want).abs().max())
        aux_err = max(abs(float(g) - float(w)) for g, w in zip(got_aux, want_aux))
        check(bool(torch.isfinite(got).all()) and err <= 1e-4 * rms,
              f"{family}: card logits within 1e-4 of the CPU's RMS: {err} vs {rms}")
        check(aux_err <= 1e-5, f"{family}: card aux losses within 1e-5 of the CPU's: {aux_err}")
        lr = 1e-2
        cpu_loss, cpu_upd = moe_step_on(torch, cpu, "cpu", ids, lr)
        card_loss, card_upd = moe_step_on(torch, cpu, "cuda", ids, lr)
        loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
        upd_errs = {n: float((card_upd[n] - u).abs().max() / u.abs().max().clamp_min(1e-30))
                    for n, u in cpu_upd.items()}
        worst = max(upd_errs, key=upd_errs.get)
        check(loss_err <= 1e-5, f"{family}: card step loss within 1e-5 of the CPU's: {loss_err}")
        check(upd_errs[worst] <= MOE_UPDATE_TOL,
              f"{family}: card updates within {MOE_UPDATE_TOL} of the CPU's largest: {worst} {upd_errs[worst]}")
        rows.append({"family": family, "params": cpu.num_parameters(), "routing_margin": margin,
                     "logits_max_abs_err": err, "logits_rms": rms, "aux_max_abs_err": aux_err,
                     "step_loss_rel_err": loss_err, "update_err_over_max": upd_errs[worst], "worst_tensor": worst})
        del cpu, card
        free_memory(torch)
    row = {"phase": "moe_consistency", "cuts": rows}
    emit(row)
    return row


def dense_engine(model):
    from accelerate_tpu_torch import ServingEngine

    return ServingEngine(model, num_slots=8, prompt_buckets=(64, 256), tick_block=8)


def served_against_reference(torch, model, engine, seed, lengths=(5, 130, 400), new=32):
    """``engine(model)`` serves prompts of ``lengths`` (greedy), each held to
    the no-cache loop over the full forward under serve's gap rule
    (greedy_against_reference, SERVE_BF16_GAP): ``(tokens compared,
    requests stopped at a near tie, max logprob error)``."""
    eng, rng = engine(model), np.random.default_rng(seed)
    prompts = [rng.integers(1, model.config.vocab_size, size=n).astype(np.int32) for n in lengths]
    uids = [eng.submit(p, new) for p in prompts]
    eng.run()
    served = [(p, eng.poll(uid)[len(p):], eng.logprobs(uid)) for uid, p in zip(uids, prompts)]
    del eng
    free_memory(torch)
    compared, near, lp_err = greedy_against_reference(torch, model, served, gap_limit=SERVE_BF16_GAP)
    check(compared > 0, "tokens compared against the no-cache loop")
    return compared, near, lp_err


def phase_neox_serve(torch, layers):
    """GPT-NeoX-20B at full width (hidden 6144, 64 heads of 96, rotary on 24
    dims, parallel residual, vocab 50,432), ``layers`` of its 44, bf16 on
    seeded random weights, served by the paged engine with serve's traffic
    (8 slots, 12 prompts of 5-400 tokens, 64 new, greedy): every decode
    step's attention through K4 at D 96, MHA (launches == layers x decode
    steps); three requests' greedy tokens held to a no-cache loop over the
    full forward under serve's gap rule; one decode tick traced for its
    idle share."""
    from accelerate_tpu_torch.models import GPTNeoXConfig, create_gptneox_model

    cfg = GPTNeoXConfig.neox_20b(num_hidden_layers=layers)
    free_memory(torch)
    t0 = time.perf_counter()
    model = create_gptneox_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    what = f"GPT-NeoX-20B widths, {layers} of 44 layers, bf16, seeded random weights"
    row = serve_run(torch, model, "neox_serve", what)
    compared, near, lp_err = served_against_reference(torch, model, serve_engine, seed=8)
    profile = phase_profile(torch, model, phase="neox_profile", what=what)
    row.update(model_build_s=build_s, head_dim=cfg.hidden_size // cfg.num_attention_heads,
               heads=[cfg.num_attention_heads, cfg.num_attention_heads], tokens_compared=compared,
               stopped_at_near_tie=near, max_logprob_err=lp_err, tick_idle_share=profile["idle_share"],
               tick_wall_ms=profile["tick_wall_ms"], tick_device_busy_ms=profile["device_busy_ms"])
    if layers < 44:
        row["reduced"] = {"num_hidden_layers": [layers, 44]}
    emit(row)
    del model
    free_memory(torch)
    return row


def phase_gpt2_serve(torch):
    """GPT-2 small (openai-community/gpt2's config.json: 768, 12 x 12 heads,
    1,024 positions, tied head) at full width and depth, bf16, seeded:
    serve's traffic on the paged engine (K4 at D 64, MHA; launches == 12 x
    decode steps) and on the dense one (no K4), and on each layout three
    requests held to the no-cache loop under serve's gap rule."""
    from accelerate_tpu_torch.models import GPT2Config, create_gpt2_model

    free_memory(torch)
    model = create_gpt2_model(GPT2Config.small(), seed=0, dtype=torch.bfloat16)
    rows = {}
    for layout, engine in (("paged", serve_engine), ("dense", dense_engine)):
        row = serve_run(torch, model, "gpt2_serve", f"GPT-2 small, bf16, seeded random weights, {layout} layout",
                        engine=engine)
        compared, near, lp_err = served_against_reference(torch, model, engine, seed=9)
        row.update(layout=layout, tokens_compared=compared, stopped_at_near_tie=near, max_logprob_err=lp_err)
        emit(row)
        rows[layout] = row
    del model
    free_memory(torch)
    return rows


def phase_gpt2_train(torch):
    """GPT-2 small at full width and depth, f32 masters, bf16 compute,
    AdamW(3e-4, weight decay 0.01), batch 8 x 1024 through
    ``build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))``:
    2 warm-up and 10 timed steps, losses finite and falling. S 1024 is under
    FLASH_MIN_SEQ, so the attention is the einsum path, as in the JAX
    package: no K1 launch."""
    from accelerate_tpu_torch import Accelerator, causal_lm_loss
    from accelerate_tpu_torch.models import GPT2Config, create_gpt2_model
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    b, s, warmup, timed = 8, 1024, 2, 10
    cfg = GPT2Config.small()
    free_memory(torch)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    model = acc.prepare_model(create_gpt2_model(cfg, seed=0))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=3e-4, weight_decay=0.01))
    step = acc.build_train_step(lambda p, batch: causal_lm_loss(p, batch, model.apply_fn))
    batches = token_batches(torch, warmup + timed, b, s, cfg.vocab_size, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = 0
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(float(step({"input_ids": batches[i]})))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"gpt2_train: losses finite: {losses}")
    check(losses[-1] < losses[0], f"gpt2_train: loss falls: {losses[0]} -> {losses[-1]}")
    check(fa.launches_fwd == 0, f"gpt2_train: S {s} < FLASH_MIN_SEQ runs the einsum path ({fa.launches_fwd} K1)")
    step_ms = sorted(times[warmup:])
    med = statistics.median(step_ms)
    body = sum(p.numel() for name, p in model.module.named_parameters() if name.startswith("layers."))
    flops = 6.0 * (body + cfg.hidden_size * cfg.vocab_size) * b * s + 12.0 * b * cfg.hidden_size * 0.5 * s * s \
        * cfg.num_hidden_layers
    row = {
        "phase": "gpt2_train", "config": "GPT-2 small, 12 layers, f32 masters + bf16 compute, seeded",
        "params": model.num_parameters(), "batch": b, "seq": s, "warmup_steps": warmup, "timed_steps": timed,
        "tokens_per_s": b * s / (med / 1e3), "step_ms_median": med,
        "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1], "step_flops": flops,
        "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses, "k1_launches": 0,
    }
    emit(row)
    del acc, model, step, batches
    free_memory(torch)
    return row


def phase_gpt_consistency(torch):
    """GPT-2 and GPT-NeoX-20B at their published widths cut to 2 layers, f32,
    drawn on the card and copied to the CPU: the card's logits (batch 2 x 64)
    within 1e-4 of the CPU's RMS; greedy generate of 8 tokens after 16 equal
    to the CPU's (a token differing only where the CPU's top-2 gap is under
    1e-3, which ends that row); the paged engine on the card against the
    CPU's (banded_serve_card_vs_cpu: prompts of 5 and 40 tokens, K4
    launches == layers x decode steps)."""
    import copy

    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models import GPT2Config, GPTNeoXConfig, create_gpt2_model, create_gptneox_model

    rows = []
    rng = np.random.default_rng(16)
    for family, cfg, create in (("gpt2", GPT2Config.small(num_hidden_layers=2), create_gpt2_model),
                                ("gptneox", GPTNeoXConfig.neox_20b(num_hidden_layers=2), create_gptneox_model)):
        t0 = time.perf_counter()
        card = create(cfg, seed=5, device="cuda")
        cpu = Model(copy.deepcopy(card.module).to("cpu"), cfg, name=card.name)
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
        compared = near = 0
        for r in range(2):
            diff = np.nonzero(want_tok[r, 16:] != got_tok[r, 16:])[0]
            upto = int(diff[0]) if len(diff) else 8
            compared += upto
            if len(diff):
                with torch.no_grad():
                    top2 = torch.topk(cpu(torch.as_tensor(want_tok[r:r + 1, :16 + upto]))[0, -1], 2).values
                gap = float(top2[0] - top2[1])
                check(gap < 1e-3, f"{family}: generated token {upto} differs with top-2 gap {gap}")
                near += 1
        serve = banded_serve_card_vs_cpu(torch, cpu, card, family, lengths=(5, 40))
        rows.append({"family": family, "params": cpu.num_parameters(), "logits_max_abs_err": err, "logits_rms": rms,
                     "tokens_compared": compared, "stopped_at_near_tie": near, "paged_serve": serve,
                     "seconds": time.perf_counter() - t0})
        del cpu, card
        free_memory(torch)
    row = {"phase": "gpt_consistency", "families": rows}
    emit(row)
    return row


def phase_moe(torch) -> dict:
    """The MoE group: K1-K3 at Qwen3-30B-A3B's attention, its training step,
    the 2-layer cuts card against CPU."""
    flash = phase_moe_flash(torch)
    train = phase_qwen3_moe_train(torch)
    phase_moe_consistency(torch)
    return {"flash": flash, "train": train}


def phase_gpt(torch, neox_layers: int) -> dict:
    """The GPT group: K4 at the GPT serves' shapes, GPT-NeoX-20B and GPT-2
    served, GPT-2 trained, the 2-layer cuts card against CPU."""
    kernel = phase_kernel(torch, GPT_KERNEL_CASES, phase="gpt_kernel")
    neox = phase_neox_serve(torch, neox_layers)
    gpt2 = phase_gpt2_serve(torch)
    phase_gpt2_train(torch)
    consistency = phase_gpt_consistency(torch)
    k4 = neox["kernel_launches"] + gpt2["paged"]["kernel_launches"] + sum(
        r["paged_serve"]["kernel_launches"] for r in consistency["families"])
    return {"kernel": kernel, "k4_launches": k4}


# --------------------------------------------------------------------- #
# the in-process serving fleet and its telemetry (--only fleet)
# --------------------------------------------------------------------- #

# TinyLlama at full depth behind every replica: paged with block 16 (K4 in
# every decode tick) or, for the KV failover legs, the dense layout
FLEET_ENGINE = dict(num_slots=8, prompt_buckets=(64, 256, 1024), paged_block_size=16, tick_block=8, max_len=1536)
FLEET_DENSE = {k: v for k, v in FLEET_ENGINE.items() if k != "paged_block_size"}
FLEET_PREAMBLE = 1024
FLEET_NEW = 64
FLEET_CHAOS = 24  # requests in flight when a replica fails
FLEET_CHAOS_NEW = 32  # their new tokens (the chaos and telemetry legs: the group's share of the 1,200 s)
# the in-process fleet group serves TinyLlama's widths at 4 of its 22 layers since PR 18 (22 in PR 17): with the
# process fleet's group at all 22 the script ran 1,216 s of its 1,200 (PERF.md §4)
FLEET_LAYERS = 4


def fleet_prompts(vocab: int, seed: int = 17) -> list:
    """48 prompts in a seeded order: 36 share a 1,024-token system preamble
    followed by a suffix of 32-256 tokens, 12 are unique prompts of
    64-1,024 tokens."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, vocab, size=FLEET_PREAMBLE).astype(np.int32)
    shared = [np.concatenate([pre, rng.integers(1, vocab, size=int(n))]).astype(np.int32)
              for n in rng.integers(32, 257, size=36)]
    unique = [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in rng.integers(64, 1025, size=12)]
    prompts = shared + unique
    return [prompts[i] for i in rng.permutation(len(prompts))]


def fleet_k4(fr) -> int:
    """K4 launches the fleet's paged replicas owe: layers x each one's decode steps."""
    return sum(r.engine.model.config.num_hidden_layers * r.engine.decode_steps for r in fr.replicas if r.engine.paged)


def fleet_outputs(fr, fuids) -> list:
    out = []
    for f in fuids:
        got = fr.poll(f)
        check(got is not None, f"fleet request {f} completed")
        out.append((got, fr.logprobs(f)))
    return out


def fleet_against(torch, model, prompts, got, want, what, exact=False, new=FLEET_NEW) -> dict:
    """Each request's generated tokens in a fleet run against another run
    of the same prompts: equal, but where they part the top-2 gap on the
    shared context must be under SERVE_BF16_GAP (against_run), and
    logprobs within SERVE_LP_LIMIT over the tokens compared; ``exact``:
    tokens and logprobs bit-equal."""
    compared = parted = 0
    lp_diff = 0.0
    for p, (g, g_lp), (w, w_lp) in zip(prompts, got, want):
        check(len(g) == len(p) + new and np.array_equal(g[: len(p)], p), f"{what}: the prompt and {new} new")
        if exact:
            check(np.array_equal(g, w) and np.array_equal(g_lp, w_lp), f"{what}: tokens and logprobs bit-equal")
            compared += new
            continue
        # the control generated FLEET_NEW: its first `new` tokens are this run's reference
        w, w_lp = w[: len(p) + new], w_lp[:new]
        n, part, d = against_run(torch, model, p, g[len(p):], g_lp, w[len(p):], w_lp, rows=FLEET_ENGINE["max_len"])
        compared, parted, lp_diff = compared + n, parted + part, max(lp_diff, d)
    check(lp_diff <= SERVE_LP_LIMIT, f"{what}: logprobs within {SERVE_LP_LIMIT} ({lp_diff})")
    return {"tokens_compared": compared, "parted_at_near_tie": parted, "max_logprob_diff": lp_diff}


def fleet_run(torch, fr, prompts) -> dict:
    """Submit every prompt, drain the fleet with ``run()`` (``step()`` until
    idle), and check K4's launches: the wrapper's count equals layers x
    decode steps summed over the paged replicas."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    torch.cuda.synchronize()
    pa.launches = 0
    t0 = time.perf_counter()
    fuids = [fr.submit(p, FLEET_NEW) for p in prompts]
    fr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4 = pa.launches
    check(k4 == fleet_k4(fr), f"fleet: K4 launches {k4} == layers x decode steps summed over replicas {fleet_k4(fr)}")
    snap = fr.metrics_merged().snapshot()
    return {"fuids": fuids, "outputs": fleet_outputs(fr, fuids), "wall_s": wall, "kernel_launches": k4,
            "tokens_per_s": snap["tokens_generated"] / wall, "ttft_ms_p50": snap["ttft_ms_p50"],
            "ttft_ms_p95": snap["ttft_ms_p95"], "itl_ms_p50": snap["itl_ms_p50"],
            "decode_steps": {r.name: r.engine.decode_steps for r in fr.replicas},
            "requests": {r.name: r.engine.metrics.requests_completed for r in fr.replicas}}


def fleet_tick_idle(torch, fr) -> dict:
    """One tick of the drained 2-replica fleet ``fr`` (prefix reuse off),
    both replicas decoding 8 slots (prompts of 200 tokens): its wall time
    without the profiler, and the device's busy time in the next tick under
    torch.profiler (``traced``)."""
    rng = np.random.default_rng(5)
    vocab = fr.replicas[0].engine.model.config.vocab_size
    for _ in range(16):
        fr.submit(rng.integers(1, vocab, size=200).astype(np.int32), FLEET_NEW)
    fr.step()
    fr.step()
    check(all(ph == "decode" for r in fr.replicas for ph in r.engine.slot_phase), "fleet tick: 16 slots decoding")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events, _, attempts, _ = traced(torch, fr.step)
    busy, _ = device_time(events)
    return {"tick_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "trace_attempts": attempts}


def phase_fleet_serve(torch, model, prompts) -> dict:
    """The 48 requests served by one engine (the control), then by
    ``FleetRouter.from_model(model, num_replicas=2, paged_block_size=16)``
    driven by ``step()`` with prefix reuse on and off. Greedy tokens equal
    the control's up to a near tie; the radix cache promotes the preamble
    and its hits show in ``radix_stats``; K4's count equals layers x each
    replica's decode steps, summed."""
    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving_fleet import FleetConfig, FleetRouter

    ServingEngine(model, **FLEET_ENGINE).generate_many([prompts[0][:300]], max_new_tokens=9)  # warm-up
    eng = ServingEngine(model, **FLEET_ENGINE)
    torch.cuda.synchronize()
    pa.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, FLEET_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(pa.launches == model.config.num_hidden_layers * eng.decode_steps, "fleet control: K4 launches")
    control_out = [(eng.poll(u), eng.logprobs(u)) for u in uids]
    snap = eng.metrics.snapshot()
    control = {"wall_s": wall, "tokens_per_s": snap["tokens_generated"] / wall, "ttft_ms_p50": snap["ttft_ms_p50"],
               "ttft_ms_p95": snap["ttft_ms_p95"], "kernel_launches": pa.launches,
               "decode_steps": eng.decode_steps}
    del eng
    free_memory(torch)
    runs = {}
    for name, reuse in (("reuse_on", True), ("reuse_off", False)):
        fr = FleetRouter.from_model(model, num_replicas=2, config=FleetConfig(prefix_reuse=reuse), **FLEET_ENGINE)
        run = fleet_run(torch, fr, prompts)
        run["against_control"] = fleet_against(torch, model, prompts, run.pop("outputs"), control_out,
                                               f"fleet serve ({name})")
        del run["fuids"]
        if reuse:
            stats = fr.radix_stats()
            run["radix_stats"] = stats
            hits = sum(s["hits"] for s in stats.values())
            check(sum(s["registrations"] for s in stats.values()) >= 1 and hits >= 1
                  and sum(s["tokens_reused"] for s in stats.values()) >= FLEET_PREAMBLE * hits,
                  f"fleet serve: the preamble promoted and hit ({stats})")
        else:
            tick = fleet_tick_idle(torch, fr)  # the drained fleet serves the tick's 16 requests
        runs[name] = run
        del fr
        free_memory(torch)
    row = {"phase": "fleet_serve", "config": f"TinyLlama-1.1B shape, {FLEET_LAYERS} layers, bf16, seeded random weights; "
           "2 paged replicas (block 16) of 8 slots", "requests": len(prompts), "max_new_tokens": FLEET_NEW,
           "prompt_lengths": [len(p) for p in prompts], "control": control, **runs,
           "tick": tick,
           "kernel_launches": control["kernel_launches"] + sum(r["kernel_launches"] for r in runs.values())}
    emit(row)
    return {"row": row, "control": control_out}


@contextlib.contextmanager
def timed_handoff_copies(torch, fr):
    """Time every rows-out (``KVCache.host_rows`` in ``prefill_detached``)
    and rows-in (each replica's ``_rows_to_device`` at the paste) of the
    handoffs, the card idle before and after each copy; yields the
    running totals."""
    from accelerate_tpu_torch.ops import kv_cache

    acc = {"d2h_s": 0.0, "h2d_s": 0.0, "bytes": 0, "copies": 0}
    lock = threading.Lock()  # the decode replicas paste from threads of their own
    host_rows = kv_cache.KVCache.host_rows

    def out(self, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = host_rows(self, n)
        with lock:
            acc["d2h_s"] += time.perf_counter() - t0
            acc["bytes"] += sum(x.numel() * x.element_size() for x in rows.values())
            acc["copies"] += 1
        return rows

    def timed_back(to_device):
        def back(rows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = to_device(rows)
            torch.cuda.synchronize()
            with lock:
                acc["h2d_s"] += time.perf_counter() - t0
            return cache

        return back

    kv_cache.KVCache.host_rows = out
    for rep in fr.replicas:
        rep.engine._rows_to_device = timed_back(rep.engine._rows_to_device)
    try:
        yield acc
    finally:
        kv_cache.KVCache.host_rows = host_rows


def phase_fleet_disagg(torch, model, prompts, control_out) -> dict:
    """``roles=("prefill", "decode", "decode")``, ``handoff`` forced and
    then ``"auto"``, driven by ``step()``: the router's moved bytes equal
    its predicted bytes exactly, and greedy tokens equal the control's up
    to a near tie. The handoffs' measured round trip (device to host and
    back) beside the costmodel's ``h100`` row, and the handoffs ``"auto"``
    chose."""
    from accelerate_tpu_torch.analysis.costmodel import HANDOFF_BW_TABLE
    from accelerate_tpu_torch.serving_fleet import FleetConfig, FleetRouter

    runs = {}
    for mode in ("always", "auto"):
        fr = FleetRouter.from_model(model, num_replicas=3, config=FleetConfig(
            roles=("prefill", "decode", "decode"), handoff=mode), **FLEET_ENGINE)
        with timed_handoff_copies(torch, fr) as copies:
            run = fleet_run(torch, fr, prompts)
        acc = fr.handoff_accounting()
        check(acc["bytes_moved"] == acc["bytes_predicted"],
              f"fleet disagg ({mode}): moved bytes {acc['bytes_moved']} == predicted {acc['bytes_predicted']}")
        check(acc["handoffs"] + acc["handoffs_local"] == len(prompts), f"fleet disagg ({mode}): every request decided")
        if mode == "always":
            check(acc["handoffs"] == len(prompts) and acc["bytes_moved"] > 0, "fleet disagg: every request handed off")
        run["against_control"] = fleet_against(torch, model, prompts, run.pop("outputs"), control_out,
                                               f"fleet disagg ({mode})")
        del run["fuids"]
        run["handoff_accounting"] = acc
        secs = copies["d2h_s"] + copies["h2d_s"]
        run["handoff_copies"] = {**copies, "round_trip_bytes_per_s": copies["bytes"] / secs if secs else None}
        runs[mode] = run
        del fr
        free_memory(torch)
    row = {"phase": "fleet_disagg", "config": f"TinyLlama-1.1B shape, {FLEET_LAYERS} layers, bf16; roles prefill, decode, "
           "decode (paged, block 16, 8 slots each)", **runs,
           "costmodel_h100_bytes_per_s": HANDOFF_BW_TABLE["h100"],
           "kernel_launches": sum(r["kernel_launches"] for r in runs.values())}
    emit(row)
    return row


def chaos_leg(torch, model, prompts, engine, chaos_kw, *, sampled=False, threaded=False, **cfg_kw):
    """A fleet of ``engine`` replicas (2 dense, or 3 paged) with
    ``FLEET_CHAOS`` requests in flight (``FLEET_CHAOS_NEW`` new tokens
    each), the fault ``chaos_kw`` injected on r1 after two ticks, driven by
    ``step()`` (or one thread a replica) to the end. Returns the router and
    the outputs; ``chaos_kw`` None: the no-fault control."""
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.serving_fleet import FleetConfig, FleetRouter
    from accelerate_tpu_torch.test_utils.fault_injection import ReplicaChaos

    kw = dict(temperature=0.8, top_k=50, seed=3) if sampled else {}
    n = 3 if "paged_block_size" in engine else 2
    fr = FleetRouter.from_model(model, num_replicas=n, config=FleetConfig(prefix_reuse=False, **cfg_kw), trace=True,
                                **engine, **kw)
    torch.cuda.synchronize()
    pa.launches = 0
    t0 = time.perf_counter()
    fuids = [fr.submit(p, FLEET_CHAOS_NEW) for p in prompts[:FLEET_CHAOS]]
    fr.step()
    fr.step()
    drive = fr.drain_threaded if threaded else fr.run
    if chaos_kw is None:
        drive()
    else:
        with ReplicaChaos(replica="r1", **chaos_kw) as chaos:
            drive()
        check(chaos.fired, f"fleet chaos: {chaos_kw} fired")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(pa.launches == fleet_k4(fr), f"fleet chaos: K4 launches {pa.launches} == layers x decode steps")
    acc = fr.failover_accounting()
    check(acc["failovers_lost"] == 0, f"fleet chaos ({chaos_kw}): zero requests lost ({acc})")
    check(acc["bytes_moved"] == acc["bytes_predicted"], f"fleet chaos: failover bytes moved == predicted ({acc})")
    return fr, fleet_outputs(fr, fuids), {"wall_s": wall, "kernel_launches": pa.launches, "failover_accounting": acc,
                                          "health": {k: v["health"] for k, v in fr.health().items()}}


def phase_fleet_chaos(torch, model, prompts, control_out) -> dict:
    """Failover with ``FLEET_CHAOS`` requests in flight: a crash at
    ``mid_decode`` on r1 of three paged replicas drained by one thread a
    replica (failover by recompute: greedy tokens equal the control's up
    to a near tie, logprobs within SERVE_LP_LIMIT, K4's count exact under
    the threads); the same crash on two dense replicas (failover by KV:
    tokens and logprobs bit-equal to a no-fault run of the same fleet;
    the dense layout's attention is the einsum); a poison there
    (quarantined, recompute only, no rows shipped); and a sampled stream
    (temperature 0.8, top-k 50) failing over by KV with its generator's
    state, bit-equal to its no-fault run. Zero requests lost in each; the
    flight recorder's dump ends with the injected fault."""
    crash = {"label": "mid_decode", "action": "crash"}
    legs = {}
    fr, out, leg = chaos_leg(torch, model, prompts, FLEET_ENGINE, crash, threaded=True)
    check(leg["failover_accounting"]["failovers_recompute"] >= 1 and leg["health"]["r1"] == "dead",
          f"fleet chaos: paged failover by recompute ({leg})")
    dump = next(r for r in fr.replicas if r.name == "r1").flightrec.last_dump
    last = dump["events"][-1]
    check(last["name"] == "replica_state" and "SimulatedCrash" in str(last.get("reason")),
          f"fleet chaos: the flight dump's last event is the injected crash ({last})")
    leg["against_control"] = fleet_against(torch, model, prompts[:FLEET_CHAOS], out, control_out, "chaos recompute",
                                           new=FLEET_CHAOS_NEW)
    leg["flight_dump"] = {"reason": dump["reason"], "events": len(dump["events"]), "inflight": len(dump["inflight"]),
                          "last_event": {k: last[k] for k in ("name", "state", "reason") if k in last}}
    legs["paged_recompute"] = leg
    del fr
    free_memory(torch)
    for name, sampled in (("dense_kv", False), ("sampled_kv", True)):
        fr, want, ctl = chaos_leg(torch, model, prompts, FLEET_DENSE, None, sampled=sampled, failover="handoff")
        del fr
        fr, got, leg = chaos_leg(torch, model, prompts, FLEET_DENSE, crash, sampled=sampled, failover="handoff")
        acc = leg["failover_accounting"]
        check(acc["failovers_kv"] >= 1 and acc["bytes_moved"] > 0, f"fleet chaos ({name}): failover by KV ({acc})")
        leg["against_no_fault"] = fleet_against(torch, model, prompts[:FLEET_CHAOS], got, want, name, exact=True,
                                                new=FLEET_CHAOS_NEW)
        leg["no_fault_wall_s"] = ctl["wall_s"]
        legs[name] = leg
        del fr
        free_memory(torch)
    fr, out, leg = chaos_leg(torch, model, prompts, FLEET_DENSE, {"label": "mid_decode", "action": "poison"})
    acc = leg["failover_accounting"]
    check(leg["health"]["r1"] == "quarantined" and acc["failovers_kv"] == 0 and acc["bytes_moved"] == 0
          and acc["failovers_recompute"] >= 1, f"fleet chaos (poison): quarantined, recompute only ({leg})")
    leg["against_control"] = fleet_against(torch, model, prompts[:FLEET_CHAOS], out, control_out, "chaos poison",
                                           new=FLEET_CHAOS_NEW)
    legs["dense_poison"] = leg
    del fr
    free_memory(torch)
    row = {"phase": "fleet_chaos", "config": f"TinyLlama-1.1B shape, {FLEET_LAYERS} layers, bf16; a fault on r1 at mid_decode "
           f"with {FLEET_CHAOS} requests in flight", **legs,
           "kernel_launches": legs["paged_recompute"]["kernel_launches"]}
    emit(row)
    return row


def phase_fleet_telemetry(torch, model, prompts) -> dict:
    """A traced disaggregated fleet (prefill, decode, decode; dense, handoff
    always, failover by KV) writing one event log, with a crash at
    ``mid_decode`` on r1: ``summarize_file`` of the log gives the serving
    counters of the fleet's merged ``ServingMetrics.snapshot()``; every
    request has a trace whose segment sum equals its end-to-end latency
    within 1 ms; ``CritPathMonitor`` latches no ``trace_drift`` on
    ``kv_handoff`` or ``failover``; the engines' own ``kv_handoff`` and
    ``failover_in`` events give the router's handoff and failover counts and
    bytes, and summarize's resumes and traces match the requests; then
    ``spin_up`` adds a replica with 0 compiles."""
    from accelerate_tpu_torch.serving_fleet import FleetConfig, FleetRouter
    from accelerate_tpu_torch.telemetry import EventLog, decompose, summarize_file
    from accelerate_tpu_torch.test_utils.fault_injection import ReplicaChaos

    work = ckpt_workdir()
    try:
        path = str(work / "fleet.jsonl")
        log = EventLog(path, rank=0)
        fr = FleetRouter.from_model(model, num_replicas=3, config=FleetConfig(
            roles=("prefill", "decode", "decode"), handoff="always", failover="handoff", prefix_reuse=False),
            trace=True, telemetry_log=log, **FLEET_DENSE)
        fuids = [fr.submit(p, FLEET_CHAOS_NEW) for p in prompts[:FLEET_CHAOS]]
        fr.step()
        fr.step()
        with ReplicaChaos("mid_decode", replica="r1") as chaos:
            fr.run()
        check(chaos.fired, "fleet telemetry: the crash fired")
        fleet_outputs(fr, fuids)
        acc = fr.failover_accounting()
        check(acc["failovers_kv"] >= 1 and acc["failovers_lost"] == 0, f"fleet telemetry: KV failover ({acc})")
        merged = fr.metrics_merged()
        merged.log = log
        merged.emit()
        snap = merged.snapshot()
        log.close()
        report = summarize_file(path)
        counts = ("requests_submitted", "requests_completed", "requests_cancelled", "tokens_generated", "prefills",
                  "resumes", "failovers_in", "failovers_out", "failovers_lost", "replica_errors", "replica_state")
        serving = report["serving"]
        check(all(serving[k] == snap[k] for k in counts),
              f"fleet telemetry: summarize's serving counters equal the snapshot's "
              f"({ {k: (serving.get(k), snap[k]) for k in counts} })")
        # what the engines' own events say, against what the router counted
        events = [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
        hacc = fr.handoff_accounting()
        bpt, fixed = fr.replicas[0].engine.kv_handoff_dims()
        handed = [e for e in events if e.get("kind") == "event" and e.get("name") == "kv_handoff"]
        check(len(handed) == hacc["handoffs"]
              and sum(bpt * e["tokens"] + fixed for e in handed) == sum(e["moved_bytes"] for e in handed)
              == hacc["bytes_moved"], f"fleet telemetry: the kv_handoff events give the router's handoffs ({hacc})")
        arrived = [e for e in events if e.get("kind") == "event" and e.get("name") == "failover_in"]
        shipped = [e for e in arrived if e.get("kv_rows")]
        check(len(arrived) == acc["failovers"] - acc["failovers_lost"] and len(shipped) == acc["failovers_kv"]
              and sum(bpt * e["kv_rows"] + fixed for e in shipped) == acc["bytes_moved"],
              f"fleet telemetry: the failover_in events give the router's failovers ({acc})")
        sched = report["scheduler"]
        check(sched["resumed"] == len(arrived) + sched["preempted"],
              f"fleet telemetry: each failed-over or preempted request resumed once ({sched}, {len(arrived)} in)")
        check(report["traces"]["count"] == report["traces"]["completed"] == len(fuids),
              f"fleet telemetry: summarize rebuilds one finished trace a request ({report['traces']['count']})")
        traces = [t for t in fr.tracer.completed() if "fuid" in t["meta"]]
        check(len(traces) == len(fuids) and all(t["status"] == "ok" for t in traces),
              f"fleet telemetry: one finished trace a request ({len(traces)} of {len(fuids)})")
        gaps = [abs(t["dur_ms"] - sum(s["dur_ms"] for s in t["spans"])) for t in traces]
        check(max(gaps) <= 1.0, f"fleet telemetry: segment sums within 1 ms of end to end ({max(gaps)})")
        drift = fr.critpath.drift_events
        check(not {"kv_handoff", "failover"} & set(drift), f"fleet telemetry: no byte drift ({drift})")
        spin = fr.spin_up(warm_prompt_lens=(64,), max_new_tokens=8)
        check(spin["nvcc_builds"] == 0, f"fleet telemetry: spin_up builds no kernel library ({spin})")
        by_class = decompose(traces)["by_class"]
        row = {"phase": "fleet_telemetry", "config": f"TinyLlama-1.1B shape, {FLEET_LAYERS} layers, bf16; dense replicas "
               "prefill, decode, decode; a crash on r1 at mid_decode", "requests": len(fuids),
               "events": report["events"], "serving_counters": {k: serving[k] for k in counts},
               "traces": len(traces), "max_segment_sum_gap_ms": max(gaps),
               "segments_ms_p50": {k: v["p50_ms"] for k, v in by_class.items()},
               "segments_share": {k: v["share"] for k, v in by_class.items()},
               "drift": sorted(drift), "flight_dumps": report.get("traces", {}).get("flight_dumps"),
               "failover_accounting": acc, "handoff_accounting": hacc,
               "spinup_ms": spin["spinup_ms"], "spinup_nvcc_builds": spin["nvcc_builds"],
               "spinup_program_compiles": spin["compiles"]}
        del fr
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_memory(torch)
    emit(row)
    return row


def phase_fleet(torch) -> dict:
    """The fleet group on TinyLlama-1.1B's published widths at
    FLEET_LAYERS of its 22 layers (seeded random weights, bf16):
    fleet_serve, fleet_disagg, fleet_chaos, fleet_telemetry."""
    from accelerate_tpu_torch import LlamaConfig, create_llama_model

    model = create_llama_model(LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": FLEET_LAYERS}), seed=0,
                               dtype=torch.bfloat16)
    prompts = fleet_prompts(model.config.vocab_size)
    serve = phase_fleet_serve(torch, model, prompts)
    disagg = phase_fleet_disagg(torch, model, prompts, serve["control"])
    chaos = phase_fleet_chaos(torch, model, prompts, serve["control"])
    phase_fleet_telemetry(torch, model, prompts)
    del model
    free_memory(torch)
    return {"k4_launches": serve["row"]["kernel_launches"] + disagg["kernel_launches"] + chaos["kernel_launches"]}


# --------------------------------------------------------------------- #
# the multi-process fleet (--only proc)
# --------------------------------------------------------------------- #

# each worker's warm prompts: the 64- and 256-token buckets and a chunked
# prefill past the largest bucket, then a full decode tick
PROC_WARM = (64, 300, 1100)
# with shadow_kv a status reply ships every decoding slot's rows: at all 22
# layers and 8 slots 8 x 1,536 rows x 22,528 B = 276.8 MB passes the
# transport's 268.4 MB frame cap; 4 slots (138.4 MB) fit it
PROC_DENSE = dict(FLEET_DENSE, num_slots=4)
PROC_SAMPLED = dict(temperature=0.8, top_k=50)
# the sampled failover leg serves in f32: in bf16 the rows a survivor recomputes are not the decoded ones bit for
# bit, and a random-weight model's flat sampled choices part from the no-fault run's far from a tie of the
# sampler's race (scripts/torch_sampled_resume.py: 13 of 36 resumed streams parted in bf16, none in f32); its
# logprobs against the no-fault run's within this (the recomputed rows' rounding)
PROC_SAMPLED_LP_TOL = 1e-3
PROC_HTTP_NEW = 16
# the workers' model: TinyLlama's widths at PROC_LAYERS of its 22 layers (cut to keep the whole script inside its
# 1,200 s)
PROC_LAYERS = 4
PROC_LLAMA = {**TINYLLAMA, "num_hidden_layers": PROC_LAYERS}


def proc_tinyllama(device=None, seed=0, dtype="bfloat16"):
    """The worker processes' model (``model_spec="chip_smoke:proc_tinyllama"``):
    TinyLlama-1.1B's widths at PROC_LAYERS layers in ``dtype`` (a torch
    dtype's name), seeded random weights drawn on the card: the draws of
    this script's own ``create_llama_model(LlamaConfig(**PROC_LLAMA),
    seed=0, dtype=...)``."""
    import torch

    from accelerate_tpu_torch import LlamaConfig, create_llama_model

    return create_llama_model(LlamaConfig(**PROC_LLAMA), seed=seed, device=device, dtype=getattr(torch, dtype))


def proc_config(run_dir, engine=FLEET_ENGINE, workers=2, **kw):
    from accelerate_tpu_torch.serving_proc import ProcConfig

    return ProcConfig(workers=workers, model_spec="chip_smoke:proc_tinyllama", engine=dict(engine),
                      run_dir=str(run_dir), warm_prompt_lens=PROC_WARM, warm_max_new_tokens=9, **kw)


def proc_logs(run_dir) -> str:
    """The last lines of every worker's log: what a failed check shows."""
    out = []
    for path in sorted(Path(run_dir).glob("worker_*.log")):
        out.append(f"--- {path.name}\n" + "\n".join(path.read_text(errors="replace").splitlines()[-15:]))
    return "\n".join(out)


def proc_spawn(stack, cfg):
    """A ProcessSupervisor whose workers are spawned and left to boot
    (``start(wait=False)``; a worker reaches the card in seconds, so
    fleets boot while earlier ones serve), shut down when ``stack``
    closes whatever happens."""
    from accelerate_tpu_torch.serving_proc import ProcessSupervisor

    sup = ProcessSupervisor(cfg)
    stack.callback(sup.shutdown)
    sup.spawned_at = time.perf_counter()
    sup.start(wait=False)
    return sup


def proc_ready(sup):
    """Pump until every worker said hello (else the phase fails);
    ``sup.boot_s`` is the time from spawn."""
    proc_wait(sup, lambda: all(h["health"] != "spawning" for h in sup.health().values()), "every worker's hello",
              sup.config.spawn_timeout_s)
    sup.boot_s = time.perf_counter() - sup.spawned_at
    check(all(h["health"] == "healthy" for h in sup.health().values()),
          f"proc: every worker said hello ({sup.health()})\n{proc_logs(sup.run_dir)}")
    return sup


def proc_wait(sup, cond, what, timeout_s=300.0, on_pump=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.pump()
        if on_pump is not None:
            on_pump()
        if cond():
            return
        time.sleep(0.002)
    check(False, f"proc: {what} within {timeout_s} s\n{proc_logs(sup.run_dir)}")


def proc_drive(sup, fids, on_pump=None, timeout_s=300.0):
    """Pump until every request is done or lost; ``(outs, lost)``:
    ``{fid: (tokens, logprobs)}`` and ``{fid: reason}``."""
    from accelerate_tpu_torch.serving_proc import FleetRequestError

    outs, lost = {}, {}

    def finished():
        for f in fids:
            if f in outs or f in lost:
                continue
            try:
                got = sup.poll(f)
            except FleetRequestError as e:
                lost[f] = str(e)
                continue
            if got is not None:
                outs[f] = (got, sup.logprobs(f))
        return len(outs) + len(lost) == len(fids)

    proc_wait(sup, finished, "every request done or lost", timeout_s, on_pump)
    return outs, lost


def proc_settle(sup) -> None:
    """Pump until every live worker's last status came after its last
    tick (not busy), so the launch counts read are final."""
    proc_wait(sup, lambda: all(s.get("busy") is False for s in sup.worker_stats().values()
                               if s["health"] in ("healthy", "degraded")), "the workers' last status", 60)


def proc_k4(sup, layers, what, names=("w0", "w1")) -> tuple:
    """The K4 launches of the workers ``names`` (the ones up at
    ``reset_counts``; their last polled counts since) against ``layers`` x
    each one's decode steps (``layers`` 0: a dense engine launches none);
    ``(sum, rows)``."""
    rows = {}
    for name, st in sup.worker_stats().items():
        if name not in names or st.get("launches") is None:
            continue
        k4, steps = st["launches"].get("paged_decode_attention", 0), st.get("decode_steps", 0)
        check(k4 == layers * steps, f"{what}: {name}'s K4 launches {k4} == {layers} x its decode steps {steps}")
        rows[name] = {"kernel_launches": k4, "decode_steps": steps}
    return sum(r["kernel_launches"] for r in rows.values()), rows


def proc_worker_rows(sup) -> dict:
    """Per worker: boot (spawn to hello, the model's build, the warm pass,
    ``nvcc`` builds) and the served window's host timers (ticks, status
    replies and the largest snapshot bundle) and engine metrics."""
    out = {}
    for name, st in sup.worker_stats().items():
        hello = st.get("hello") or {}
        timing = st.get("timing") or {}
        m = st.get("metrics") or {}
        out[name] = {
            "health": st["health"], "spinup_s": st.get("spinup_s"), "device_init_s": hello.get("device_init_s"),
            "model_s": hello.get("model_s"),
            "warm_s": hello.get("warm_s"), "nvcc_builds": hello.get("nvcc_builds"),
            "program_compiles": hello.get("compiles"), "programs_deserialized": hello.get("deserialized"),
            "ticks": timing.get("ticks"), "tick_ms_mean": timing["tick_ms"] / timing["ticks"]
            if timing.get("ticks") else None,
            "polls": timing.get("polls"), "status_ms_mean": timing["status_ms"] / timing["polls"]
            if timing.get("polls") else None, "status_blob_bytes_max": timing.get("blob_bytes_max"),
            "itl_ms_p50": m.get("itl_ms_p50"), "ttft_ms_p50": m.get("ttft_ms_p50"),
        }
    return out


def free_card_gb(torch) -> float:
    return torch.cuda.mem_get_info()[0] / 1e9


def proc_tick_idle(sup, vocab) -> dict:
    """Each worker's tick with 8 slots decoding (16 requests of 200 tokens
    over the 2 workers): a tick timed on the host, the next traced by
    ``torch.profiler`` in the worker (``request_tick_profile``) for the
    device's busy time."""
    rng = np.random.default_rng(5)
    fids = [sup.submit(rng.integers(1, vocab, size=200).astype(np.int32), FLEET_NEW) for _ in range(16)]
    proc_wait(sup, lambda: all(len(sup.partial(f)) >= 1 for f in fids), "16 requests decoding", 120)
    sup.request_tick_profile()

    def profiled():
        profs = [s.get("tick_profile") for s in sup.worker_stats().values() if s["health"] == "healthy"]
        return len(profs) == 2 and all(p is not None for p in profs)

    proc_wait(sup, profiled, "both workers' tick profiles", 120)
    out = {name: s["tick_profile"] for name, s in sup.worker_stats().items()}
    check(all(p["idle_share"] is not None for p in out.values()), f"proc tick: traced in every worker ({out})")
    return out


def phase_proc_serve(torch, model, prompts, control_out, work, then=None) -> dict:
    """The 48 requests served by ``ProcessSupervisor`` over 2 paged worker
    processes (FLEET_ENGINE): greedy tokens equal the one-engine control's
    up to a near tie (fleet_against); each worker's K4 launches equal
    layers x its decode steps; the workers built no kernel. Tokens/s,
    each worker's spin-up, model and warm seconds and host timers, and each
    worker's tick idle share. ``then()`` runs once the measurements are
    taken (the next phase's fleets start booting) and its result rides back
    as ``chaos_fleets``."""
    layers = model.config.num_hidden_layers
    with contextlib.ExitStack() as stack:
        sup = proc_ready(proc_spawn(stack, proc_config(work / "serve")))
        boot_s = sup.boot_s
        check(all(s["hello"]["nvcc_builds"] == 0 for s in sup.worker_stats().values()),
              f"proc serve: the workers built no kernel ({sup.worker_stats()})")
        sup.reset_counts()
        t0 = time.perf_counter()
        fids = [sup.submit(p, FLEET_NEW) for p in prompts]
        outs, lost = proc_drive(sup, fids)
        wall = time.perf_counter() - t0
        check(not lost, f"proc serve: nothing lost ({lost})")
        proc_settle(sup)
        k4, per_worker = proc_k4(sup, layers, "proc serve")
        check(len(per_worker) == 2 and all(r["decode_steps"] > 0 for r in per_worker.values()),
              f"proc serve: both workers decoded ({per_worker})")
        workers = proc_worker_rows(sup)
        tick = proc_tick_idle(sup, model.config.vocab_size)
    nxt = then() if then is not None else None
    against = fleet_against(torch, model, prompts, [outs[f] for f in fids], control_out, "proc serve")
    row = {"phase": "proc_serve", "config": f"TinyLlama-1.1B shape, {PROC_LAYERS} layers, bf16, seeded random "
           "weights; ProcessSupervisor over 2 paged worker processes (block 16) of 8 slots on one card",
           "requests": len(prompts), "max_new_tokens": FLEET_NEW, "boot_s": boot_s, "wall_s": wall,
           "tokens_per_s": len(prompts) * FLEET_NEW / wall, "kernel_launches": k4, "per_worker": per_worker,
           "workers": workers, "against_control": against, "tick": tick}
    emit(row)
    return {"row": row, "outputs": {i: outs[f] for i, f in enumerate(fids)}, "chaos_fleets": nxt}


def proc_chaos_leg(torch, model, prompts, sup, paged=True, after=None, kill_when=None, keep=False) -> tuple:
    """``sup``'s 2 workers (booted, or booting) serve FLEET_CHAOS requests
    of FLEET_CHAOS_NEW new tokens with the fault its config installs in w1,
    or with w1 SIGKILLed from here once ``kill_when(sup)`` holds; zero
    lost; each paged worker's K4 launches == layers x its decode steps
    (the dead worker's as last polled), a dense one's 0. Free card memory
    with both workers up and after the fault's process is gone.
    ``after(sup, fids)`` runs on the live fleet and adds to the leg's row;
    the fleet is shut down at the end unless ``keep``. ``(row, outputs)``."""
    layers = model.config.num_hidden_layers if paged else 0
    proc_ready(sup)
    mem = {"both_up_gb": free_card_gb(torch)}

    def watch():
        slot = sup._slots[1]
        if kill_when is not None and "killed_at_gb" not in mem and kill_when(sup):
            mem["killed_at_gb"] = free_card_gb(torch)
            slot["proc"].send_signal(signal.SIGKILL)
        st = sup.worker_stats().get("w1", {})
        if "after_fault_gb" not in mem and st.get("health") in ("dead", "quarantined") and (
                slot["proc"] is None or slot["proc"].poll() is not None):
            mem["after_fault_gb"] = free_card_gb(torch)

    sup.reset_counts()
    t0 = time.perf_counter()
    fids = [sup.submit(p, FLEET_CHAOS_NEW) for p in prompts[:FLEET_CHAOS]]
    outs, lost = proc_drive(sup, fids, on_pump=watch)
    wall = time.perf_counter() - t0
    name = Path(sup.run_dir).name
    check(not lost, f"proc chaos ({name}): zero requests lost ({lost})")
    proc_settle(sup)
    k4, per_worker = proc_k4(sup, layers, f"proc chaos ({name})")
    acct = sup.failover_accounting()
    check(acct["failovers_lost"] == 0 and acct["bytes_moved"] == acct["bytes_predicted"],
          f"proc chaos ({name}): bytes moved == predicted ({acct})")
    leg = {"wall_s": wall, "boot_s": sup.boot_s, "kernel_launches": k4, "per_worker": per_worker,
           "failover_accounting": acct, "health": {n: s["health"] for n, s in sup.worker_stats().items()},
           "workers": proc_worker_rows(sup), "free_card_gb": mem,
           "gen_states": [sup._reqs[f]["gen_state"] for f in fids]}
    if after is not None:
        leg.update(after(sup, fids))
    # the supervisor's log: w1's health, the failovers and their time
    sup._log.flush()
    events = [json.loads(line) for line in (Path(sup.run_dir) / "events_supervisor.jsonl").read_text().splitlines()
              if line.strip()]
    leg["w1_states"] = [e["state"] for e in events if e.get("name") == "proc_health" and e.get("worker") == "w1"]
    fault = next((e["ts"] for e in events if e.get("worker") == "w1" and (
        e.get("name") == "proc_exit" or (e.get("name") == "proc_health" and e.get("state") == "quarantined"))), None)
    moved = [e for e in events if e.get("name") == "proc_failover"]
    leg["kv_fuids"] = sorted(e["fuid"] for e in moved if e.get("kv"))
    leg["moved"] = {e["fuid"]: {"snapshot": e.get("snapshot"), "generated": e.get("generated")} for e in moved}
    leg["failover_ms"] = (max(e["ts"] for e in moved) - fault) * 1e3 if fault is not None and moved else None
    if not keep:
        sup.shutdown()
    return leg, [outs[f] for f in fids]


def proc_mirror(torch, model, prompts, engine, workers, seed=0) -> tuple:
    """The no-fault run of a 2-worker fleet, in this process: ``workers``
    engines (1 where the streams do not depend on routing: greedy on the
    dense layout, whose every request computes alike in any batch), each
    serving the requests the supervisor routes to its worker (fuid f to
    worker f mod ``workers``, a burst split alternately) after as many
    requests as the worker's warm pass (each request's sampling stream is
    seeded by its engine's own request id). ``(outputs by fuid, each
    request's initial generator state)``."""
    from accelerate_tpu_torch import ServingEngine

    outs, states = {}, {}
    for w in range(workers):
        eng = ServingEngine(model, seed=seed, **engine)
        eng._uid = len(PROC_WARM)  # the worker's warm requests took the first ids
        fuids = list(range(w, FLEET_CHAOS, workers))
        uids = {f: eng.submit(prompts[f], FLEET_CHAOS_NEW) for f in fuids}
        states.update({f: [int(v) for v in eng._gen_state(eng._request_generator(u))] for f, u in uids.items()})
        eng.run()
        outs.update({f: (eng.poll(u), eng.logprobs(u)) for f, u in uids.items()})
        del eng
    free_memory(torch)
    return [outs[f] for f in range(FLEET_CHAOS)], [states[f] for f in range(FLEET_CHAOS)]


def proc_chaos_spawn(stack, work) -> dict:
    """The chaos phase's fleets, one a leg, all spawned at once: they boot
    together (a worker takes ~25 s to reach hello on the card, most of it
    the interpreter's imports, and holds ~3 GB of the card)."""
    kill = {"worker": "w1", "label": "mid_decode", "action": "sigkill", "hits": 2}
    stop = {"worker": "w1", "label": "mid_decode", "action": "sigstop", "hits": 2}
    sampled = dict(FLEET_ENGINE, **PROC_SAMPLED)
    plan = {"sigkill": {"chaos": kill},
            "sampled_sigkill": {"engine": sampled, "seed": 3, "chaos": kill, "model_kwargs": {"dtype": "float32"}},
            "sigstop": {"chaos": stop, "max_respawns": 1, "heartbeat_timeout_s": 2.0, "quarantine_after_timeouts": 2},
            "dense_kv": {"engine": PROC_DENSE, "shadow_kv": True}}
    return {name: proc_spawn(stack, proc_config(work / name, **{"max_respawns": 0, **kw})) for name, kw in plan.items()}


def phase_proc_chaos(torch, model, prompts, control_out, sups) -> dict:
    """Process faults with FLEET_CHAOS requests in flight on 2 workers, one
    fleet a leg (proc_chaos_spawn): ``sigkill`` at
    ``mid_decode`` in w1 (failover by recompute from the last polled
    snapshot: greedy tokens equal the control's up to a near tie; sampled
    streams, served in f32, equal the no-fault run's (proc_mirror), logprobs
    within PROC_SAMPLED_LP_TOL), then the survivor killed with 8 requests
    decoding (the sole worker: lost with a reason, none stranded, a new
    submit shed); ``sigstop`` in w1 (degraded, then quarantined and
    SIGKILLed, respawned with 0 ``nvcc`` builds); and a dense pair with
    ``shadow_kv`` (PROC_DENSE), w1 SIGKILLed once its polled snapshots
    carry rows: KV failover with moved bytes == predicted, the KV-failed
    streams bit-equal to the no-fault run (proc_mirror). Free card memory
    beside each kill. The no-fault runs go first, while the fleets boot."""
    from accelerate_tpu_torch.serving_proc import FleetRequestError

    from accelerate_tpu_torch import LlamaConfig, create_llama_model

    model32 = create_llama_model(LlamaConfig(**PROC_LLAMA), seed=0, dtype=torch.float32)
    sampled_clean = proc_mirror(torch, model32, prompts, dict(FLEET_ENGINE, **PROC_SAMPLED), 2, seed=3)
    del model32
    dense_clean, _ = proc_mirror(torch, model, prompts, PROC_DENSE, 1)

    sub = prompts[:FLEET_CHAOS]
    legs, runs = {}, {}

    def sole_death(sup, fids):
        """After the leg: w0, the last worker, killed with 8 requests decoding."""
        late = [sup.submit(p, FLEET_CHAOS_NEW) for p in prompts[FLEET_CHAOS:FLEET_CHAOS + 8]]
        proc_wait(sup, lambda: all(len(sup.partial(f)) >= 1 for f in late), "8 requests decoding on w0", 120)
        before = free_card_gb(torch)
        sup._slots[0]["proc"].send_signal(signal.SIGKILL)
        outs, lost = proc_drive(sup, late, timeout_s=60)
        stranded = [f for f in late if sup.request_state(f) == "routed"]
        check(len(lost) == len(late) and not outs and not stranded
              and all("no routable survivor after crash" in r for r in lost.values()),
              f"proc chaos: the sole worker's requests lost with a reason ({lost}, stranded {stranded})")
        shed = sup.submit(prompts[0], 4)
        proc_wait(sup, lambda: sup.request_state(shed) == "shed", "a submit with no worker shed", 30)
        try:
            sup.poll(shed)
            check(False, "proc chaos: a submit with no worker raises")
        except FleetRequestError:
            pass
        proc_wait(sup, lambda: sup._slots[0]["proc"].poll() is not None, "w0 reaped", 30)
        return {"sole_death": {"lost": len(lost), "reason": sorted(set(lost.values()))[0],
                               "free_card_gb": {"before": before, "after": free_card_gb(torch)}}}

    def respawned(sup):
        """The sigstop leg's slot, respawned while the later legs ran."""
        proc_wait(sup, lambda: sup.worker_stats().get("w1.1", {}).get("health") == "healthy", "w1 respawned", 180)
        st = sup.worker_stats()["w1.1"]
        check(st["hello"]["nvcc_builds"] == 0, f"proc chaos (sigstop): the respawn built no kernel ({st['hello']})")
        check(st["hello"]["compiles"] == 0, f"proc chaos (sigstop): the respawn compiled no program ({st['hello']})")
        sup.shutdown()
        return {"respawn": {"spinup_s": st["spinup_s"], "nvcc_builds": st["hello"]["nvcc_builds"],
                            "programs_deserialized": st["hello"]["deserialized"],
                            "model_s": st["hello"]["model_s"], "warm_s": st["hello"]["warm_s"]}}

    def rows_polled(sup):
        shadow = sup._slots[1]["shadow"]
        return shadow is not None and sum(m["has_kv"] and m["generated"] >= 2 for m in shadow[0]) >= 2

    leg_kw = {"sigkill": {"after": sole_death}, "sigstop": {"keep": True},
              "dense_kv": {"paged": False, "kill_when": rows_polled}}
    for name, sup in sups.items():
        runs[name] = proc_chaos_leg(torch, model, prompts, sup, **leg_kw.get(name, {}))
    runs["sigstop"][0].update(respawned(sups["sigstop"]))

    leg, out = runs["sigkill"]
    acct = leg["failover_accounting"]
    check(acct["failovers"] >= 1 and acct["failovers_recompute"] == acct["failovers"] and leg["health"]["w1"] == "dead",
          f"proc chaos (sigkill): w1 dead, failover by recompute ({leg})")
    leg["against_control"] = fleet_against(torch, model, sub, out, control_out, "proc sigkill", new=FLEET_CHAOS_NEW)
    legs["sigkill"] = leg

    (clean_out, clean_states), (leg, out) = sampled_clean, runs["sampled_sigkill"]
    check(leg["failover_accounting"]["failovers"] >= 1, f"proc chaos (sampled): failover ({leg})")
    check(leg["gen_states"] == clean_states, "proc chaos (sampled): the workers seeded each stream as the "
          "no-fault engines did")
    lp_diff = 0.0
    for f, ((g, g_lp), (w, w_lp)) in enumerate(zip(out, clean_out)):
        check(np.array_equal(g, w), f"proc chaos (sampled, f32): request {f}'s stream equals the no-fault run's "
              f"(failed over: {leg['moved'].get(f)})")
        lp_diff = max(lp_diff, float(np.max(np.abs(np.asarray(g_lp) - np.asarray(w_lp)))))
    check(lp_diff <= PROC_SAMPLED_LP_TOL, f"proc chaos (sampled, f32): logprobs within {PROC_SAMPLED_LP_TOL} ({lp_diff})")
    leg["against_no_fault"] = {"tokens_compared": FLEET_CHAOS * FLEET_CHAOS_NEW, "max_logprob_diff": lp_diff}
    legs["sampled_sigkill"] = leg

    leg, out = runs["sigstop"]
    check(leg["w1_states"][-2:] == ["degraded", "quarantined"] and leg["failover_accounting"]["failovers"] >= 1,
          f"proc chaos (sigstop): degraded, then quarantined, its requests failed over ({leg['w1_states']})")
    leg["against_control"] = fleet_against(torch, model, sub, out, control_out, "proc sigstop", new=FLEET_CHAOS_NEW)
    legs["sigstop"] = leg

    clean_out, (leg, out) = dense_clean, runs["dense_kv"]
    acct = leg["failover_accounting"]
    check(acct["failovers_kv"] >= 1 and acct["bytes_moved"] == acct["bytes_predicted"] > 0,
          f"proc chaos (dense_kv): KV failover, moved bytes == predicted ({acct})")
    by_kv = leg["kv_fuids"]
    check(len(by_kv) == acct["failovers_kv"], f"proc chaos (dense_kv): the KV failovers logged ({by_kv})")
    for f in by_kv:
        check(np.array_equal(out[f][0], clean_out[f][0]) and np.array_equal(out[f][1], clean_out[f][1]),
              f"proc chaos (dense_kv): request {f}, failed over by KV, bit-equal to no fault")
    leg["kv_failed_bit_equal"] = len(by_kv)
    leg["bit_equal_all"] = sum(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                               for a, b in zip(out, clean_out))
    leg["against_no_fault"] = fleet_against(torch, model, sub, out, clean_out, "proc dense_kv", new=FLEET_CHAOS_NEW)
    legs["dense_kv"] = leg
    for leg in legs.values():
        leg.pop("gen_states", None)
    row = {"phase": "proc_chaos", "config": f"TinyLlama-1.1B shape, {PROC_LAYERS} layers, bf16; 2 worker processes "
           f"a leg, a fault in w1 with {FLEET_CHAOS} requests in flight", **legs,
           "kernel_launches": sum(leg["kernel_launches"] for leg, _ in runs.values())}
    emit(row)
    return row


def http_json(port, method, path, body=None, headers=None, timeout=120):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body), headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def sse_events(resp, n_events, timeout_s=120.0) -> list:
    """SSE blocks of an http.client response, until ``n_events`` or the
    stream's end."""
    buf, events = b"", []
    deadline = time.monotonic() + timeout_s
    while len(events) < n_events and time.monotonic() < deadline:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            lines = block.decode().split("\n")
            events.append((lines[0].split(": ", 1)[1], json.loads(lines[1].split(": ", 1)[1])))
    return events


def proc_http_start(work) -> dict:
    """Start ``python -m accelerate_tpu_torch.commands.serve`` (2 paged
    workers, FLEET_ENGINE, no respawn) in the background: it boots while
    the chaos phase runs."""
    ready = work / "http_ready.json"
    log_path = work / "serve.log"
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "--workers", "2",
           "--model-spec", "chip_smoke:proc_tinyllama", "--engine-kwargs", json.dumps(FLEET_ENGINE),
           "--run-dir", str(work / "http"), "--http-port", "0", "--ready-file", str(ready),
           "--max-respawns", "0", "--max-runtime-s", "900"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "ready": ready, "log": log_path, "t0": t0}


def phase_proc_http(torch, model, prompts, served, server) -> dict:
    """The ``serve`` command started by proc_http_start: a JSON submit and
    an SSE stream of one prompt give the same tokens, equal to what
    proc_serve's supervisor served up to a near tie; a long stream is
    cancelled from the side; ``/metrics`` carries ``proc_worker_state``;
    ``/healthz`` answers 200, then 503 once both worker processes are
    killed; SIGTERM drains and the command exits 0. The command and its
    workers are killed on the way out whatever happens."""
    import http.client

    proc, ready, log_path, t0 = server["proc"], server["ready"], server["log"], server["t0"]
    pids = []
    try:
        deadline = time.monotonic() + 300
        while not ready.exists() and time.monotonic() < deadline:
            check(proc.poll() is None, f"proc http: serve exited early\n{log_path.read_text()[-3000:]}")
            time.sleep(0.1)
        check(ready.exists(), "proc http: serve became ready")
        ready_s = time.perf_counter() - t0
        port = json.loads(ready.read_text())["http_port"]
        status, body = http_json(port, "GET", "/healthz")
        rows = json.loads(body)["replicas"]
        pids = [r["pid"] for r in rows.values()]
        check(status == 200 and sorted(rows) == ["w0", "w1"], f"proc http: /healthz 200 with 2 workers ({rows})")

        prompt = [int(t) for t in prompts[0]]
        t1 = time.perf_counter()
        status, body = http_json(port, "POST", "/v1/generate", {"prompt": prompt, "max_new_tokens": PROC_HTTP_NEW})
        json_ms = (time.perf_counter() - t1) * 1e3
        out = json.loads(body)
        check(status == 200 and out["state"] == "done" and len(out["tokens"]) == PROC_HTTP_NEW,
              f"proc http: the JSON submit done ({status}, {out.get('state')})")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": prompt, "max_new_tokens": PROC_HTTP_NEW}),
                     headers={"Accept": "text/event-stream"})
        r = conn.getresponse()
        events = sse_events(r, PROC_HTTP_NEW + 1)
        conn.close()
        check([k for k, _ in events] == ["token"] * PROC_HTTP_NEW + ["done"]
              and [d["token"] for _, d in events[:PROC_HTTP_NEW]] == out["tokens"],
              f"proc http: the SSE stream gives the JSON submit's tokens ({events[-1]})")
        against = fleet_against(torch, model, [prompts[0]], [(np.asarray(out["final"]), np.asarray(out["lps"]))],
                                [served[0]], "proc http", new=PROC_HTTP_NEW)

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": prompt[:64], "max_new_tokens": 512,
                                                              "stream": True}))
        r = conn.getresponse()
        rid = int(r.getheader("X-Request-Id"))
        status, body = http_json(port, "DELETE", f"/v1/generate/{rid}")
        check(status == 200 and json.loads(body)["cancelled"], f"proc http: DELETE cancels ({status})")
        tail = sse_events(r, 600)
        conn.close()
        check(tail and tail[-1][0] == "done" and tail[-1][1]["state"] == "cancelled"
              and len(tail[-1][1]["tokens"]) < 512, f"proc http: the stream ends cancelled ({tail[-1:]})")

        status, metrics = http_json(port, "GET", "/metrics")
        check(status == 200 and b'proc_worker_state{worker="w0"} 0' in metrics, "proc http: /metrics per worker")
        for pid in pids:
            os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while http_json(port, "GET", "/healthz")[0] != 503 and time.monotonic() < deadline:
            time.sleep(0.05)
        status, body = http_json(port, "GET", "/healthz")
        check(status == 503 and not json.loads(body)["serving"], f"proc http: /healthz 503 with no worker ({body})")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"proc http: SIGTERM drains and exits 0 (rc {rc})\n{log_path.read_text()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
    row = {"phase": "proc_http", "config": "python -m accelerate_tpu_torch.commands.serve --workers 2 "
           f"(TinyLlama-1.1B shape, {PROC_LAYERS} layers, bf16; FLEET_ENGINE)", "ready_s": ready_s,
           "json_request_ms": json_ms, "new_tokens": PROC_HTTP_NEW, "against_served": against,
           "cancelled_after_tokens": len(tail[-1][1]["tokens"]), "sigterm_rc": rc}
    emit(row)
    return row


def proc_control(torch, model, prompts, threaded) -> dict:
    """The 48 requests on one in-process engine driven by ``step()`` (the
    control whose tokens the process fleet is held to), and with
    ``threaded`` on 2 in-process replicas drained by one thread each
    (``drain_threaded``, prefix reuse off): tokens/s of each."""
    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.serving_fleet import FleetConfig, FleetRouter

    ServingEngine(model, **FLEET_ENGINE).generate_many([prompts[0][:300]], max_new_tokens=9)  # warm-up
    eng = ServingEngine(model, **FLEET_ENGINE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uids = [eng.submit(p, FLEET_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {"tokens_per_s": len(prompts) * FLEET_NEW / wall, "wall_s": wall}
    outputs = [(eng.poll(u), eng.logprobs(u)) for u in uids]
    del eng
    if threaded:
        fr = FleetRouter.from_model(model, num_replicas=2, config=FleetConfig(prefix_reuse=False), **FLEET_ENGINE)
        fuids = [fr.submit(p, FLEET_NEW) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.drain_threaded()
        torch.cuda.synchronize()
        row["threaded_tokens_per_s"] = len(fuids) * FLEET_NEW / (time.perf_counter() - t0)
        del fr
    free_memory(torch)
    return {"row": row, "outputs": outputs}


def phase_proc(torch, threaded=False) -> dict:
    """The multi-process fleet group on TinyLlama-1.1B's published widths
    at PROC_LAYERS layers (seeded random weights, bf16): proc_serve, proc_chaos,
    proc_http, held to the one-engine control measured first (with the
    threaded drain beside it when ``threaded``)."""
    from accelerate_tpu_torch import LlamaConfig, create_llama_model

    model = create_llama_model(LlamaConfig(**PROC_LLAMA), seed=0, dtype=torch.bfloat16)
    prompts = fleet_prompts(model.config.vocab_size)
    control = proc_control(torch, model, prompts, threaded)
    emit({"phase": "proc_control", "one_engine": control["row"]})
    work = ckpt_workdir()
    server = None
    try:
        with contextlib.ExitStack() as stack:
            serve = phase_proc_serve(torch, model, prompts, control["outputs"], work,
                                     then=lambda: proc_chaos_spawn(stack, work))
            server = proc_http_start(work)  # it boots with the chaos phase's fleets
            chaos = phase_proc_chaos(torch, model, prompts, control["outputs"], serve["chaos_fleets"])
        phase_proc_http(torch, model, prompts, [serve["outputs"][0]], server)
    finally:
        if server is not None and server["proc"].poll() is None:
            server["proc"].kill()
            server["proc"].wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    del model
    free_memory(torch)
    return {"k4_launches": serve["row"]["kernel_launches"] + chaos["kernel_launches"]}


# --------------------------------------------------------------------- #
# the encoder-decoder families (--only s2s)
# --------------------------------------------------------------------- #

# google-t5/t5-large config.json (d_model, d_ff, d_kv, num_heads, num_layers = num_decoder_layers,
# relative_attention_num_buckets / max_distance, layer_norm_epsilon; ReLU FFN, tied embeddings)
T5_LARGE = dict(vocab_size=32128, hidden_size=1024, intermediate_size=4096, num_layers=24, num_attention_heads=16,
                head_dim=64, relative_attention_num_buckets=32, relative_attention_max_distance=128,
                layer_norm_eps=1e-6, tie_word_embeddings=True)
T5_START, T5_EOS = 0, 1  # decoder_start_token_id, eos_token_id
# openai/whisper-large-v3 config.json
WHISPER_LARGE_V3 = dict(vocab_size=51866, num_mel_bins=128, d_model=1280, encoder_layers=32, decoder_layers=32,
                        encoder_attention_heads=20, decoder_attention_heads=20, encoder_ffn_dim=5120,
                        decoder_ffn_dim=5120, max_source_positions=1500, max_target_positions=448,
                        layer_norm_eps=1e-5)
WHISPER_START, WHISPER_EOS = 50258, 50257
S2S_DECODE_LEN = 128  # max_decode_len of both serves
S2S_BATCH, S2S_NEW = 8, 64
T5_SRC = 512  # sources of 64-512 tokens, right-padded to 512
WHISPER_FRAMES = 3000  # 30 s of log-mel frames: 1,500 encoder positions
S2S_CUT_FRAMES = 400  # s2s_consistency's Whisper inputs (200 encoder positions)
# s2s_consistency's bound on |card - CPU| over the CPU logits' RMS (logits and every cached step), f32. T5's
# attention is unscaled (scores of std ~8 at random weights), so f32 itself is coarser there: the CPU's f32 logits
# of the 2 + 2-layer cut sit ~7e-5 of the RMS from the same model's in f64 (the phase's cpu_f32_vs_f64), the
# card's 9.8e-5 from the CPU's (H100, 700 W); a bf16 model is 1.0 off. Whisper's scaled attention keeps
# gpt_consistency's bound (card 8.4e-6 of the RMS from the CPU)
S2S_CUT_TOL = {"t5": 4e-4, "whisper": 1e-4}


def kernel_counts():
    """The launch counters of K1-K5, which no encoder-decoder path moves."""
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops import qmatmul as qm

    return {"k1": fa.launches_fwd, "k2": fa.launches_dq, "k3": fa.launches_dkv, "k4": pa.launches, "k5": qm.launches}


def s2s_reference_check(torch, model, src, mask, out, step_lp, eos):
    """Greedy tokens ``out`` ``[B, 1 + n]`` of the cached loop against one
    teacher-forced forward (no cache, the encoder again) over the same
    decoder sequence, under serve's gap rule (greedy_against_reference):
    a token may differ only where the forward's top-2 gap is under
    SERVE_BF16_GAP, which ends that row's comparison, as does its EOS; the
    cached step's logprob of each compared token (``step_lp`` ``[B, n]``)
    within SERVE_LP_LIMIT of the forward's. Returns ``(tokens compared,
    rows stopped at a near tie, max logprob error)``."""
    with torch.no_grad():
        logits = model(src, out[:, :-1], attention_mask=mask)
    logp = torch.log_softmax(logits, dim=-1)
    top2 = torch.topk(logits, 2, dim=-1).values
    ref = logits.argmax(-1)
    gen = out[:, 1:].long()
    chosen_lp = logp.gather(-1, gen[..., None])[..., 0]
    ref, gen, gaps = ref.cpu().numpy(), gen.cpu().numpy(), (top2[..., 0] - top2[..., 1]).float().cpu().numpy()
    chosen_lp, step_lp = chosen_lp.float().cpu().numpy(), step_lp.float().cpu().numpy()
    compared = near = 0
    lp_err = 0.0
    for r in range(gen.shape[0]):
        for i in range(gen.shape[1]):
            if gen[r, i] != ref[r, i]:
                check(gaps[r, i] < SERVE_BF16_GAP,
                      f"row {r} token {i}: {gen[r, i]} != {ref[r, i]} with top-2 gap {gaps[r, i]}")
                near += 1
                break
            lp_err = max(lp_err, abs(float(chosen_lp[r, i] - step_lp[r, i])))
            compared += 1
            if gen[r, i] == eos:
                break
    check(lp_err <= SERVE_LP_LIMIT, f"cached logprobs within {SERVE_LP_LIMIT} of the forward's: {lp_err}")
    check(compared > 0, "tokens compared against the teacher-forced forward")
    return compared, near, lp_err


def s2s_step_profile(torch, model, src, mask, start, cross_shape):
    """One decode step (the 8 rows' 2nd token) timed without the profiler,
    the next traced (``traced``): kernels a step, the device's busy time
    and idle share, busy time by kind, and the device time of the casts of
    the f32 cross K/V to the stream dtype (each ``aten::_to_copy`` of a
    ``cross_shape`` tensor)."""
    from torch.autograd import DeviceType

    with torch.no_grad():
        logits, cache = model(src, start, attention_mask=mask, decode=True, cache=None)
        tok = logits[:, -1].argmax(-1)[:, None]
        model(src, tok, decode=True, cache=cache)  # a warm step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(src, tok, decode=True, cache=cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kept = {}
        events, traced_ms, attempts, lost = traced(
            torch, lambda: model(src, tok, decode=True, cache=cache), record_shapes=True,
            on_trace=lambda prof: kept.__setitem__("prof", prof))
    busy, by_name = device_time(events)
    by_kind = {}
    for name, (ms, _) in by_name.items():
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    def is_cast(node):
        return node.name == "aten::_to_copy" and node.input_shapes and list(node.input_shapes[0]) == list(cross_shape)

    cast_ms, casts = 0.0, 0
    for ev in kept["prof"].events():
        if ev.device_type != DeviceType.CPU:
            continue
        casts += is_cast(ev)
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        node = ev
        while ms > 0 and node is not None and not is_cast(node):
            node = node.cpu_parent
        if ms > 0 and node is not None:
            cast_ms += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"what": "one decode step, 8 rows, the cache at row 2", "step_wall_ms": wall_ms,
            "step_wall_ms_profiled": traced_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernels_traced": len(events), "busy_ms_by_kind": by_kind, "cross_cast_ms": cast_ms,
            "cross_casts": casts, "trace_attempts": attempts, "trace_lead_lost": lost,
            "top": [[name[:80], ms, n] for name, (ms, n) in top]}


def s2s_serve(torch, phase, model, src, mask, start, eos, what, garbage=None):
    """``generate_seq2seq`` greedy for S2S_NEW tokens on 8 rows: a warm call,
    then the timed one with an encoder counter on the encoder stack (one
    run a call), its tokens/s and peak memory; the encoder alone timed; the
    same decoder sequence fed again through the cache one token a step,
    each step timed (ITL) and its logprobs kept, then held to one
    teacher-forced forward (s2s_reference_check); with ``garbage`` (a
    source differing only under the mask) the tokens again, equal; one
    decode step traced."""
    from accelerate_tpu_torch import generate_seq2seq
    from accelerate_tpu_torch.ops.kv_cache import kv_layout

    cfg, b = model.config, src.shape[0]
    runs = [0]
    hook = model.module.enc_layers[0].register_forward_pre_hook(lambda *a: runs.__setitem__(0, runs[0] + 1))
    kw = dict(decoder_start_token_id=start, eos_token_id=eos, attention_mask=mask)
    generate_seq2seq(model, src, max_new_tokens=4, **kw)  # warm: allocator, GEMM heuristics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = runs[0]
    t0 = time.perf_counter()
    out = generate_seq2seq(model, src, max_new_tokens=S2S_NEW, **kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    encoder_runs = runs[0] - before
    check(encoder_runs == 1, f"{phase}: the encoder runs once a generate_seq2seq call ({encoder_runs})")
    check(out.shape == (b, 1 + S2S_NEW) and out.dtype == torch.int32, f"{phase}: output {tuple(out.shape)}")
    hook.remove()
    with torch.no_grad():
        enc_ms = time_ms(torch, lambda: model.module.encode(*((src, mask) if mask is not None else (src,))),
                         reps=5, warmup=1)
        step_ms, step_lp = [], []
        logits, cache = model(src, out[:, :1], attention_mask=mask, decode=True, cache=None)
        for i in range(S2S_NEW):
            step_lp.append(torch.log_softmax(logits[:, -1], -1).gather(-1, out[:, i + 1, None].long())[:, 0])
            if i == S2S_NEW - 1:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model(src, out[:, i + 1:i + 2], decode=True, cache=cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        del cache
    compared, near, lp_err = s2s_reference_check(torch, model, src, mask, out, torch.stack(step_lp, 1), eos)
    row = {"phase": phase, "what": what, "params": model.num_parameters(), "batch": b,
           "source_shape": list(src.shape), "max_new_tokens": S2S_NEW, "max_decode_len": cfg.max_decode_len,
           "encoder_runs_a_call": encoder_runs, "generate_s": wall_s, "tokens_per_s": b * S2S_NEW / wall_s,
           "encoder_ms": enc_ms, "itl_ms_p50": statistics.median(step_ms),
           "itl_ms_p90": sorted(step_ms)[int(np.ceil(0.9 * len(step_ms))) - 1], "peak_memory_gb": peak,
           "tokens_compared": compared, "stopped_at_near_tie": near, "max_logprob_err": lp_err,
           "eos_emitted": int((out[:, 1:] == eos).any(-1).sum())}
    if garbage is not None:
        again = generate_seq2seq(model, garbage, max_new_tokens=S2S_NEW, **kw)
        check(torch.equal(again, out), f"{phase}: garbage under the mask changes the tokens")
        row["garbage_under_mask_equal"] = True
    heads, head_dim = kv_layout(cfg)
    s_enc = src.shape[1] if mask is not None else (src.shape[1] + 1) // 2  # Whisper's conv2 halves the frames
    row["decode_step"] = s2s_step_profile(torch, model, src, mask, out[:, :1], (b, s_enc, heads, head_dim))
    return row


def phase_t5_serve(torch):
    """T5-large at full width and depth (seeded random weights, bf16,
    ``max_decode_len`` 128): 8 sources of 64-512 tokens right-padded to 512
    with their mask, greedy for 64 tokens through ``generate_seq2seq``
    (s2s_serve), garbage under the mask giving the same tokens."""
    from accelerate_tpu_torch.models import T5Config, create_t5_model

    cfg = T5Config(**T5_LARGE, max_decode_len=S2S_DECODE_LEN)
    free_memory(torch)
    t0 = time.perf_counter()
    model = create_t5_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(19)
    lengths = np.linspace(64, T5_SRC, S2S_BATCH).astype(int)
    mask = np.arange(T5_SRC)[None] < lengths[:, None]
    ids = np.where(mask, rng.integers(2, cfg.vocab_size, size=(S2S_BATCH, T5_SRC)), 0).astype(np.int32)
    garbage = np.where(mask, ids, rng.integers(2, cfg.vocab_size, size=ids.shape)).astype(np.int32)
    dev = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    row = s2s_serve(torch, "t5_serve", model, dev(ids), dev(mask), T5_START, T5_EOS,
                    "T5-large (google-t5/t5-large widths, 24 + 24 layers), bf16, seeded random weights",
                    garbage=dev(garbage))
    row.update(model_build_s=build_s, source_lengths=lengths.tolist())
    emit(row)
    del model
    free_memory(torch)
    return row


def t5_step_flops(cfg, b: int, s: int, t: int) -> float:
    """A T5 train step's FLOPs at batch ``b``, ``s`` source and ``t`` target
    tokens: 6 x each projection's parameters x the tokens it sees (the
    cross K/V projections see the source), the attention scores 12 x
    width x query x key pairs a layer (the decoder's causal half), and a
    tied head's 6 x target tokens x hidden x vocab."""
    d, inner, ff, n = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, cfg.intermediate_size, cfg.num_layers
    enc = 6.0 * b * s * (4 * d * inner + 2 * d * ff) + 12.0 * b * inner * s * s
    dec = 6.0 * b * t * (6 * d * inner + 2 * d * ff) + 6.0 * b * s * 2 * d * inner \
        + 12.0 * b * inner * (0.5 * t * t + t * s)
    return n * (enc + dec) + 6.0 * b * t * d * cfg.vocab_size


def phase_t5_train(torch):
    """T5-large at full width and depth, f32 masters, bf16 compute, AdamW
    (3e-4, weight decay 0.01) through ``build_train_step(lambda p, b:
    seq2seq_lm_loss(p, b, model.apply_fn))``: 2 warm-up and 10 timed steps
    at 16 x 512 source (right-padded, 384-512 real) and 128 target tokens
    whose last 16 labels are -100; losses finite and falling; one step
    traced by kernel kind."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import T5Config, create_t5_model, seq2seq_lm_loss
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    b, s, t, warmup, timed = 16, T5_SRC, 128, 2, 10
    cfg = T5Config(**T5_LARGE, max_decode_len=S2S_DECODE_LEN)
    free_memory(torch)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    model = acc.prepare_model(create_t5_model(cfg, seed=0))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=3e-4, weight_decay=0.01))
    step = acc.build_train_step(lambda p, batch: seq2seq_lm_loss(p, batch, model.apply_fn))
    src = token_batches(torch, warmup + timed + 1, b, s, cfg.vocab_size, seed=21)
    labels = token_batches(torch, warmup + timed + 1, b, t, cfg.vocab_size, seed=22)
    labels[:, :, -16:] = -100
    rng = np.random.default_rng(23)
    lengths = torch.as_tensor(rng.integers(3 * s // 4, s + 1, size=(warmup + timed + 1, b, 1)), device="cuda")
    masks = torch.arange(s, device="cuda") < lengths
    batches = [{"input_ids": src[i], "attention_mask": masks[i], "labels": labels[i]}
               for i in range(warmup + timed + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(float(step(batches[i])))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"t5_train: losses finite: {losses}")
    check(losses[-1] < losses[0], f"t5_train: loss falls: {losses[0]} -> {losses[-1]}")
    step_ms = sorted(times[warmup:])
    med = statistics.median(step_ms)
    flops = t5_step_flops(cfg, b, s, t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    events, traced_ms, attempts, lost = traced(torch, lambda: step(batches[-1]))
    busy, by_name = device_time(events)
    by_kind = {}
    for name, (ms, _) in by_name.items():
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    row = {
        "phase": "t5_train", "config": "T5-large, 24 + 24 layers, f32 masters + bf16 compute, seeded",
        "params": model.num_parameters(), "batch": b, "source": s, "target": t, "label_ignored_tail": 16,
        "warmup_steps": warmup, "timed_steps": timed, "tokens_per_s": b * (s + t) / (med / 1e3),
        "step_ms_median": med, "step_ms_p90": step_ms[int(np.ceil(0.9 * len(step_ms))) - 1], "step_flops": flops,
        "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak, "losses": losses,
        # the idle share against the profiled step's wall and against the unprofiled median (the profiler's
        # host cost a launch is a large share of a step of ~8,700 launches)
        "profile": {"step_wall_ms": traced_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / traced_ms,
                    "idle_share_unprofiled": 1.0 - busy / med,
                    "busy_ms_by_kind": by_kind, "kernels_traced": len(events), "trace_attempts": attempts,
                    "trace_lead_lost": lost, "top": [[name[:90], ms, n] for name, (ms, n) in top]},
    }
    emit(row)
    del acc, model, step, batches, src, labels, masks
    free_memory(torch)
    return row


def phase_whisper_serve(torch):
    """Whisper-large-v3 at full width and depth (seeded random weights,
    bf16, ``max_decode_len`` 128): 8 seeded log-mel inputs of 3,000 frames x
    128 bins in bf16 (1,500 encoder positions; the encoder computes in the
    features' dtype), greedy for 64 tokens from <|startoftranscript|> with
    EOS 50,257 through ``generate_seq2seq`` (s2s_serve); the traced step's
    casts of the f32 cross K/V (2 x 32 layers of 8 x 1,500 x 1,280, read in
    f32 and written in bf16: 5.9 GB) timed."""
    from accelerate_tpu_torch.models import WhisperConfig, create_whisper_model

    cfg = WhisperConfig(**WHISPER_LARGE_V3, max_decode_len=S2S_DECODE_LEN)
    free_memory(torch)
    t0 = time.perf_counter()
    model = create_whisper_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    feats = np.random.default_rng(20).standard_normal((S2S_BATCH, WHISPER_FRAMES, cfg.num_mel_bins))
    src = torch.as_tensor(feats, dtype=torch.float32, device="cuda").bfloat16()
    row = s2s_serve(torch, "whisper_serve", model, src, None, WHISPER_START, WHISPER_EOS,
                    "Whisper-large-v3 (openai/whisper-large-v3 widths, 32 + 32 layers), bf16, seeded random weights")
    s_enc = (WHISPER_FRAMES + 1) // 2
    cast_bytes = 2 * cfg.decoder_layers * S2S_BATCH * s_enc * cfg.d_model * (4 + 2)
    step = row["decode_step"]
    check(step["cross_casts"] == 2 * cfg.decoder_layers,
          f"whisper_serve: {step['cross_casts']} cross K/V casts traced in a step, want {2 * cfg.decoder_layers}")
    row.update(model_build_s=build_s, encoder_positions=s_enc, cross_cast_bytes=cast_bytes,
               cross_cast_bound_ms=cast_bytes / HBM_BYTES_PER_S * 1e3)
    emit(row)
    del model
    free_memory(torch)
    return row


def s2s_card_vs_cpu(torch, family, cpu, card, src, mask, start) -> dict:
    """One family's 2 + 2-layer f32 cut, card against CPU: logits of a
    teacher-forced forward within S2S_CUT_TOL of the CPU's RMS; the cached
    decode (prefill on the start token, then 15 steps of the same tokens)
    step by step likewise; ``generate_seq2seq`` for 8 tokens token for token (a
    token differing only where the CPU's top-2 gap is under 1e-3, which
    ends that row)."""
    import copy

    from accelerate_tpu_torch import generate_seq2seq

    tol = S2S_CUT_TOL[family]
    dec = torch.as_tensor(np.random.default_rng(31).integers(0, card.config.vocab_size, size=(2, 16)),
                          dtype=torch.int32)
    dec[:, 0] = start
    src_card = src.to("cuda")
    mask_card = None if mask is None else mask.to("cuda")
    with torch.no_grad():
        want = cpu(src, dec, attention_mask=mask)
        got = card(src_card, dec.cuda(), attention_mask=mask_card).cpu()
        rms = float(want.pow(2).mean().sqrt())
        err = float((got - want).abs().max())
        f64 = copy.deepcopy(cpu.module).double()(src if mask is not None else src.double(), dec, attention_mask=mask)
        floor = float((want.double() - f64).abs().max()) / rms
        check(bool(torch.isfinite(got).all()) and err <= tol * rms,
              f"{family}: card logits within {tol} of the CPU's RMS: {err} vs {rms}")
        step_err = 0.0
        lw, cw = cpu(src, dec[:, :1], attention_mask=mask, decode=True, cache=None)
        lg, cg = card(src_card, dec[:, :1].cuda(), attention_mask=mask_card, decode=True, cache=None)
        for i in range(16):
            step_err = max(step_err, float((lg.cpu() - lw).abs().max()))
            if i == 15:
                break
            lw, cw = cpu(src, dec[:, i + 1:i + 2], decode=True, cache=cw)
            lg, cg = card(src_card, dec[:, i + 1:i + 2].cuda(), decode=True, cache=cg)
        check(step_err <= tol * rms, f"{family}: cached steps within {tol} of the CPU's RMS: {step_err}")
    want_tok = generate_seq2seq(cpu, src, max_new_tokens=8, decoder_start_token_id=start, attention_mask=mask).numpy()
    got_tok = generate_seq2seq(card, src_card, max_new_tokens=8, decoder_start_token_id=start,
                               attention_mask=mask_card).cpu().numpy()
    compared = near = 0
    for r in range(2):
        diff = np.nonzero(want_tok[r, 1:] != got_tok[r, 1:])[0]
        upto = int(diff[0]) if len(diff) else 8
        compared += upto
        if len(diff):
            with torch.no_grad():
                row = cpu(src[r:r + 1], torch.as_tensor(want_tok[r:r + 1, :1 + upto]),
                          attention_mask=None if mask is None else mask[r:r + 1])[0, -1]
            top2 = torch.topk(row, 2).values
            gap = float(top2[0] - top2[1])
            check(gap < 1e-3, f"{family}: generated token {upto} differs with top-2 gap {gap}")
            near += 1
    return {"family": family, "params": cpu.num_parameters(), "logits_max_abs_err": err, "logits_rms": rms,
            "tol_over_rms": tol, "cpu_f32_vs_f64": floor, "cached_steps_max_abs_err": step_err, "tokens_compared": compared, "stopped_at_near_tie": near}


def phase_s2s_consistency(torch):
    """T5-large and Whisper-large-v3 at their published widths cut to 2 + 2
    layers, f32, built on the CPU and copied to the card (s2s_card_vs_cpu;
    T5 on 64-token sources, one padded to 40; Whisper on 400 frames with
    cuDNN's TF32 off, so its convolutions are f32); and T5's bucket ids:
    those the model uses on the card (built on the host, then moved) equal
    to the CPU's for every relative position in +-4,096, both directions,
    and the formula evaluated on the card itself, its disagreements
    counted."""
    import copy

    from accelerate_tpu_torch.modeling import Model
    from accelerate_tpu_torch.models import T5Config, WhisperConfig, create_t5_model, create_whisper_model
    from accelerate_tpu_torch.models.t5 import _bucketize, relative_position_buckets

    rows = []
    rng = np.random.default_rng(30)
    t5_cfg = T5Config(**{**T5_LARGE, "num_layers": 2}, max_decode_len=S2S_DECODE_LEN)
    cpu = create_t5_model(t5_cfg, seed=5, device="cpu")
    card = Model(copy.deepcopy(cpu.module).to("cuda"), t5_cfg, name=cpu.name)
    src = torch.as_tensor(rng.integers(2, t5_cfg.vocab_size, size=(2, 64)), dtype=torch.int32)
    mask = torch.arange(64)[None] < torch.tensor([[64], [40]])
    rows.append(s2s_card_vs_cpu(torch, "t5", cpu, card, src, mask, T5_START))
    del cpu, card
    w_cfg = WhisperConfig(**{**WHISPER_LARGE_V3, "encoder_layers": 2, "decoder_layers": 2},
                          max_decode_len=S2S_DECODE_LEN)
    cpu = create_whisper_model(w_cfg, seed=5, device="cpu")
    card = Model(copy.deepcopy(cpu.module).to("cuda"), w_cfg, name=cpu.name)
    feats = torch.as_tensor(rng.standard_normal((2, S2S_CUT_FRAMES, w_cfg.num_mel_bins)), dtype=torch.float32)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        rows.append(s2s_card_vs_cpu(torch, "whisper", cpu, card, feats, None, WHISPER_START))
    del cpu, card
    free_memory(torch)
    buckets = {}
    nb, md = T5_LARGE["relative_attention_num_buckets"], T5_LARGE["relative_attention_max_distance"]
    rel = torch.arange(-4096, 4097)
    for bidirectional in (True, False):
        name = "encoder" if bidirectional else "decoder"
        # rel = key - query over +-4,096: a query at 0 against keys 0..4096, keys at 0 against queries 0..4096
        used = [relative_position_buckets(1, 4097, nb, md, bidirectional, torch.device("cuda")),
                relative_position_buckets(4097, 1, nb, md, bidirectional, torch.device("cuda"))]
        want = [relative_position_buckets(1, 4097, nb, md, bidirectional), relative_position_buckets(4097, 1, nb, md,
                                                                                                    bidirectional)]
        equal = all(u.is_cuda and torch.equal(u.cpu(), w) for u, w in zip(used, want))
        check(equal, f"T5 {name} bucket ids on the card equal the CPU's over +-4,096")
        on_card = _bucketize(rel.cuda(), nb, md, bidirectional).cpu()
        host = _bucketize(rel, nb, md, bidirectional)
        buckets[name] = {"model_ids_equal": equal, "formula_on_card_disagreements": int((on_card != host).sum()),
                         "disagreeing_rel": rel[on_card != host][:8].tolist()}
    row = {"phase": "s2s_consistency", "families": rows, "bucket_ids": buckets}
    emit(row)
    return row


def phase_s2s(torch) -> dict:
    """The encoder-decoder group: T5-large served and trained, Whisper-large-v3
    served, the 2 + 2-layer cuts card against CPU. No kernel of the port
    lies on these paths (K1-K5's counters read the same after the group)."""
    before = kernel_counts()
    t0 = time.perf_counter()
    t5 = phase_t5_serve(torch)
    train = phase_t5_train(torch)
    whisper = phase_whisper_serve(torch)
    consistency = phase_s2s_consistency(torch)
    after = kernel_counts()
    check(after == before, f"s2s: the kernel counters moved: {before} -> {after}")
    emit({"phase": "s2s", "kernel_counts_unchanged": after, "seconds": time.perf_counter() - t0})
    return {"t5_serve": t5, "t5_train": train, "whisper_serve": whisper, "consistency": consistency}


# --------------------------------------------------------------------------- #
# the vision and diffusion families (--only vision, --only diffusion)
# --------------------------------------------------------------------------- #

# openai/clip-vit-large-patch14 config.json; its text tower is Stable Diffusion v1.5's text encoder
CLIP_L14 = dict(image_size=224, patch_size=14, vision_hidden_size=1024, vision_layers=24, vision_heads=16,
                vision_ffn_dim=4096, vocab_size=49408, max_text_positions=77, text_hidden_size=768, text_layers=12,
                text_heads=12, text_ffn_dim=3072, eos_token_id=2, projection_dim=768)
CLIP_SOT, CLIP_EOT = 49406, 49407  # the EOT is the vocabulary's highest id: the legacy argmax pooling finds it
# runwayml/stable-diffusion-v1-5 unet/config.json in the JAX package's UNet2D layout (its AttnBlocks carry no FFN:
# 711,768,004 parameters) and vae/config.json (one ResBlock a level and no attention: 40,337,291), depth the repo's
SD15_UNET = dict(in_channels=4, out_channels=4, sample_size=64, base_channels=320, channel_mults=(1, 2, 4, 4),
                 layers_per_block=2, attention_levels=(0, 1, 2), num_heads=8, num_groups=32, context_dim=768)
SD15_VAE = dict(sample_size=512, base_channels=128, channel_mults=(1, 2, 4, 4), latent_channels=4, num_groups=32,
                scaling_factor=0.18215)
SD_FLASH_CALLS = 10  # a UNet forward's K1 launches: 5 AttnBlocks on the 64 x 64 level, self- and cross-attention
SD_STEPS, SD_GUIDANCE = 50, 7.5  # the SD pipeline's defaults
# vision_consistency / diffusion_consistency: |card - CPU| over the CPU tensor's RMS (a gradient's RMS floored at
# 1e-4 of the largest gradient RMS), f32 with TF32 off. Set from the f64 floor each phase reports (the CPU's f32
# against its f64 run of the same cut)
VISION_CUT_TOL = 1e-4
DIFFUSION_CUT_TOL = 1e-4
# The guided 4-step DDIM sample of diffusion_consistency's UNet cut: its first step divides the predicted noise by
# sqrt(abar_999) = 6.4e-3 after guidance multiplied cond - uncond by 7.5, so f32 itself is coarse there: the CPU's
# f32 sample sits 1.8e-3 of its RMS from the same loop in f64 (scripts/torch_ddim_floor.py, on the CPU), the
# card's 1.4e-3 from the CPU's (H100, 700 W). Held to 5e-3
DDIM_CUT_TOL = 5e-3
# ... or FLOOR_FACTOR x the tensor's own f64 floor, where f32 itself is that far off: ViT-B/16's cut has head.weight's
# gradient 7.2e-5 of its RMS from f64 on the CPU, CLIP ViT-L/14's the token table's 1.4e-3 (a sparse gradient)
FLOOR_FACTOR = 4.0
# A key bias adds q . bias to every logit of a row, which the softmax cancels: its gradient is zero in exact
# arithmetic and rounding noise on either side (2e-8 of the largest gradient RMS apart on ViT-B/16's cut, H100).
# Held to |gradient| <= ZERO_GRAD_TOL x that RMS on both, not to each other
ZERO_GRAD_TOL = 1e-6
ZERO_GRAD_PARAMS = ("attention.key.bias", "k_proj.bias")


def all_kernel_counts():
    """Every kernel wrapper's launch counter, K1-K8."""
    from accelerate_tpu_torch.kernels import fixtures, reference

    return {**kernel_counts(), "k6": reference.launches_matmul_softmax, "k7": reference.launches_accumulate,
            "k8": (fixtures.launches_copy, fixtures.launches_add, fixtures.launches_scale)}


def reset_flash_counts():
    from accelerate_tpu_torch.ops import flash_attention as fa

    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0


def flash_counts() -> dict:
    from accelerate_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv}


@contextlib.contextmanager
def f32_exact(torch):
    """TF32 off for cuBLAS and cuDNN (torch lets cuDNN convolve f32 in TF32 by
    default), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def vision_kind(name: str) -> str:
    """A traced kernel's kind on the vision and diffusion paths."""
    n = name.lower()
    if "flash_" in n and ("sm90" in n or "f32" in n or "wgmma" in n):
        return "flash"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "conv"
    if "norm" in n or "welford" in n:
        return "norm"
    return kernel_kind(name)


def step_profile(torch, run, wall_ms_unprofiled) -> dict:
    """One ``run()`` traced: busy, idle share, busy ms by kind, the top kernels."""
    events, traced_ms, attempts, lost = traced(torch, run)
    busy, by_name = device_time(events)
    by_kind: dict = {}
    for name, (ms, _) in by_name.items():
        by_kind[vision_kind(name)] = by_kind.get(vision_kind(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": traced_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / traced_ms,
            "idle_share_unprofiled": 1.0 - busy / wall_ms_unprofiled, "busy_ms_by_kind": by_kind,
            "kernels_traced": len(events), "trace_attempts": attempts, "trace_lead_lost": lost,
            "top": [[name[:90], ms, n] for name, (ms, n) in top]}


def vision_trainer(torch, model, loss_fn, lr):
    """``(accelerator, prepared model, step)``: f32 masters, bf16 compute,
    AdamW (weight decay 0.01) through ``build_train_step`` over
    ``loss_fn(params, batch, model.apply_fn)``."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    model = acc.prepare_model(model)
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=lr, weight_decay=0.01))
    return acc, model, acc.build_train_step(lambda p, batch: loss_fn(p, batch, model.apply_fn))


def train_on_one_batch(torch, phase, step, batch, warmup, timed, extra_flops=0.0) -> dict:
    """The first step under ``FlopCounterMode`` (the step's FLOPs; plus
    ``extra_flops`` for what it cannot see), then ``warmup - 1`` and
    ``timed`` more on the same batch: losses, step ms, MFU at the bf16 peak
    and peak memory. The losses must be finite and fall."""
    from torch.utils.flop_counter import FlopCounterMode

    free_memory(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        losses = [float(step(batch))]
    flops = counter.get_total_flops() + extra_flops
    losses += [float(step(batch)) for _ in range(warmup - 1)]
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))  # float() waits for the card
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"{phase}: losses finite: {losses}")
    check(losses[-1] < losses[0], f"{phase}: the loss falls on the repeated batch: {losses[0]} -> {losses[-1]}")
    med = statistics.median(times)
    return {"losses": losses, "warmup_steps": warmup, "timed_steps": timed, "step_ms_median": med,
            "step_ms_min": min(times), "step_flops": flops, "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def clip_ids(torch, rng, n, device="cuda"):
    """``n`` rows of 77 ids: SOT, 5-75 random tokens, the EOT (the highest id),
    EOT padding (the pipelines' padding)."""
    t = CLIP_L14["max_text_positions"]
    ids = np.full((n, t), CLIP_EOT, np.int64)
    ids[:, 0] = CLIP_SOT
    for r in range(n):
        length = int(rng.integers(5, t - 1))
        ids[r, 1: 1 + length] = rng.integers(1, CLIP_SOT, size=length)
    return torch.as_tensor(ids, device=device)


def phase_vit_train(torch):
    """ViT-B/16 (``ViTConfig.base()``: 224 px, patch 16, 768 wide, 12 layers
    of 12 heads, FFN 3,072, 1,000 classes; seeded random weights), f32
    masters and bf16 compute, AdamW(3e-4) through
    ``build_train_step(vit_classification_loss)``: 10 steps at batch 64 on
    one repeated batch, the last 8 timed; samples/s, MFU from the step's
    FLOP count, peak memory; one step traced. Its 197 positions stay under
    ``FLASH_MIN_SEQ``: no kernel of the port runs (the einsum path, as in
    the JAX package)."""
    from accelerate_tpu_torch.models import ViTConfig, create_vit_model, vit_classification_loss

    b, cfg = 64, ViTConfig.base()
    acc, model, step = vision_trainer(torch, create_vit_model(cfg, seed=0), vit_classification_loss, 3e-4)
    gen = torch.Generator(device="cuda").manual_seed(40)
    batch = {"images": torch.randn(b, cfg.image_size, cfg.image_size, 3, generator=gen, device="cuda"),
             "labels": torch.randint(0, cfg.num_classes, (b,), generator=gen, device="cuda")}
    row = {"phase": "vit_train", "config": "ViT-B/16 (google/vit-base-patch16-224 widths), f32 masters + bf16 "
           "compute, seeded", "params": model.num_parameters(), "batch": b,
           **train_on_one_batch(torch, "vit_train", step, batch, warmup=2, timed=8)}
    row["samples_per_s"] = b / (row["step_ms_median"] / 1e3)
    row["profile"] = step_profile(torch, lambda: step(batch), row["step_ms_median"])
    emit(row)
    del acc, model, step, batch
    free_memory(torch)
    return row


def phase_clip_train(torch):
    """CLIP ViT-L/14 (openai/clip-vit-large-patch14 widths; seeded random
    weights), f32 masters and bf16 compute, AdamW(1e-4) through
    ``build_train_step(clip_contrastive_loss)``: 10 steps on one repeated
    batch of 64 image-text pairs (77-token ids ending in the EOT, the
    highest id, which the legacy ``eos_token_id == 2`` pooling finds by
    argmax), the last 8 timed; pairs/s, MFU, peak memory; one step traced.
    Then a zero-shot pass on the trained f32 masters: 8 images against 8
    texts, the similarity matrix and each image's argmax text. The towers' 257 and 77 positions stay
    under ``FLASH_MIN_SEQ``: no kernel of the port runs."""
    from accelerate_tpu_torch.models import CLIPConfig, clip_contrastive_loss, create_clip_model

    b = 64
    acc, model, step = vision_trainer(torch, create_clip_model(CLIPConfig(**CLIP_L14), seed=0),
                                      clip_contrastive_loss, 1e-4)
    gen = torch.Generator(device="cuda").manual_seed(41)
    size = CLIP_L14["image_size"]
    batch = {"pixel_values": torch.randn(b, size, size, 3, generator=gen, device="cuda"),
             "input_ids": clip_ids(torch, np.random.default_rng(41), b)}
    row = {"phase": "clip_train", "config": "CLIP ViT-L/14 (openai/clip-vit-large-patch14 widths), f32 masters + "
           "bf16 compute, seeded", "params": model.num_parameters(), "pairs": b,
           **train_on_one_batch(torch, "clip_train", step, batch, warmup=2, timed=8)}
    row["pairs_per_s"] = b / (row["step_ms_median"] / 1e3)
    row["profile"] = step_profile(torch, lambda: step(batch), row["step_ms_median"])
    with torch.no_grad():
        params = model.params  # the trained f32 masters

        def zero_shot():
            img, txt, scale = model.apply_fn(params, batch["pixel_values"][:8], batch["input_ids"][:8])
            return torch.softmax(torch.exp(scale.float()) * img.float() @ txt.float().T, dim=-1)

        probs = zero_shot()
        zs_ms = time_ms(torch, zero_shot, reps=5, warmup=1)
    check(probs.shape == (8, 8) and bool(torch.isfinite(probs).all()), "clip_train: zero-shot 8 x 8, finite")
    check(bool(torch.allclose(probs.sum(-1), torch.ones(8, device="cuda"), atol=1e-5)), "clip_train: rows sum to 1")
    picks = probs.argmax(-1).tolist()
    row["zero_shot"] = {"images": 8, "texts": 8, "ms": zs_ms, "argmax_text": picks,
                        "matched_own_text": sum(int(p == i) for i, p in enumerate(picks))}
    emit(row)
    del acc, model, step, batch, params
    free_memory(torch)
    return row


def cut_err(a, b, floor=0.0) -> float:
    """max |a - b| over the larger of ``b``'s RMS and ``floor``."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.pow(2).mean().sqrt()), floor, 1e-30))


def grads_of(torch, model, loss_fn, batch):
    """``(loss, {name: gradient})`` of ``loss_fn(params, batch, apply_fn)`` on
    the model's own parameters (f32)."""
    params = {n: p.detach().clone().requires_grad_() for n, p in model.module.named_parameters()}
    loss = loss_fn(params, batch, model.apply_fn)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def card_vs_cpu(torch, cpu_out: dict, card_out: dict, grad_keys=()) -> tuple[dict, dict]:
    """``(the largest error of each output (cut_err), gradients floored at
    1e-4 of their largest RMS; the zero-gradient parameters' largest
    |gradient| over that RMS, card or CPU)``."""
    g_rms = max((float(cpu_out[k].pow(2).mean().sqrt()) for k in grad_keys), default=0.0)
    zero = {k for k in grad_keys if k.endswith(ZERO_GRAD_PARAMS)}
    errs = {k: cut_err(card_out[k], v, 1e-4 * g_rms if k in grad_keys else 0.0) for k, v in cpu_out.items()
            if k not in zero}
    return errs, {k: max(float(cpu_out[k].abs().max()), float(card_out[k].abs().max())) / g_rms for k in zero}


def phase_vision_consistency(torch):
    """ViT-B/16 and CLIP ViT-L/14 at their published widths cut to 2 layers
    (CLIP: 2 vision + 2 text), f32, built on the CPU and loaded on the card,
    TF32 off: logits (ViT) or both embeddings and the logit scale (CLIP),
    the loss, and every parameter's gradient of one step, card against CPU.
    Each tensor is held within the larger of ``VISION_CUT_TOL`` and
    ``FLOOR_FACTOR`` x its f64 floor (the CPU's f32 against the same cut
    run in f64 on the CPU, its norms and ViT's head in f32 by design) of its
    RMS; the key biases' gradients, zero in exact arithmetic, within
    ``ZERO_GRAD_TOL``."""
    from accelerate_tpu_torch.models import (
        CLIPConfig,
        ViTConfig,
        clip_contrastive_loss,
        create_clip_model,
        create_vit_model,
        vit_classification_loss,
    )

    rng = np.random.default_rng(42)
    rows, failed = [], []
    size = CLIP_L14["image_size"]  # ViT-B/16's too
    pix = torch.as_tensor(rng.standard_normal((4, size, size, 3)), dtype=torch.float32)
    cases = (
        ("vit_b16_2_layers", lambda dev: create_vit_model(ViTConfig.base(num_hidden_layers=2), seed=6, device=dev),
         vit_classification_loss, {"images": pix, "labels": torch.as_tensor(rng.integers(0, 1000, 4))}),
        ("clip_l14_2_layers", lambda dev: create_clip_model(
            CLIPConfig(**{**CLIP_L14, "vision_layers": 2, "text_layers": 2}), seed=6, device=dev),
         clip_contrastive_loss, {"pixel_values": pix, "input_ids": clip_ids(torch, rng, 4, device="cpu")}),
    )

    def run(model, loss_fn, batch, dev, dtype):
        b = {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev)) for k, v in batch.items()}
        with f32_exact(torch):
            loss, grads = grads_of(torch, model, loss_fn, b)
            with torch.no_grad():
                fwd = model.apply_fn(model.params, *b.values()) if "input_ids" in b else \
                    model.apply_fn(model.params, b["images"])
        fwd = {"logits": fwd} if torch.is_tensor(fwd) else dict(zip(("image_embeds", "text_embeds", "logit_scale"),
                                                                    fwd))
        return {**{k: v.cpu() for k, v in fwd.items()}, "loss": loss.cpu(),
                **{f"grad:{k}": v.cpu() for k, v in grads.items()}}

    for name, build, loss_fn, batch in cases:
        cpu = build("cpu")
        card = build("cuda")
        card.load_state_dict(cpu.state_dict())
        outs = {"cpu": run(cpu, loss_fn, batch, "cpu", torch.float32),
                "cuda": run(card, loss_fn, batch, "cuda", torch.float32)}
        del card
        cpu.module.double()
        f64 = run(cpu, loss_fn, batch, "cpu", torch.float64)
        grad_keys = [k for k in outs["cpu"] if k.startswith("grad:")]
        errs, zero = card_vs_cpu(torch, outs["cpu"], outs["cuda"], grad_keys)
        floor, _ = card_vs_cpu(torch, f64, outs["cpu"], grad_keys)  # the CPU's f32 against its f64 run
        tol = {k: max(VISION_CUT_TOL, FLOOR_FACTOR * floor[k]) for k in errs}
        worst = max(errs, key=lambda k: errs[k] / tol[k])
        grads = [k for k in errs if k.startswith("grad:")]
        rows.append({"model": name, "outputs_err_over_rms": {k: errs[k] for k in errs if not k.startswith("grad:")},
                     "outputs_cpu_f32_vs_f64": {k: floor[k] for k in errs if not k.startswith("grad:")},
                     "grad_err_over_rms_max": max(errs[k] for k in grads),
                     "grad_cpu_f32_vs_f64_max": max(floor[k] for k in grads), "grads_compared": len(grads),
                     "worst_over_tol": [worst, errs[worst], tol[worst]],
                     "zero_grads_over_rms_max": max(zero.values()), "zero_grads": len(zero)})
        failed += [f"{name} {k}: {errs[k]} > {tol[k]}" for k in errs if errs[k] > tol[k]]
        failed += [f"{name} {k}: |grad| {g} > {ZERO_GRAD_TOL}" for k, g in zero.items() if g > ZERO_GRAD_TOL]
        del cpu, outs, f64
        free_memory(torch)
    row = {"phase": "vision_consistency", "config": "f32, TF32 off, batch 4, one step's gradients", "models": rows,
           "tol": VISION_CUT_TOL, "floor_factor": FLOOR_FACTOR}
    emit(row)
    check(not failed, f"vision_consistency: card vs CPU past tolerance: {failed[:4]}")
    return row


def phase_vision(torch) -> dict:
    """The vision group: ViT-B/16 and CLIP ViT-L/14 trained, their 2-layer
    cuts card against CPU. No kernel of the port lies on these paths (every
    sequence is under ``FLASH_MIN_SEQ``): K1-K8's counters read the same
    after the group."""
    before = all_kernel_counts()
    t0 = time.perf_counter()
    vit = phase_vit_train(torch)
    clip = phase_clip_train(torch)
    consistency = phase_vision_consistency(torch)
    after = all_kernel_counts()
    check(after == before, f"vision: the kernel counters moved: {before} -> {after}")
    emit({"phase": "vision", "kernel_counts_unchanged": after, "seconds": time.perf_counter() - t0})
    return {"vit_train": vit, "clip_train": clip, "consistency": consistency}


# K1-K3 at Stable Diffusion v1.5's 64 x 64 attention: (name, dtype, Sk, timed runs). B 8 (the guided sampler's
# batch), Sq 4,096, H 8, D 40, not causal; Sk 4,096 (self) or 77 (cross, over the CLIP text states)
D40_CASES = [
    ("bf16-self", "bfloat16", 4096, 30),
    ("bf16-cross", "bfloat16", 77, 30),
    ("f32-self", "float32", 4096, 3),
    ("f32-cross", "float32", 77, 10),
]


def phase_flash_d40(torch) -> dict:
    """K1-K3 at head dim 40 (built at 64, the columns past 40 zero) against
    their plain versions under ``FLASH_TOL``, in bf16 and f32, at the UNet's
    self- and cross-attention shapes: their times beside the bound
    (``flash_bound``), the plain version's and scaled_dot_product_attention's
    (forward; backward, dq, dk and dv in one call)."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    b, sq, h, d = 8, 4096, 8, 40
    results = {}
    for name, dtype_name_, sk, reps in D40_CASES:
        dtype = getattr(torch, dtype_name_)
        q, k, v, do = flash_inputs(torch, gen, b, sq, sk, h, h, d, dtype)
        errs, (out, lse, delta) = flash_compare(torch, fa, q, k, v, do, False, None)
        check_flash(errs, f"d40 {name}")
        scale = d**-0.5
        kernels = {
            "fwd": lambda: fa.flash_fwd_kernel(q, k, v, False, scale, None),
            "dq": lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, False, scale, None),
            "dkv": lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, False, scale, None),
        }
        plains = {
            "fwd": lambda: fa.flash_attention_plain(q, k, v, False, scale, None),
            "dq": lambda: fa.flash_attention_plain_dq(q, k, v, do, lse, delta, False, scale, None),
            "dkv": lambda: fa.flash_attention_plain_dkv(q, k, v, do, lse, delta, False, scale, None),
        }
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        row = {"phase": "flash_d40", "case": name, "shape": {"b": b, "sq": sq, "sk": sk, "h": h, "d": d},
               "causal": False, "built_width": fa.kernel_width(d),
               "library_max_abs_err_fwd": (lib_out.transpose(1, 2).float() - out.float()).abs().max().item()}
        for kind in kernels:
            bound_ms, bound_by = flash_bound(kind, q, k, False, None)
            ms = time_ms(torch, kernels[kind], reps=reps, flush=flush)
            row[kind] = {
                "max_abs_err": errs[kind][0], "err_over_tol": errs[kind][1], "ms": ms,
                "plain_ms": time_ms(torch, plains[kind], reps=min(reps, 3), warmup=1, flush=flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flash_flops(kind, q, k, False, None) / (ms * 1e-3) / 1e12, "share_of_bound": bound_ms / ms,
            }
        row["library_fwd_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=reps,
                                        flush=flush)
        row["library_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                                           retain_graph=True), reps=reps, flush=flush)
        emit(row)
        results[name] = row
        del q, k, v, do, out, lse, delta, qt, kt, vt, lib_out, dot, kernels, plains
    del flush
    free_memory(torch)
    return results


def sd_models(torch, dtype, unet=True):
    """Stable Diffusion v1.5's models at their published widths on the card,
    seeded: CLIP ViT-L/14 (its text tower is SD's text encoder), the UNet
    (None when ``unet`` is false) and the VAE."""
    from accelerate_tpu_torch.models import (
        CLIPConfig,
        UNetConfig,
        VAEConfig,
        create_clip_model,
        create_unet_model,
        create_vae_model,
    )

    return (create_clip_model(CLIPConfig(**CLIP_L14), seed=1, dtype=dtype),
            create_unet_model(UNetConfig(**SD15_UNET), seed=2, dtype=dtype) if unet else None,
            create_vae_model(VAEConfig(**SD15_VAE), seed=3, dtype=dtype))


def phase_t2i_serve(torch) -> dict:
    """``text_to_image`` at Stable Diffusion v1.5's widths (CLIP ViT-L/14's
    text tower, the UNet, the VAE; seeded random weights, bf16): 4 prompts
    of 77 tokens and the empty prompt's ids, guidance 7.5, 50 DDIM steps
    (the SD pipeline's defaults), so the UNet runs at batch 8 on 64 x 64
    latents and the VAE decodes 4 x 512 x 512 (in f32, the latents' dtype,
    as the JAX package's ``decode_fn`` does). A 2-step call warms up; the
    timed call's K1 launches must be 10 x 50 (the 64 x 64 level's self- and
    cross-attention at head dim 40); the images finite and [4, 512, 512,
    3]. The text-encode, per-denoising-step and VAE-decode ms timed alone;
    one guided denoising step traced by kind."""
    from accelerate_tpu_torch.diffusion import make_schedule, text_to_image

    free_memory(torch)
    clip, unet, vae = sd_models(torch, torch.bfloat16)
    rng = np.random.default_rng(43)
    prompts = clip_ids(torch, rng, 4)
    empty = torch.full((CLIP_L14["max_text_positions"],), CLIP_EOT, dtype=torch.int64, device="cuda")
    empty[0] = CLIP_SOT
    sched = make_schedule()

    def call(steps):
        return text_to_image(unet, vae, clip, prompts, empty, guidance_scale=SD_GUIDANCE, num_steps=steps,
                             schedule=sched, seed=0)

    call(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    t0 = time.perf_counter()
    images = call(SD_STEPS)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    px, lat = SD15_VAE["sample_size"], SD15_UNET["sample_size"]
    with torch.no_grad():
        ctx = clip.encode_text(clip.params, prompts)
        uctx = clip.encode_text(clip.params, empty[None].expand(prompts.shape))
        encode_ms = time_ms(torch, lambda: (clip.encode_text(clip.params, prompts),
                                            clip.encode_text(clip.params, empty[None].expand(prompts.shape))),
                            reps=5, warmup=1)
        x2 = torch.randn(8, lat, lat, 4, device="cuda")
        t2 = torch.full((8,), 500, dtype=torch.int32, device="cuda")
        ctx2 = torch.cat([ctx, uctx])
        unet_params = unet.params

        def denoise():
            return unet.apply_fn(unet_params, x2, t2, None, ctx2)

        step_ms = time_ms(torch, denoise, reps=5, warmup=1)
        latents = torch.randn(4, lat, lat, 4, device="cuda")
        vae_params = vae.params
        decode_ms = time_ms(torch, lambda: vae.decode_fn(vae_params, latents), reps=3, warmup=1)
        profile = step_profile(torch, denoise, step_ms)
    row = {"phase": "t2i_serve", "config": "SD v1.5 widths (CLIP ViT-L/14 text tower, UNet, VAE), bf16, seeded",
           "unet_params": unet.num_parameters(), "vae_params": vae.num_parameters(),
           "clip_params": clip.num_parameters(), "prompts": 4, "tokens": CLIP_L14["max_text_positions"],
           "guidance": SD_GUIDANCE,
           "steps": SD_STEPS, "call_s": call_s, "images_per_s": 4 / call_s, "text_encode_ms": encode_ms,
           "denoise_step_ms": step_ms, "vae_decode_ms": decode_ms, "peak_memory_gb": peak,
           "image_rms": float(images.pow(2).mean().sqrt()), "launches": launches, "step_profile": profile}
    emit(row)
    check(tuple(images.shape) == (4, px, px, 3) and images.dtype == torch.float32,
          f"t2i_serve: images [4, {px}, {px}, 3] f32, got {tuple(images.shape)} {images.dtype}")
    check(bool(torch.isfinite(images).all()), "t2i_serve: images finite")
    check(launches["fwd"] == SD_FLASH_CALLS * SD_STEPS and launches["dq"] == launches["dkv"] == 0,
          f"t2i_serve: K1 launches {launches} == {SD_FLASH_CALLS} x {SD_STEPS}")
    del clip, unet, vae, images, ctx, uctx, ctx2, x2, latents, unet_params, vae_params
    free_memory(torch)
    return row


def sd_attention_flops(b: int) -> float:
    """The flash kernels' FLOPs in one UNet train step at batch ``b`` (which
    ``FlopCounterMode`` cannot see: K1-K3 launch through ctypes): each of the
    5 level-0 AttnBlocks' self- (4,096 keys) and cross-attention (77), the
    forward's two products (4 x width x query x key pairs) and the
    backward's twice that."""
    width, positions = SD15_UNET["base_channels"], SD15_UNET["sample_size"] ** 2
    return 5 * 12.0 * b * width * positions * (positions + CLIP_L14["max_text_positions"])


def phase_ldm_train(torch) -> dict:
    """The SD v1.5 UNet trained through ``build_train_step`` over
    ``latent_diffusion_loss`` with the frozen VAE encoder (sampled) and CLIP
    ViT-L/14's text tower inside the step, as the reference's text-to-image
    example has it: f32 masters, bf16 compute, AdamW(1e-5); the VAE and CLIP
    frozen in bf16. 8 images of 512 x 512 and their 77-token prompts,
    conditioning dropped with probability 0.1: a FLOP-counted step, a warm
    step, 6 timed. Step ms, MFU (``FlopCounterMode`` plus the flash
    kernels' FLOPs), peak memory; one step traced (idle share, busy by
    kind). K1 = K2 = K3 = 10 x the timed steps (no remat); losses finite."""
    from torch.utils.flop_counter import FlopCounterMode

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.diffusion import latent_diffusion_loss, make_schedule
    from accelerate_tpu_torch.models import UNetConfig, create_unet_model
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    b, timed = 8, 6
    free_memory(torch)
    clip, _, vae = sd_models(torch, torch.bfloat16, unet=False)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    unet = acc.prepare_model(create_unet_model(UNetConfig(**SD15_UNET), seed=2))
    acc.prepare_optimizer(torch.optim.AdamW(unet.module.parameters(), lr=1e-5, weight_decay=0.01))
    sched = make_schedule()
    step = acc.build_train_step(lambda p, batch, rng: latent_diffusion_loss(
        p, batch, unet.apply_fn, sched, rng, vae=vae, text_encoder=clip.encode_text, text_params=clip.params))
    gen = torch.Generator(device="cuda").manual_seed(44)
    px = SD15_VAE["sample_size"]
    batch = {"pixel_values": torch.rand(b, px, px, 3, generator=gen, device="cuda") * 2 - 1,
             "input_ids": clip_ids(torch, np.random.default_rng(44), b)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        losses = [float(step(batch))]
    flops = counter.get_total_flops() + sd_attention_flops(b)
    losses.append(float(step(batch)))
    reset_flash_counts()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times)
    row = {"phase": "ldm_train", "config": "SD v1.5 UNet, f32 masters + bf16 compute; VAE and CLIP ViT-L/14 text "
           "tower frozen, bf16, in the step", "unet_params": unet.num_parameters(), "batch": b, "image_size": px,
           "timed_steps": timed, "losses": losses, "step_ms_median": med, "step_ms_min": min(times),
           "images_per_s": b / (med / 1e3), "step_flops": flops, "attention_flops": sd_attention_flops(b),
           "mfu": flops / (med / 1e3) / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak, "launches": launches,
           "profile": step_profile(torch, lambda: step(batch), med)}
    emit(row)
    check(all(np.isfinite(losses)), f"ldm_train: losses finite: {losses}")
    want = SD_FLASH_CALLS * timed
    check(launches == {"fwd": want, "dq": want, "dkv": want}, f"ldm_train: K1-K3 launches {launches} == {want} each")
    del acc, unet, step, batch, clip, vae
    free_memory(torch)
    return row


def phase_diffusion_consistency(torch) -> dict:
    """Card against CPU in f32 (TF32 off), from the same weights (built on
    the CPU, loaded on the card) and draws: a cut UNet keeping one 64 x 64
    level of 320 channels in 8 heads with SD's text conditioning (its 4
    AttnBlocks' attention runs K1 at D 40 on the card, the einsum on the
    CPU), on 1 latent at timestep 500; the VAE cut to 2 levels (base 128),
    encode (the mean) and decode at 256 x 256; a 4-step guided DDIM
    ``sample`` of the cut UNet from one x_T. Each within the larger of
    ``DIFFUSION_CUT_TOL`` and ``FLOOR_FACTOR`` x its f64 floor (the CPU's
    f32 against its f64 run; the GroupNorms and the output convolutions in
    f32 by design) of the CPU's RMS, the sample within ``DDIM_CUT_TOL``."""
    from accelerate_tpu_torch.diffusion import _sample, make_schedule
    from accelerate_tpu_torch.models import UNetConfig, VAEConfig, create_unet_model, create_vae_model

    rng = np.random.default_rng(45)
    ucfg = UNetConfig(**{**SD15_UNET, "channel_mults": (1,), "layers_per_block": 1, "attention_levels": (0,)})
    px, lat = SD15_VAE["sample_size"] // 2, SD15_UNET["sample_size"]
    vcfg = VAEConfig(**{**SD15_VAE, "sample_size": px, "channel_mults": (1, 2)})
    x = torch.as_tensor(rng.standard_normal((1, lat, lat, 4)), dtype=torch.float32)
    t = torch.tensor([500], dtype=torch.int32)
    ctx = torch.as_tensor(rng.standard_normal((1, CLIP_L14["max_text_positions"], SD15_UNET["context_dim"])),
                          dtype=torch.float32)
    img = torch.as_tensor(rng.uniform(-1, 1, (1, px, px, 3)), dtype=torch.float32)
    z = torch.as_tensor(rng.standard_normal((1, px // 2, px // 2, 4)), dtype=torch.float32)
    sched = make_schedule()
    cpu_unet, cpu_vae = create_unet_model(ucfg, seed=7, device="cpu"), create_vae_model(vcfg, seed=8, device="cpu")
    card_unet, card_vae = create_unet_model(ucfg, device="cuda"), create_vae_model(vcfg, device="cuda")
    card_unet.load_state_dict(cpu_unet.state_dict())
    card_vae.load_state_dict(cpu_vae.state_dict())
    out, launches = {}, {}
    for dev, unet, vae in (("cpu", cpu_unet, cpu_vae), ("cuda", card_unet, card_vae)):
        reset_flash_counts()
        with f32_exact(torch), torch.no_grad():
            eps = unet.apply_fn(unet.params, x.to(dev), t.to(dev), None, ctx.to(dev))
            enc = vae.encode_fn(vae.params, img.to(dev))[0]
            dec = vae.decode_fn(vae.params, z.to(dev))
            smp = _sample(unet, 1, 4, sched, guidance_scale=SD_GUIDANCE, encoder_hidden_states=ctx.to(dev),
                          x_T=x.to(dev))
        launches[dev] = flash_counts()
        out[dev] = {"unet_eps": eps.cpu(), "vae_encode": enc.cpu(), "vae_decode": dec.cpu(), "ddim_sample": smp.cpu()}
    del card_unet, card_vae
    # the f64 floor; the GroupNorms and the output convolutions compute in f32 by design (the reference's dtype)
    cpu_unet.module.double()
    cpu_vae.module.double()
    with torch.no_grad():
        f64 = {"unet_eps": cpu_unet.apply_fn(cpu_unet.params, x.double(), t, None, ctx.double()),
               "vae_encode": cpu_vae.encode_fn(cpu_vae.params, img.double())[0],
               "vae_decode": cpu_vae.decode_fn(cpu_vae.params, z.double())}
    floor = {k: cut_err(out["cpu"][k], v) for k, v in f64.items()}
    del cpu_unet, cpu_vae
    errs = {k: cut_err(out["cuda"][k], v) for k, v in out["cpu"].items()}
    tol = {k: max(DIFFUSION_CUT_TOL, FLOOR_FACTOR * floor[k]) for k in floor}
    tol["ddim_sample"] = DDIM_CUT_TOL
    # the cut's 4 AttnBlocks on 4,096 positions: K1 twice each a forward; the sampler's 4 guided forwards
    want_k1 = 2 * 4 * (1 + 4)
    row = {"phase": "diffusion_consistency", "config": "f32, TF32 off; UNet cut to one 64 x 64 level (320 ch, 8 "
           "heads of 40, SD's context), VAE cut to 2 levels at 256 px, 4-step guided DDIM",
           "err_over_rms": errs, "cpu_f32_vs_f64": floor, "tol": tol, "k1_launches": launches}
    emit(row)
    check(launches["cuda"]["fwd"] == want_k1 and launches["cpu"]["fwd"] == 0,
          f"diffusion_consistency: K1 launches card {launches['cuda']} == {want_k1}, CPU {launches['cpu']} == 0")
    for k, e in errs.items():
        check(e <= tol[k], f"diffusion_consistency: card vs CPU {k} err {e} <= {tol[k]}")
    free_memory(torch)
    return row


def phase_diffusion(torch) -> dict:
    """The diffusion group: K1-K3 at D 40, ``text_to_image`` and the UNet's
    train step at SD v1.5's widths, the cuts card against CPU. K4-K8's
    counters read the same after the group."""
    before = all_kernel_counts()
    t0 = time.perf_counter()
    d40 = phase_flash_d40(torch)
    serve = phase_t2i_serve(torch)
    train = phase_ldm_train(torch)
    consistency = phase_diffusion_consistency(torch)
    after = all_kernel_counts()
    others = [k for k in before if k not in ("k1", "k2", "k3")]
    check({k: after[k] for k in others} == {k: before[k] for k in others},
          f"diffusion: K4-K8's counters moved: {before} -> {after}")
    emit({"phase": "diffusion", "k4_k8_counts_unchanged": {k: after[k] for k in others},
          "seconds": time.perf_counter() - t0})
    return {"flash_d40": d40, "t2i_serve": serve, "ldm_train": train, "consistency": consistency,
            "launches": {kind: serve["launches"][kind] + train["launches"][kind] for kind in ("fwd", "dq", "dkv")}}


# The hub group: TinyLlama's widths (TINYLLAMA) at HUB_LAYERS of its 22 layers (cut to keep the whole script inside
# its 1,200 s) written as an HF checkpoint of two bf16 shards and an index (the layout
# Llama-2-7B is published in), the first shard the embedding and the first HUB_FIRST_SHARD_LAYERS layers
HUB_LAYERS = 4
HUB_FIRST_SHARD_LAYERS = 2
HUB_TRAIN_STEPS = 3
HUB_TRAIN_SHAPE = (8, 2048)  # batch x sequence: FLASH_MIN_SEQ, the train phase's shape
HUB_PROMPTS = (5, 37, 130, 300)
HUB_NEW = 16
# flax leaves of a scanned Llama: the embedding, the final norm, the head and 9 stacked [L, ...] leaves
HUB_LEAVES = 12


def hub_hf_state(torch, cfg, seed=21) -> dict:
    """TinyLlama's HF-named tensors in bf16 on the host, drawn on the card
    from a seeded generator at a trained model's scales (matrices
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2))."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, ff = cfg.hidden_size, cfg.intermediate_size
    hd = h // cfg.num_attention_heads
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h), "model.norm.weight": (h,),
              "lm_head.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (q, h), p + "self_attn.k_proj.weight": (kv, h),
                       p + "self_attn.v_proj.weight": (kv, h), p + "self_attn.o_proj.weight": (h, q),
                       p + "mlp.gate_proj.weight": (ff, h), p + "mlp.up_proj.weight": (ff, h),
                       p + "mlp.down_proj.weight": (h, ff), p + "input_layernorm.weight": (h,),
                       p + "post_attention_layernorm.weight": (h,)})
    state = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        x = x / shape[-1] ** 0.5 if len(shape) > 1 else 1.0 + 0.1 * x
        state[name] = x.to(torch.bfloat16).cpu()
    return state


def hub_write_shards(torch, state, directory) -> int:
    """``state`` as two shards and ``model.safetensors.index.json`` in
    ``directory`` with the port's ``save_file``; the bytes written."""
    from accelerate_tpu_torch.utils.safetensors_io import save_file

    def second(name):
        parts = name.split(".")
        return name in ("model.norm.weight", "lm_head.weight") or (
            parts[1] == "layers" and int(parts[2]) >= HUB_FIRST_SHARD_LAYERS)

    shards = {"model-00001-of-00002.safetensors": {n: t for n, t in state.items() if not second(n)},
              "model-00002-of-00002.safetensors": {n: t for n, t in state.items() if second(n)}}
    for fname, part in shards.items():
        save_file(part, directory / fname)
    total = sum(t.numel() * t.element_size() for t in state.values())
    weight_map = {n: fname for fname, part in shards.items() for n in part}
    (directory / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    return sum((directory / fname).stat().st_size for fname in shards)


def hub_load(torch, directory, cfg, dtype, nbytes) -> tuple:
    """``load_hf_llama`` of the shards onto the card: the model and its
    seconds, bytes and GB/s (the files were just written: a warm read)."""
    from accelerate_tpu_torch.models import load_hf_llama

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_hf_llama(str(directory), config=cfg, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(model.device.type == "cuda", f"hub: the model is on the card, not {model.device}")
    check(model.imported_weight_count == HUB_LEAVES,
          f"hub: imported_weight_count {model.imported_weight_count} == {HUB_LEAVES} (the scanned tree's leaves)")
    return model, {"seconds": seconds, "bytes": nbytes, "gb_per_s": nbytes / seconds / 1e9,
                   "dtype": dtype_name(dtype), "imported_weight_count": model.imported_weight_count}


def hub_load_breakdown(torch, directory, cfg, dtype) -> dict:
    """Seconds of each step ``load_hf_llama`` takes, run one by one: the
    shards read into host tensors, the flax tree built (q/k re-paired, the
    layers stacked), the seeded model built on the card, the merge (each
    leaf copied to the card, transposed back and cast there)."""
    from accelerate_tpu_torch.models import convert_hf_llama_state, create_llama_model, read_safetensors_state
    from accelerate_tpu_torch.models.hub import _merge_into

    out, t0 = {}, time.perf_counter()
    state = read_safetensors_state(str(directory))
    out["read_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    tree = convert_hf_llama_state(state, cfg.scan_layers, cfg.num_attention_heads, cfg.num_key_value_heads)
    out["convert_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    model = create_llama_model(cfg, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    out["create_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    _merge_into(model, tree)
    torch.cuda.synchronize()
    out["merge_s"] = time.perf_counter() - t0
    return out


def hub_check_weights(torch, model, state, cfg) -> dict:
    """On the card: layer 0's and the last layer's q/k projections equal the
    HF tensors with each head's rows re-paired from the half-split rope to
    the interleaved one (row 2j <- j, 2j + 1 <- j + D/2), bit for bit; the
    tensors loaded untouched (v, o and the MLP projections, both norms, the
    embedding) equal the written ones bit for bit."""
    hd = cfg.hidden_size // cfg.num_attention_heads
    perm = torch.empty(hd, dtype=torch.int64)
    perm[0::2] = torch.arange(hd // 2)
    perm[1::2] = torch.arange(hd // 2) + hd // 2
    params, checked = model.params, []
    for i in (0, cfg.num_hidden_layers - 1):
        for proj, heads in (("q_proj", cfg.num_attention_heads), ("k_proj", cfg.num_key_value_heads)):
            hf = state[f"model.layers.{i}.self_attn.{proj}.weight"].cuda()
            want = hf.view(heads, hd, -1)[:, perm.cuda()].reshape(hf.shape)
            check(torch.equal(params[f"layers.{i}.attn.{proj}.weight"], want),
                  f"hub: layer {i} {proj} == the HF tensor re-paired for the interleaved rope")
            check(not torch.equal(want, hf), f"hub: the re-pairing of layer {i} {proj} moves rows")
            checked.append(f"layers.{i}.attn.{proj}.weight (re-paired)")
        for port, hf in (("attn.v_proj.weight", "self_attn.v_proj.weight"),
                         ("attn.o_proj.weight", "self_attn.o_proj.weight"),
                         ("mlp.down_proj.weight", "mlp.down_proj.weight"),
                         ("input_norm.weight", "input_layernorm.weight"),
                         ("post_attn_norm.weight", "post_attention_layernorm.weight")):
            check(torch.equal(params[f"layers.{i}.{port}"], state[f"model.layers.{i}.{hf}"].cuda()),
                  f"hub: layers.{i}.{port} == the written tensor, bit for bit")
            checked.append(f"layers.{i}.{port}")
    for port, hf in (("embed_tokens.weight", "model.embed_tokens.weight"), ("final_norm.weight", "model.norm.weight"),
                     ("lm_head.weight", "lm_head.weight")):
        got = params[port]
        check(torch.equal(got, state[hf].cuda().to(got.dtype)), f"hub: {port} == the written tensor, bit for bit")
        checked.append(port)
    return {"bit_equal": checked}


def phase_hub(torch, smi) -> dict:
    """TinyLlama-1.1B (TINYLLAMA: 2048 hidden, HUB_LAYERS of 22 layers, 32/4 heads, 5632
    FFN, vocab 32,000, untied head) imported from an HF checkpoint written
    here from seeded tensors (bf16, two shards and an index) by
    ``load_hf_llama``: loaded in bf16 onto the card (seconds, GB/s, the
    re-paired q/k and the untouched tensors bit for bit), served by the
    paged engine (K4 == layers x decode steps; greedy tokens and logprobs held
    to the no-cache loop over the same model under SERVE_BF16_GAP and
    SERVE_LP_LIMIT), quantized to int4 and decoded by ``generate`` (K5 ==
    154 x forwards); then loaded again with f32 masters and fine-tuned
    HUB_TRAIN_STEPS steps at 8 x 2048 with bf16 compute through
    ``build_train_step(causal_lm_loss)`` (K1 == 2 x layers x steps with remat,
    K2 == K3 == layers x steps; losses finite). Each kernel's launches are
    counted from 0 in its sub-phase."""
    from accelerate_tpu_torch import (Accelerator, LlamaConfig, QuantizationConfig, ServingEngine, causal_lm_loss,
                                      load_and_quantize_model)
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    t_group = time.perf_counter()
    cfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": HUB_LAYERS})
    workdir = ckpt_workdir()
    try:
        t0 = time.perf_counter()
        state = hub_hf_state(torch, cfg)
        nbytes = hub_write_shards(torch, state, workdir)
        write_s = time.perf_counter() - t0
        # the loader's steps one by one first, in a process whose first model build and first read of the fresh
        # files this is; then the entry point, as a user calls it
        breakdown = hub_load_breakdown(torch, workdir, cfg, torch.bfloat16)
        free_memory(torch)
        model, load = hub_load(torch, workdir, cfg, torch.bfloat16, nbytes)
        load["breakdown_first"] = breakdown
        weights = hub_check_weights(torch, model, state, cfg)
        del state

        # serve: the paged engine, greedy; every decode step's attention through K4
        rng = np.random.default_rng(22)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in HUB_PROMPTS]
        ServingEngine(model, num_slots=4, prompt_buckets=(64, 512), paged_block_size=16, tick_block=8).generate_many(
            [np.arange(1, 9, dtype=np.int32)], max_new_tokens=4)  # warm-up: library handles, allocator
        eng = ServingEngine(model, num_slots=4, prompt_buckets=(64, 512), paged_block_size=16, tick_block=8)
        torch.cuda.synchronize()
        pa.launches = 0
        t0 = time.perf_counter()
        uids = [eng.submit(p, HUB_NEW) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        k4 = pa.launches
        check(k4 == cfg.num_hidden_layers * eng.decode_steps > 0,
              f"hub serve: K4 launches {k4} == {cfg.num_hidden_layers} x decode steps {eng.decode_steps}")
        served = [(p, eng.poll(uid)[len(p):], eng.logprobs(uid)) for uid, p in zip(uids, prompts)]
        check(all(len(t) == HUB_NEW and np.isfinite(lp).all() for _, t, lp in served),
              "hub serve: every request's tokens and finite logprobs")
        compared, near_ties, max_lp_err = greedy_against_reference(torch, model, served, gap_limit=SERVE_BF16_GAP)
        check(compared > 0 and max_lp_err < SERVE_LP_LIMIT,
              f"hub serve: {compared} tokens against the no-cache loop, logprob err {max_lp_err} < {SERVE_LP_LIMIT}")
        serve = {"requests": len(prompts), "prompt_lengths": list(HUB_PROMPTS), "new_tokens": HUB_NEW,
                 "wall_s": serve_s, "tokens_per_s": len(prompts) * HUB_NEW / serve_s,
                 "decode_steps": eng.decode_steps, "k4_launches": k4, "tokens_compared": compared,
                 "stopped_at_near_tie": near_ties, "max_logprob_err": max_lp_err}
        del eng

        # int4: every projection through K5 in generate
        t0 = time.perf_counter()
        qmodel = load_and_quantize_model(model, QuantizationConfig(method="int4", group_size=128))
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        del model
        free_memory(torch)
        int4 = {"quantize_s": quantize_s, **generate_run(torch, qmodel, "hub int4")}
        del qmodel
        free_memory(torch)

        # fine-tune: f32 masters loaded from the same shards, bf16 compute, remat; K1-K3 at 8 x 2048
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        acc = Accelerator(mixed_precision="bf16")
        tcfg = LlamaConfig(**{**TINYLLAMA, "num_hidden_layers": HUB_LAYERS}, remat=True)
        tmodel, train_load = hub_load(torch, workdir, tcfg, torch.float32, nbytes)
        tmodel = acc.prepare_model(tmodel)
        acc.prepare_optimizer(torch.optim.AdamW(tmodel.module.parameters(), lr=3e-4, weight_decay=0.01))
        step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, tmodel.apply_fn))
        b, s = HUB_TRAIN_SHAPE
        batches = token_batches(torch, HUB_TRAIN_STEPS, b, s, cfg.vocab_size, seed=23)
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        losses, times = [], []
        for i in range(HUB_TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = step({"input_ids": batches[i]})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launches = flash_counts()
        layers, n = cfg.num_hidden_layers, HUB_TRAIN_STEPS
        check(all(np.isfinite(losses)), f"hub train: losses finite: {losses}")
        check(launches == {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n},
              f"hub train: flash launches {launches} == K1 2 x {layers} x {n}, K2/K3 {layers} x {n}")
        train = {"batch": b, "seq": s, "steps": n, "losses": losses, "step_ms": times, "last_step_ms": times[-1],
                 "tokens_per_s_last": b * s / (times[-1] / 1e3), "launches": launches, "load": train_load,
                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del acc, tmodel, step, batches
        free_memory(torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    row = {"phase": "hub", "card": smi, "config": f"TinyLlama-1.1B widths, {HUB_LAYERS} layers, seeded HF checkpoint: "
           "two bf16 shards + index", "write_s": write_s, "load": load, "weights": weights, "serve": serve,
           "int4": int4, "train": train, "seconds": time.perf_counter() - t_group}
    emit(row)
    return {"k4": serve["k4_launches"], "k5": int4["int4_launches"], "flash": launches}


AOT_LENGTHS = (17, 33, 90, 129, 250, 300, 513, 700)  # auto-bucketing from the seed (32,): six prefill buckets
AOT_NEW = 16
AOT_ENGINE = dict(num_slots=8, prompt_buckets=(32,), paged_block_size=16, tick_block=8)
AOT_ROWS, AOT_BATCH, AOT_SEQ = 21, 8, 2048  # three batches: 8, 8, and a tail of 5 wrap-padded to 8
AOT_LIBRARIES = ("paged_attention", "flash_fwd_sm90", "flash_bwd_sm90")
# TinyLlama's widths at AOT_LAYERS of its 22 layers (cut to keep the whole script inside its 1,200 s)
AOT_LAYERS = 4
AOT_LLAMA = {**TINYLLAMA, "num_hidden_layers": AOT_LAYERS}


def aot_events(path) -> dict:
    """The compile_cache_* events of one child's program caches: the disk
    hits' deserialize ms and the misses' compile ms, summed, and the
    rejections."""
    from accelerate_tpu_torch.telemetry.eventlog import read_events

    events = read_events(str(path)) if Path(path).exists() else []
    hits = [e for e in events if e["name"] == "compile_cache_hit" and e.get("source") == "disk"]
    misses = [e for e in events if e["name"] == "compile_cache_miss"]
    return {"deserialize_ms": sum(e["deserialize_ms"] for e in hits), "compile_ms": sum(e["compile_ms"] for e in misses),
            "compile_ms_by_program": sorted((e["program"], e["compile_ms"]) for e in misses),
            "rejects": sorted((e["program"], e["reason"]) for e in events if e["name"] == "compile_cache_reject")}


def aot_serve(torch, store, log, check_reference, ready=None):
    """The paged engine over TinyLlama's widths at AOT_LAYERS layers in bf16 with
    auto-bucketing, its programs through a ProgramCache over the store:
    AOT_LENGTHS' requests, AOT_NEW new tokens each, greedy. ``ready()``
    runs after the model is built, before the first program."""
    from accelerate_tpu_torch import LlamaConfig, ServingEngine, create_llama_model
    from accelerate_tpu_torch.aot import ExecutableStore, ProgramCache
    from accelerate_tpu_torch.ops import paged_attention as pa

    cfg = LlamaConfig(**AOT_LLAMA)
    t0 = time.perf_counter()
    model = create_llama_model(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    if ready is not None:
        ready()
    pc = ProgramCache(store=ExecutableStore(os.path.join(store, "executables")), log=log, name="serving")
    eng = ServingEngine(model, program_cache=pc, auto_bucketing=True, **AOT_ENGINE)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in AOT_LENGTHS]
    pa.launches = 0
    t0 = time.perf_counter()
    uids = [eng.submit(p, AOT_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    k4 = pa.launches
    served = [(p, eng.poll(u)[len(p):], eng.logprobs(u)) for u, p in zip(uids, prompts)]
    check(all(len(t) == AOT_NEW and np.isfinite(lp).all() for _, t, lp in served),
          "aot serve: every request's tokens and finite logprobs")
    check(k4 == cfg.num_hidden_layers * eng.decode_steps > 0,
          f"aot serve: K4 launches {k4} == {cfg.num_hidden_layers} x decode steps {eng.decode_steps}")
    out = {"model_s": model_s, "serve_s": serve_s, "buckets": list(eng.bucketer.buckets),
           "programs": {n: w._cache_size() for n, w in eng._programs.items()}, "k4": k4,
           "decode_steps": eng.decode_steps, "tokens": [t.tolist() for _, t, _ in served],
           "logprobs": [lp.tolist() for _, _, lp in served], **pc.stats()}
    if check_reference:
        compared, near_ties, max_lp_err = greedy_against_reference(torch, model, served, gap_limit=SERVE_BF16_GAP)
        check(compared > 0 and max_lp_err < SERVE_LP_LIMIT,
              f"aot serve: {compared} tokens against the no-cache loop, logprob err {max_lp_err} < {SERVE_LP_LIMIT}")
        out.update(tokens_compared=compared, stopped_at_near_tie=near_ties, max_logprob_err=max_lp_err)
    del eng, model
    free_memory(torch)
    return out


def aot_train(torch, store, log, ready=None):
    """TinyLlama's widths at AOT_LAYERS layers, f32 masters, bf16 compute and remat,
    under CompileKwargs(cache_dir=store) with persistent_xla_cache off, fed
    by a loader with auto-bucketing: AOT_ROWS rows of AOT_SEQ tokens at
    batch AOT_BATCH, the tail wrap-padded to the batch; one step a batch."""
    from accelerate_tpu_torch import (Accelerator, CompileKwargs, DataLoaderConfiguration, LlamaConfig,
                                      causal_lm_loss, create_llama_model)

    rng = np.random.default_rng(29)
    ids = (rng.pareto(1.2, size=(AOT_ROWS, AOT_SEQ)) * 50).astype(np.int64) % TINYLLAMA["vocab_size"]
    acc = Accelerator(mixed_precision="bf16",
                      dataloader_config=DataLoaderConfiguration(auto_bucketing=True, even_batches=False),
                      kwargs_handlers=[CompileKwargs(cache_dir=store, persistent_xla_cache=False)])
    acc.program_cache.log = log
    t0 = time.perf_counter()
    model = acc.prepare_model(create_llama_model(LlamaConfig(**AOT_LLAMA, remat=True), seed=0, dtype=torch.float32))
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    if ready is not None:
        ready()
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=3e-4, weight_decay=0.01))
    loader = acc.prepare_data_loader([{"input_ids": row} for row in ids], batch_size=AOT_BATCH)
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    reset_flash_counts()
    losses, step_ms, shapes = [], [], []
    for batch in loader:
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        shapes.append(list(batch["input_ids"].shape))
    launches = flash_counts()
    n, layers = len(losses), AOT_LAYERS
    check(shapes == [[AOT_BATCH, AOT_SEQ]] * 3 and loader.remainder == AOT_ROWS % AOT_BATCH,
          f"aot train: three {AOT_BATCH}-row batches, the tail's {AOT_ROWS % AOT_BATCH} real rows kept in "
          f"remainder ({shapes}, {loader.remainder})")
    check(launches == {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n},
          f"aot train: flash launches {launches} == K1 2 x {layers} x {n}, K2/K3 {layers} x {n}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"aot train: losses finite and falling {losses}")
    out = {"model_s": model_s, "losses": losses, "step_ms": step_ms, "launches": launches,
           "bucketer": list(loader.bucketer.buckets), "signatures": step._cache_size(), **acc.program_cache.stats()}
    del acc, model, step
    free_memory(torch)
    return out


def aot_child(torch, role: str, store: str, out_path: str) -> int:
    """One process of the aot group (``--aot-child cold|warm|poison``),
    started by ``phase_aot`` with a fresh, empty kernel build directory.
    The cold one starts every library's nvcc at once (two threads: K4's,
    and K1-K3's two) while it builds its models, and each path's first
    program waits for its libraries; every process serves, all but the
    poisoned one train. Writes its counters to ``out_path``."""
    from accelerate_tpu_torch.kernels import build
    from accelerate_tpu_torch.telemetry.eventlog import EventLog

    t_start = time.perf_counter()
    serve_ready = train_ready = None
    if role == "cold":
        nvcc_threads = [threading.Thread(target=build.build_all, args=(names,))
                        for names in (AOT_LIBRARIES[:1], AOT_LIBRARIES[1:])]
        for t in nvcc_threads:
            t.start()
        serve_ready, train_ready = nvcc_threads[0].join, nvcc_threads[1].join
    log_path = Path(out_path).with_suffix(".events.jsonl")
    log = EventLog(str(log_path), rank=0, main_process_only=False)
    res = {"role": role, "build_dir": str(build.kernel_build_dir())}
    try:
        res["serve"] = aot_serve(torch, store, log, check_reference=role == "cold", ready=serve_ready)
        if role != "poison":
            res["train"] = aot_train(torch, store, log, ready=train_ready)
    finally:
        log.close()
    res.update(nvcc_builds=build.nvcc_builds, prebuilt_loads=build.prebuilt_loads,
               wall_s=time.perf_counter() - t_start, **aot_events(log_path))
    Path(out_path).write_text(json.dumps(res))
    return 0


def aot_poison(store: Path) -> dict:
    """Corrupt the bytes of K4's library entry in the store and rewrite the
    header of one serving prefill program's entry with a foreign backend
    descriptor."""
    from accelerate_tpu_torch.aot import ExecutableStore

    st = ExecutableStore(str(store / "executables"))
    entries = st.entries()
    lib = next(e for e in entries if e.get("kind") == "library" and e.get("library") == "paged_attention")
    prog = next(e for e in entries if e.get("kind") == "program" and e.get("name") == "prefill")
    path = Path(st._entry_path(lib["key"]))
    blob = bytearray(path.read_bytes())
    mid = len(blob) // 2  # inside the library's bytes: the header is a few hundred bytes at the front
    blob[mid:mid + 64] = bytes(b ^ 0xFF for b in blob[mid:mid + 64])
    path.write_bytes(bytes(blob))
    path = Path(st._entry_path(prog["key"]))
    magic, header, payload = path.read_bytes().split(b"\n", 2)
    head = json.loads(header)
    head["backend"] = {**head["backend"], "torch": "0.0.0+foreign", "device": "another card"}
    path.write_bytes(magic + b"\n" + json.dumps(head, sort_keys=True).encode() + b"\n" + payload)
    return {"library": lib["name"], "program": prog["key"][:16]}


def phase_aot(torch) -> dict:
    """Compile management on the card (``--only aot``): three processes on
    one store, each a subprocess of this script with its own fresh, empty
    kernel build directory under ``build/`` (``persistent_xla_cache`` off in
    every one, so a warm process's libraries can only come from the store's
    entries). ``aot_cold``: TinyLlama-1.1B's widths at AOT_LAYERS layers served by the
    paged engine with auto-bucketing from the seed bucket 32 (K4 == layers x
    decode steps, greedy tokens and logprobs held to the no-cache loop) and
    trained 3 steps at 8 x 2048 through ``build_train_step`` under
    ``CompileKwargs`` from a loader that wrap-pads the 5-row tail (K1 2 x
    layers x 3, K2 = K3 layers x 3); misses == the distinct programs, nvcc builds > 0.
    ``aot_warm``: the same in a new process: 0 builds, 0 misses, every
    program deserialized, the same tokens, bit-equal losses. ``aot_poison``:
    K4's library entry corrupted and one prefill program's header made
    foreign, then the serving path again: 2 rejections, K4 built once, the
    same tokens."""
    here = Path(__file__).resolve().parent
    (here / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="aot_smoke_", dir=here / "build"))
    store = work / "store"
    t_group = time.perf_counter()

    def child(role):
        env = {k: v for k, v in os.environ.items() if k != "ACCELERATE_COMPILE_CACHE_DIR"}
        env["ACCELERATE_TPU_TORCH_BUILD_DIR"] = str(work / f"cuda_{role}")
        out = work / f"{role}.json"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(here / "chip_smoke.py"), "--aot-child", role, "--aot-store",
                               str(store), "--aot-out", str(out)], cwd=here, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], file=sys.stderr)
            print(proc.stderr[-8000:], file=sys.stderr)
        check(proc.returncode == 0, f"aot_{role}: the child process exited {proc.returncode}")
        return {**json.loads(out.read_text()), "process_wall_s": wall}

    try:
        cold = child("cold")
        s, t = cold["serve"], cold["train"]
        programs = sum(s["programs"].values())
        check(s["misses"] == programs and s["deserialized"] == 0 and t["misses"] == t["signatures"] == 1,
              f"aot_cold: misses {s['misses']} + {t['misses']} == the distinct programs {programs} + 1")
        check(cold["nvcc_builds"] > 0, f"aot_cold: nvcc built the libraries ({cold['nvcc_builds']})")
        emit({"phase": "aot_cold", **{k: v for k, v in cold.items() if k not in ("serve", "train")},
              "serve": {k: v for k, v in s.items() if k not in ("tokens", "logprobs")}, "train": t})

        warm = child("warm")
        ws, wt = warm["serve"], warm["train"]
        check(warm["nvcc_builds"] == 0, f"aot_warm: no nvcc build ({warm['nvcc_builds']})")
        check(ws["misses"] == wt["misses"] == 0, f"aot_warm: no miss ({ws['misses']}, {wt['misses']})")
        check((ws["deserialized"], wt["deserialized"]) == (s["misses"], t["misses"]),
              f"aot_warm: deserialized {ws['deserialized']} + {wt['deserialized']} == cold's misses")
        check(ws["tokens"] == s["tokens"], "aot_warm: the cold process's tokens")
        check(wt["losses"] == t["losses"], f"aot_warm: losses bit-equal to cold's ({wt['losses']} vs {t['losses']})")
        emit({"phase": "aot_warm", **{k: v for k, v in warm.items() if k not in ("serve", "train")},
              "serve": {k: v for k, v in ws.items() if k not in ("tokens", "logprobs")}, "train": wt,
              "cold_wall_s": cold["wall_s"], "cold_process_wall_s": cold["process_wall_s"],
              "max_logprob_diff_to_cold": max(abs(a - b) for x, y in zip(ws["logprobs"], s["logprobs"])
                                              for a, b in zip(x, y))})

        poisoned = aot_poison(store)
        poison = child("poison")
        ps = poison["serve"]
        check(ps["rejected"] == 2 and len(poison["rejects"]) == 2,
              f"aot_poison: 2 rejections ({ps['rejected']}, {poison['rejects']})")
        check(poison["nvcc_builds"] == 1, f"aot_poison: K4's library built once ({poison['nvcc_builds']})")
        check(ps["tokens"] == s["tokens"], "aot_poison: the cold process's tokens")
        emit({"phase": "aot_poison", "poisoned": poisoned,
              **{k: v for k, v in poison.items() if k != "serve"},
              "serve": {k: v for k, v in ps.items() if k not in ("tokens", "logprobs")}})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "aot", "seconds": time.perf_counter() - t_group})
    return {"k4": s["k4"] + ws["k4"] + ps["k4"],
            "flash": {k: t["launches"][k] + wt["launches"][k] for k in ("fwd", "dq", "dkv")}}


LAUNCH_MICRO = (4, 2048)  # a microbatch; two of them (accumulation 2) are the train phase's 8 x 2048 step
LAUNCH_ACCUM = 2
LAUNCH_CRASH_RC = 17  # attempt 0's exit code after step 3: the crash the launcher restarts


def launch_child(torch, project_dir: str, out_dir: str) -> int:
    """One attempt of the ``launch`` group's training script, started by the
    port's launcher (``--launch-child``). Its ``Accelerator`` takes no
    precision or accumulation argument: bf16 comes from the launcher's
    YAML file and 2 from its command line, through the environment.
    TinyLlama-1.1B at all 22 layers, f32 masters, bf16 compute, remat,
    AdamW; microbatches of LAUNCH_MICRO. Attempt 0 (``ACCELERATE_RESTART_COUNT``
    0) trains steps 1-2, saves, trains step 3 and exits LAUNCH_CRASH_RC;
    attempt 1 auto-resumes with ``load_state()``, trains steps 3 and 4,
    then loads again and repeats step 3 (the repeat that
    ``continuation_verdict`` holds the resume to). Each attempt writes its
    record to ``out_dir/attempt_<n>.json``."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, ProjectConfiguration, causal_lm_loss, create_llama_model

    t_start = time.perf_counter()
    attempt = int(os.environ["ACCELERATE_RESTART_COUNT"])
    acc = Accelerator(project_config=ProjectConfiguration(project_dir=project_dir, automatic_checkpoint_naming=True))
    check(acc.mixed_precision == "bf16" and acc.gradient_accumulation_steps == LAUNCH_ACCUM,
          f"launch child: bf16 and accumulation {LAUNCH_ACCUM} from the launcher's environment "
          f"({acc.mixed_precision}, {acc.gradient_accumulation_steps})")
    cfg = LlamaConfig(**TINYLLAMA, remat=True)
    model = acc.prepare_model(create_llama_model(cfg, seed=0, dtype=torch.float32))
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=3e-4, weight_decay=0.01))
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    b, s = LAUNCH_MICRO
    micro = token_batches(torch, 4 * LAUNCH_ACCUM, b, s, cfg.vocab_size, seed=31)
    torch.cuda.synchronize()
    rec = {"attempt": attempt, "restart_count": os.environ["ACCELERATE_RESTART_COUNT"],
           "mixed_precision": acc.mixed_precision, "accumulation": acc.gradient_accumulation_steps,
           "params": sum(p.numel() for p in model.module.parameters()), "import_and_build_s":
           time.perf_counter() - t_start, "losses": {}, "step_s": {}, "load_s": []}

    def train(n: int) -> list:
        """Step ``n`` (from 1): its LAUNCH_ACCUM microbatch calls' losses."""
        t0 = time.perf_counter()
        losses = [float(step({"input_ids": micro[LAUNCH_ACCUM * (n - 1) + i]})) for i in range(LAUNCH_ACCUM)]
        torch.cuda.synchronize()
        rec["step_s"].setdefault(str(n), []).append(time.perf_counter() - t0)
        return losses

    def digest() -> dict:
        """Every parameter's f64 sum, on the host: the updated weights, small."""
        return {k: v.detach().double().sum().cpu() for k, v in model.module.state_dict().items()}

    def load():
        t0 = time.perf_counter()
        acc.load_state()
        torch.cuda.synchronize()
        rec["load_s"].append(time.perf_counter() - t0)

    reset_flash_counts()
    if attempt == 0:
        rec["start_step"] = 1
        for n in (1, 2):
            rec["losses"][str(n)] = train(n)
        t0 = time.perf_counter()
        rec["checkpoint_dir"] = acc.save_state()
        rec["save_s"] = time.perf_counter() - t0
        rec["checkpoint_bytes"] = dir_bytes(rec["checkpoint_dir"])
        rec["losses"]["3"] = train(3)
        rec["digest_3"] = {k: float(v) for k, v in digest().items()}
        rc = LAUNCH_CRASH_RC
    else:
        load()
        rec["start_step"] = acc.step // LAUNCH_ACCUM + 1
        rec["losses"]["3"] = train(3)
        rec["digest_3"] = {k: float(v) for k, v in digest().items()}
        rec["losses"]["4"] = train(4)
        load()
        rec["losses"]["3_repeat"] = train(3)
        rec["digest_3_repeat"] = {k: float(v) for k, v in digest().items()}
        rc = 0
    rec["launches"] = flash_counts()
    rec["microbatch_calls"] = sum(len(v) for v in rec["losses"].values())
    rec["wall_s"] = time.perf_counter() - t_start
    Path(out_dir, f"attempt_{attempt}.json").write_text(json.dumps(rec))
    return rc


def port_cli(argv: list) -> tuple:
    """``python -m accelerate_tpu_torch.commands.cli <argv>`` in this
    process: its exit code and what it, and any process it started,
    printed (file descriptor 1 is a temporary file meanwhile, so none of it
    reaches this script's output)."""
    from accelerate_tpu_torch.commands import cli

    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile("w+") as out:
        os.dup2(out.fileno(), 1)
        try:
            cli.main([str(a) for a in argv])
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        out.seek(0)
        return code, out.read()


def phase_launch(torch, smi) -> dict:
    """The launcher (``--only launch``). ``launch_train``: a YAML file
    written by the port's ``save_config`` (``mixed_precision: bf16``), then
    ``python -m accelerate_tpu_torch.commands.cli launch --config_file ...
    --gradient_accumulation_steps 2 --max_restarts 1 --monitor_interval 0
    chip_smoke.py --launch-child ...`` (:func:`launch_child`): two
    attempts, a crash after step 3 and the restart resuming at step 3 from
    the checkpoint, its step-3 losses and weights held to the unbroken
    attempt's by :func:`continuation_verdict`; K1 == 2 x 22 and K2 == K3 ==
    22 a microbatch call. The children's output is captured, never this
    script's stdout. ``launch_ckpt``: the operator commands on that run's
    checkpoint (about 13 GB: 4.4 GB of f32 masters, 8.8 GB of AdamW
    moments): ``checkpoints list`` / ``verify --format json`` (committed,
    every size and hash good), ``describe`` (world 1, 0 bytes moved),
    ``merge-weights --max_shard_size 2GB`` (several shards, every tensor
    bit-equal to the saved model's), ``estimate-memory`` on the merged
    directory (the model's parameter count; the fit column reads the
    card's memory); then the checkpoint is deleted. ``launch_env``:
    ``env`` prints the card's name and power limit, ``test`` (on the card)
    exits 0."""
    from accelerate_tpu_torch.commands.config import save_config
    from accelerate_tpu_torch.utils import safetensors_io

    here = Path(__file__).resolve().parent
    (here / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="launch_smoke_", dir=here / "build"))
    t_group = time.perf_counter()
    layers = TINYLLAMA["num_hidden_layers"]
    free_memory(torch)  # the card is the launched script's
    env = {**os.environ, "ACCELERATE_TPU_TORCH_HOME": str(work / "home")}
    try:
        cfg_file = save_config({"mixed_precision": "bf16"}, str(work / "launch.yaml"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "accelerate_tpu_torch.commands.cli", "launch", "--config_file", cfg_file,
             "--gradient_accumulation_steps", str(LAUNCH_ACCUM), "--max_restarts", "1", "--monitor_interval", "0",
             str(here / "chip_smoke.py"), "--launch-child", str(work / "run"), "--launch-out", str(work)],
            cwd=here, env=env, capture_output=True, text=True, timeout=900)
        launch_wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], file=sys.stderr)
            print(proc.stderr[-8000:], file=sys.stderr)
        check(proc.returncode == 0, f"launch_train: the launcher exited {proc.returncode}")
        records = sorted(work.glob("attempt_*.json"))
        check([p.name for p in records] == ["attempt_0.json", "attempt_1.json"],
              f"launch_train: exactly two attempts ({[p.name for p in records]})")
        a0, a1 = (json.loads(p.read_text()) for p in records)
        check(f"run failed (rc={LAUNCH_CRASH_RC}); restart 1/1" in proc.stderr,
              "launch_train: the launcher restarted the crashed attempt once")
        check((a0["restart_count"], a1["restart_count"]) == ("0", "1"), "launch_train: ACCELERATE_RESTART_COUNT 0, 1")
        check(a1["start_step"] == 3, f"launch_train: attempt 1 resumed at step 3 ({a1['start_step']})")
        for a in (a0, a1):
            n = a["microbatch_calls"]
            check(a["launches"] == {"fwd": 2 * layers * n, "dq": layers * n, "dkv": layers * n},
                  f"launch_train: attempt {a['attempt']}'s flash launches {a['launches']} == K1 2 x {layers} x {n}, "
                  f"K2/K3 {layers} x {n}")
            check(all(np.isfinite(x) for v in a["losses"].values() for x in v),
                  f"launch_train: finite losses {a['losses']}")

        def run(losses, dig):
            return losses, {k: torch.tensor(v, dtype=torch.float64) for k, v in dig.items()}

        verdict = continuation_verdict(run(a0["losses"]["3"], a0["digest_3"]), run(a1["losses"]["3"], a1["digest_3"]),
                                       run(a1["losses"]["3_repeat"], a1["digest_3_repeat"]), "launch_train")
        train_row = {"phase": "launch_train", "card": smi, "config": "TinyLlama-1.1B, 22 layers, f32 masters + bf16 "
                     "compute (from the launcher's YAML), remat, accumulation 2 (from its command line) over "
                     "microbatches of 4 x 2048, AdamW(3e-4, weight decay 0.01), seeded",
                     "launcher_wall_s": launch_wall_s, "attempts": 2, "params": a0["params"],
                     "checkpoint_bytes": a0["checkpoint_bytes"], "save_s": a0["save_s"],
                     "save_gb_per_s": a0["checkpoint_bytes"] / a0["save_s"] / 1e9, "load_s": a1["load_s"],
                     "load_gb_per_s": a0["checkpoint_bytes"] / min(a1["load_s"]) / 1e9,
                     "import_and_build_s": [a0["import_and_build_s"], a1["import_and_build_s"]],
                     "attempt_wall_s": [a0["wall_s"], a1["wall_s"]], "step_s": [a0["step_s"], a1["step_s"]],
                     "start_step": [a0["start_step"], a1["start_step"]], "losses": [a0["losses"], a1["losses"]],
                     "microbatch_calls": [a0["microbatch_calls"], a1["microbatch_calls"]],
                     "launches": [a0["launches"], a1["launches"]], **verdict}
        emit(train_row)

        # the operator commands on that checkpoint
        t0 = time.perf_counter()
        base = work / "run" / "checkpoints"
        code, out = port_cli(["checkpoints", "list", base, "--format", "json"])
        listed = json.loads(out)["checkpoints"]
        check(code == 0 and [(r["name"], r["valid"]) for r in listed] == [("checkpoint_0", True)],
              f"launch_ckpt: list shows one committed, valid checkpoint ({listed})")
        code, out = port_cli(["checkpoints", "verify", base, "--format", "json"])
        verified = json.loads(out)
        check(code == 0 and verified["ok"] and not verified["results"][0]["problems"],
              f"launch_ckpt: verify finds every size and hash good ({verified})")
        code, out = port_cli(["checkpoints", "describe", base, "--format", "json"])
        described = json.loads(out)
        check(code == 0 and described["saved_topology"]["process_count"] == 1
              and described["compatibility"] == "identical" and described["reshard"]["total_bytes"] == 0,
              f"launch_ckpt: describe: world 1, identical, 0 bytes moved ({described['reshard']})")
        merged = work / "merged"
        code, _ = port_cli(["merge-weights", base / "checkpoint_0", merged, "--max_shard_size", "2GB"])
        index = json.loads((merged / "model.safetensors.index.json").read_text())
        shards = sorted(set(index["weight_map"].values()))
        saved = safetensors_io.load_file(str(base / "checkpoint_0" / "model" / "model.safetensors"))
        unequal = []
        for name in shards:
            for k, v in safetensors_io.load_file(str(merged / name)).items():
                if not torch.equal(v, saved.pop(k)):
                    unequal.append(k)
        check(code == 0 and len(shards) > 1 and not saved and not unequal,
              f"launch_ckpt: {len(shards)} shards, every tensor bit-equal to the saved model's "
              f"({len(saved)} missing, {unequal[:3]} differ)")
        code, out = port_cli(["estimate-memory", merged])
        card_gib = torch.cuda.get_device_properties(0).total_memory / 1024**3
        check(code == 0 and f"Memory estimate for {a0['params']:,} parameters" in out
              and f"fits/device against {card_gib:.2f} GiB per device" in out,
              f"launch_ckpt: estimate-memory counts {a0['params']:,} parameters against {card_gib:.2f} GiB: {out}")
        emit({"phase": "launch_ckpt", "checkpoint_bytes": a0["checkpoint_bytes"], "listed": listed,
              "verified_ok": verified["ok"], "describe": {k: described[k] for k in ("compatibility", "reshard")},
              "merged_shards": len(shards), "merged_params": a0["params"], "fit_gib": card_gib,
              "seconds": time.perf_counter() - t0})
        shutil.rmtree(work / "run", ignore_errors=True)
        shutil.rmtree(merged, ignore_errors=True)

        t0 = time.perf_counter()
        code, env_out = port_cli(["env"])
        check(code == 0 and smi.splitlines()[0] in env_out,
              f"launch_env: env prints the card's name and power limit {smi}")
        code, test_out = port_cli(["test"])  # the launched script's output is captured with the command's
        if code != 0:
            print(test_out[-4000:], file=sys.stderr)
        check(code == 0 and "ALL CHECKS PASSED" in test_out and "device=cuda" in test_out,
              f"launch_env: test on the card exits 0 ({code})")
        emit({"phase": "launch_env", "test_wall_s": time.perf_counter() - t0,
              "test_lines": [ln for ln in test_out.splitlines() if ln.endswith("OK")],
              "group_seconds": time.perf_counter() - t_group})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"flash": {k: a0["launches"][k] + a1["launches"][k] for k in ("fwd", "dq", "dkv")}}


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
    if "--aot-child" in sys.argv:  # one process of the aot group, started by phase_aot
        def arg(name):
            return sys.argv[sys.argv.index(name) + 1]

        return aot_child(torch, arg("--aot-child"), arg("--aot-store"), arg("--aot-out"))
    if "--launch-child" in sys.argv:  # one attempt of the launch group's script, started by the port's launcher
        return launch_child(torch, sys.argv[sys.argv.index("--launch-child") + 1],
                            sys.argv[sys.argv.index("--launch-out") + 1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    # `--only paged,flash,int4,reference,analysis,serve,consistency,train,bert,ckpt,imperative,fp8,resnet,families,sched,
    # dense,moe,gpt,fleet,proc,s2s,vision,diffusion,hub,aot,launch`
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
    if not only or "moe" in only:
        moe = phase_moe(torch)
    if not only or "gpt" in only:
        gpt = phase_gpt(torch, 44 if only else NEOX_LAYERS)  # the group alone serves GPT-NeoX-20B at full depth
    if not only or "fleet" in only:
        fleet = phase_fleet(torch)
    if not only or "proc" in only:
        proc = phase_proc(torch, threaded=bool(only))  # alone, the group times the threaded drain too
    if not only or "s2s" in only:
        phase_s2s(torch)
    if not only or "vision" in only:
        phase_vision(torch)
    if not only or "diffusion" in only:
        diffusion = phase_diffusion(torch)
    if not only or "hub" in only:
        hub = phase_hub(torch, smi)
    if not only or "aot" in only:
        aot = phase_aot(torch)
    if not only or "launch" in only:
        launch = phase_launch(torch, smi)
    if only:
        emit({"partial": sorted(only)})
        return 0

    main_case = kernel["bf16"]  # the serving slice's dtype and shapes
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/pallas_paged_attention.py:40",
        # the serving paths: the bf16 model's, the int4 model's, LlamaConfig.tiny()'s (head dim 16),
        # Gemma-2B's (head dim 256), the banded families' 2-layer cuts, Mistral-7B-v0.1's three phases,
        # GPT-NeoX-20B's (head dim 96) and GPT-2's (head dim 64) serves and their 2-layer cuts, the fleet's
        # paged replicas and the process fleet's paged workers (TinyLlama, head dim 64), the HF-imported TinyLlama,
        # the aot group's three processes (cold, warm, poisoned store)
        "launches": serve["kernel_launches"] + quant_serve["kernel_launches"] + tiny["kernel_launches"]
        + gemma_serve["kernel_launches"]
        + sum(r["paged_serve"]["kernel_launches"] for r in families["families"] if r["family"] in BANDED_SERVE)
        + sum(r["kernel_launches"] for r in sched.values()) + gpt["k4_launches"] + fleet["k4_launches"]
        + proc["k4_launches"] + hub["k4"] + aot["k4"],
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
            # Gemma3-1B's (D 256), Qwen3-30B-A3B's (D 128); SD v1.5's UNet (D 40): text_to_image's K1 and
            # the UNet train step's K1-K3; the HF-imported TinyLlama's fine-tune; the aot group's cold and warm
            # trainers; the launched script's two attempts
            "launches": train["launches"][kind] + gemma_train["launches"][kind] + gemma3_train["launches"][kind]
            + sum(fp8_group["train"][recipe]["launches"][kind] for recipe in ("dynamic", "delayed"))
            + moe["train"]["launches"][kind] + diffusion["launches"][kind] + hub["flash"][kind]
            + aot["flash"][kind] + launch["flash"][kind],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # K1: scaled_dot_product_attention's forward; K2, K3: its backward, one call for dq, dk and dv
            "library_ms": flash["library_fwd_ms"] if kind == "fwd" else flash["library_bwd_ms"],
        })
    kernels.append({
        "name": "int4_matmul", "route": "cuda", "source": "accelerate_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "accelerate_tpu/ops/pallas_qmatmul.py:41", "case": INT4_MAIN_CASE,
        # the main path's launches: the int4 model served, then decoded by generate and per_token_latency; the
        # HF-imported TinyLlama quantized and decoded by generate
        "launches": quant_serve["int4_launches"] + quant_generate["int4"]["int4_launches"] + hub["k5"],
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
