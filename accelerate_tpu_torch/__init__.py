"""PyTorch and CUDA port of accelerate_tpu, for an NVIDIA H100.

The JAX package ``accelerate_tpu`` beside it is the reference. This
package imports nothing of it (nor of jax). Its slices so far:

* serving: continuous batching of a Llama or one of its families
  (``ServingEngine``) on a paged KV cache, whose decode attention is a
  hand-written CUDA kernel (``csrc/paged_attention.cu``), or on the dense
  layout (the default: per-slot frontiers in one cache, the einsum
  attention as in the JAX package; it serves Gemma2's softcaps), with
  speculative decoding from a draft model (``draft_model=``,
  ``speculative_generate``) and ``beam_search``;
* training on one card: ``Accelerator`` -> ``prepare_model`` /
  ``prepare_optimizer`` -> ``build_train_step(loss_fn)``, with f32 master
  weights, bf16/fp16 compute, gradient accumulation, clipping, fp16 loss
  scaling and per-layer remat; at long sequences its attention is the
  hand-written CUDA flash kernels, forward and backward
  (``csrc/flash_attention.cu``);
* weight-only quantized decode: ``load_and_quantize_model`` turns a Llama's
  projections into ``QuantDense`` layers (int8, w8a8, int4, nf4), served by
  ``ServingEngine`` or ``generate``; the int4 product is a hand-written
  fused dequantize-matmul kernel (``csrc/int4_matmul.cu``);
* fine-tuning BERT for sequence classification, the JAX package's
  flagship: ``prepare(model, optimizer, loader)`` with the data loader
  (:mod:`.data_loader`: seeded shuffle, padded last batch, batches placed
  on the card ahead of use), ``build_train_step`` / ``build_eval_step``
  and ``gather_for_metrics``; its attention is the einsum path with a
  padding mask (no kernel of the JAX package runs there either);
* the kernel check: ``Accelerator.kernel_check`` and
  ``python -m accelerate_tpu_torch.commands.kernelcheck`` trace a function
  on ``meta`` tensors and check every CUDA launch its kernel wrappers
  would make with the TPU1001-1006 rules, re-derived for Hopper
  (:mod:`.analysis`); its seeded-defect fixtures run as hand-written
  kernels too (``csrc/kernel_fixtures.cu``);
* checkpointing and fault tolerance: ``Accelerator.save_state`` /
  ``load_state`` (:mod:`.checkpointing`) with an atomic commit, integrity
  manifests, auto-resume past corrupt checkpoints, async saves and a
  preemption handler (:mod:`.ft`, ``FaultToleranceKwargs``), resuming a
  run bit for bit; ``save_model`` / ``load_model`` export safetensors;
* the imperative training loop (``with accelerator.accumulate(model):
  accelerator.backward(loss_fn, batch); optimizer.step();
  optimizer.zero_grad()``), bit-equal to ``build_train_step``, and mutable
  model state (``build_train_step(has_state=True)``, ``Model.state``):
  ResNet-50 v1.5 with BatchNorm running statistics, the CV example's
  model, its convolutions cuDNN's (no kernel of the JAX package runs
  there either);
* fp8 mixed precision (``mixed_precision="fp8"``, :mod:`.ops.fp8`): every
  dense layer's product in e4m3 with f32 accumulation and e5m2 gradients,
  ``torch._scaled_mm`` on the card; the dynamic recipe, or the delayed one
  (``Fp8RecipeKwargs``) whose amax histories are ``Model.state``;
* the run's telemetry and trackers: ``Accelerator(log_with=...)`` /
  ``init_trackers`` / ``log`` (:mod:`.tracking`), and
  ``accelerator.telemetry`` (:mod:`.telemetry`: the JSONL event log, the
  step timeline, the recompile watchdog, MFU, device memory, the
  non-finite watchdog; ``TelemetryKwargs``);
* the MoE and GPT decoder families (:mod:`.models`: Mixtral and
  Qwen3-MoE over :mod:`.ops.moe`'s top-k routing with a fixed expert
  capacity, trained with ``mixtral_lm_loss``'s router aux term; GPT-2 and
  GPT-NeoX, served by the same ``ServingEngine`` and ``generate``);
* the encoder-decoder families (:mod:`.models`: T5 and Whisper), served
  by ``generate_seq2seq`` (the encoder once, its output and every layer's
  cross-attention K/V kept in the cache) and trained with
  ``seq2seq_lm_loss``;
* the vision and diffusion families (:mod:`.models`: ViT, CLIP, UNet2D
  and the VAE; :mod:`.diffusion`): ``text_to_image`` (CLIP's text tower,
  the UNet sampled by DDIM or DDPM under classifier-free guidance, the
  VAE's decoder), ViT and CLIP trained with ``vit_classification_loss``
  and ``clip_contrastive_loss``, the UNet with ``diffusion_loss`` or
  ``latent_diffusion_loss``; at Stable Diffusion's widths the 64 x 64
  level's attention (head dim 40) runs on the flash kernels.

* the launcher and the rest of the command line: ``python -m
  accelerate_tpu_torch.commands.cli launch [--cpu] script.py`` starts a
  script with the launcher's environment (mixed precision, gradient
  accumulation, restarts with ``ACCELERATE_RESTART_COUNT``), and
  ``config``, ``env``, ``test``, ``estimate-memory``, ``merge-weights``,
  ``migrate``, ``checkpoints`` and ``tpu-config`` as in the JAX package;
  ``notebook_launcher`` / ``debug_launcher`` (:mod:`.launchers`).

Entry points run on ``cuda`` unless the CPU is asked for (``device="cpu"``,
``Accelerator(cpu=True)``, the launcher's ``--cpu``).
"""

__version__ = "0.1.0"

from .accelerator import Accelerator
from .checkpointing import load_model, save_model
from .data_loader import prepare_data_loader, skip_first_batches
from .diffusion import text_to_image
from .ft import CheckpointManager
from .generation import beam_search, generate, generate_seq2seq, per_token_latency
from .launchers import debug_launcher, notebook_launcher
from .models import (
    BertConfig,
    LlamaConfig,
    ResNetConfig,
    bert_classification_loss,
    bert_params_from_jax,
    causal_lm_loss,
    causal_lm_loss_state,
    create_bert_model,
    create_llama_model,
    create_resnet_model,
    llama_params_from_jax,
    resnet_classification_loss,
    resnet_params_from_jax,
)
from .ops.qdense import QuantDense
from .serving import ServingEngine
from .speculative import speculative_generate
from .utils import (
    CompileKwargs,
    DataLoaderConfiguration,
    FaultToleranceKwargs,
    Fp8RecipeKwargs,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProfileKwargs,
    ProjectConfiguration,
    TelemetryKwargs,
    broadcast,
    broadcast_object_list,
    concatenate,
    convert_outputs_to_fp32,
    convert_to_fp32,
    find_batch_size,
    gather,
    gather_object,
    pad_across_processes,
    reduce,
    send_to_device,
    slice_tensors,
)
from .utils.quantization import QuantizationConfig, load_and_quantize_model
from .utils.random import set_seed

__all__ = [
    "Accelerator",
    "BertConfig",
    "CheckpointManager",
    "CompileKwargs",
    "DataLoaderConfiguration",
    "FaultToleranceKwargs",
    "Fp8RecipeKwargs",
    "GradientAccumulationPlugin",
    "LlamaConfig",
    "MixedPrecisionPolicy",
    "ProfileKwargs",
    "ProjectConfiguration",
    "QuantDense",
    "QuantizationConfig",
    "ResNetConfig",
    "ServingEngine",
    "TelemetryKwargs",
    "beam_search",
    "bert_classification_loss",
    "bert_params_from_jax",
    "broadcast",
    "broadcast_object_list",
    "causal_lm_loss",
    "causal_lm_loss_state",
    "concatenate",
    "convert_outputs_to_fp32",
    "convert_to_fp32",
    "create_bert_model",
    "create_llama_model",
    "create_resnet_model",
    "debug_launcher",
    "find_batch_size",
    "gather",
    "gather_object",
    "generate",
    "generate_seq2seq",
    "llama_params_from_jax",
    "load_and_quantize_model",
    "load_model",
    "notebook_launcher",
    "pad_across_processes",
    "per_token_latency",
    "prepare_data_loader",
    "reduce",
    "resnet_classification_loss",
    "resnet_params_from_jax",
    "save_model",
    "send_to_device",
    "set_seed",
    "skip_first_batches",
    "slice_tensors",
    "speculative_generate",
    "text_to_image",
]
