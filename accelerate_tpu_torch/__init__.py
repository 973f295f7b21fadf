"""PyTorch and CUDA port of accelerate_tpu, for an NVIDIA H100.

The JAX package ``accelerate_tpu`` beside it is the reference. This
package imports nothing of it (nor of jax). Its slices so far:

* serving: paged continuous batching of a Llama (``ServingEngine``), whose
  decode attention is a hand-written CUDA kernel (``csrc/paged_attention.cu``);
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
  kernels too (``csrc/kernel_fixtures.cu``).

Entry points run on ``cuda`` unless the CPU is asked for (``device="cpu"``,
``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .data_loader import prepare_data_loader, skip_first_batches
from .generation import generate, per_token_latency
from .models import (
    BertConfig,
    LlamaConfig,
    bert_classification_loss,
    bert_params_from_jax,
    causal_lm_loss,
    create_bert_model,
    create_llama_model,
    llama_params_from_jax,
)
from .ops.qdense import QuantDense
from .serving import ServingEngine
from .utils import (
    DataLoaderConfiguration,
    MixedPrecisionPolicy,
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
    "DataLoaderConfiguration",
    "LlamaConfig",
    "MixedPrecisionPolicy",
    "QuantDense",
    "QuantizationConfig",
    "ServingEngine",
    "bert_classification_loss",
    "bert_params_from_jax",
    "broadcast",
    "broadcast_object_list",
    "causal_lm_loss",
    "concatenate",
    "convert_outputs_to_fp32",
    "convert_to_fp32",
    "create_bert_model",
    "create_llama_model",
    "find_batch_size",
    "gather",
    "gather_object",
    "generate",
    "llama_params_from_jax",
    "load_and_quantize_model",
    "pad_across_processes",
    "per_token_latency",
    "prepare_data_loader",
    "reduce",
    "send_to_device",
    "set_seed",
    "skip_first_batches",
    "slice_tensors",
]
