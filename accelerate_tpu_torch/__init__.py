"""PyTorch and CUDA port of accelerate_tpu, for an NVIDIA H100.

The JAX package ``accelerate_tpu`` beside it is the reference. This
package imports nothing of it (nor of jax): its first slice is paged
continuous-batching serving of a Llama, whose decode attention is a
hand-written CUDA kernel (``csrc/paged_attention.cu``). Entry points run
on ``cuda`` unless ``device="cpu"`` is passed.
"""

from .models import LlamaConfig, create_llama_model, llama_params_from_jax
from .serving import ServingEngine

__all__ = ["LlamaConfig", "ServingEngine", "create_llama_model", "llama_params_from_jax"]
