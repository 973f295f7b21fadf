from .convert import llama_params_from_jax
from .llama import LlamaConfig, create_llama_model

__all__ = ["LlamaConfig", "create_llama_model", "llama_params_from_jax"]
