from .convert import llama_params_from_jax
from .llama import LlamaConfig, causal_lm_loss, create_llama_model, next_token_cross_entropy

__all__ = ["LlamaConfig", "causal_lm_loss", "create_llama_model", "llama_params_from_jax", "next_token_cross_entropy"]
