from .bert import BertConfig, bert_classification_loss, create_bert_model
from .convert import bert_params_from_jax, llama_params_from_jax
from .llama import LlamaConfig, causal_lm_loss, create_llama_model, next_token_cross_entropy

__all__ = [
    "BertConfig",
    "LlamaConfig",
    "bert_classification_loss",
    "bert_params_from_jax",
    "causal_lm_loss",
    "create_bert_model",
    "create_llama_model",
    "llama_params_from_jax",
    "next_token_cross_entropy",
]
