from .bert import BertConfig, bert_classification_loss, create_bert_model
from .convert import bert_params_from_jax, llama_params_from_jax, resnet_params_from_jax
from .llama import LlamaConfig, causal_lm_loss, create_llama_model, next_token_cross_entropy
from .resnet import ResNetConfig, create_resnet_model, resnet_classification_loss

__all__ = [
    "BertConfig",
    "LlamaConfig",
    "ResNetConfig",
    "bert_classification_loss",
    "bert_params_from_jax",
    "causal_lm_loss",
    "create_bert_model",
    "create_llama_model",
    "create_resnet_model",
    "llama_params_from_jax",
    "next_token_cross_entropy",
    "resnet_classification_loss",
    "resnet_params_from_jax",
]
