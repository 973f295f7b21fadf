from .bert import BertConfig, bert_classification_loss, create_bert_model
from .convert import bert_params_from_jax, llama_params_from_jax, resnet_params_from_jax
from .gemma import GemmaConfig, create_gemma_model
from .gemma2 import Gemma2Config, create_gemma2_model
from .gemma3 import Gemma3Config, create_gemma3_model
from .llama import LlamaConfig, causal_lm_loss, causal_lm_loss_state, create_llama_model, next_token_cross_entropy
from .mistral import MistralConfig, create_mistral_model
from .olmo2 import Olmo2Config, create_olmo2_model
from .phi3 import Phi3Config, create_phi3_model
from .qwen2 import Qwen2Config, create_qwen2_model
from .qwen3 import Qwen3Config, create_qwen3_model
from .resnet import ResNetConfig, create_resnet_model, resnet_classification_loss

__all__ = [
    "BertConfig",
    "Gemma2Config",
    "Gemma3Config",
    "GemmaConfig",
    "LlamaConfig",
    "MistralConfig",
    "Olmo2Config",
    "Phi3Config",
    "Qwen2Config",
    "Qwen3Config",
    "ResNetConfig",
    "bert_classification_loss",
    "bert_params_from_jax",
    "causal_lm_loss",
    "causal_lm_loss_state",
    "create_bert_model",
    "create_gemma2_model",
    "create_gemma3_model",
    "create_gemma_model",
    "create_llama_model",
    "create_mistral_model",
    "create_olmo2_model",
    "create_phi3_model",
    "create_qwen2_model",
    "create_qwen3_model",
    "create_resnet_model",
    "llama_params_from_jax",
    "next_token_cross_entropy",
    "resnet_classification_loss",
    "resnet_params_from_jax",
]
