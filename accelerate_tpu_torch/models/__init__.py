from .bert import BertConfig, bert_classification_loss, create_bert_model
from .clip import CLIPConfig, CLIPModel, clip_contrastive_loss, create_clip_model
from .convert import (
    bert_params_from_jax,
    clip_params_from_jax,
    gpt2_params_from_jax,
    gptneox_params_from_jax,
    llama_params_from_jax,
    mixtral_params_from_jax,
    resnet_params_from_jax,
    t5_params_from_jax,
    unet_params_from_jax,
    vae_params_from_jax,
    vit_params_from_jax,
    whisper_params_from_jax,
)
from .gemma import GemmaConfig, create_gemma_model
from .gemma2 import Gemma2Config, create_gemma2_model
from .gemma3 import Gemma3Config, create_gemma3_model
from .gpt2 import GPT2Config, GPT2Model, create_gpt2_model
from .gptneox import GPTNeoXConfig, GPTNeoXModel, create_gptneox_model
from .llama import LlamaConfig, causal_lm_loss, causal_lm_loss_state, create_llama_model, next_token_cross_entropy
from .mistral import MistralConfig, create_mistral_model
from .mixtral import MixtralConfig, MixtralModel, create_mixtral_model, mixtral_lm_loss
from .olmo2 import Olmo2Config, create_olmo2_model
from .phi3 import Phi3Config, create_phi3_model
from .qwen2 import Qwen2Config, create_qwen2_model
from .qwen3 import Qwen3Config, create_qwen3_model
from .qwen3_moe import Qwen3MoeConfig, Qwen3MoeModel, create_qwen3_moe_model, qwen3_moe_lm_loss
from .resnet import ResNetConfig, create_resnet_model, resnet_classification_loss
from .t5 import T5Config, T5Model, create_t5_model, seq2seq_lm_loss
from .unet import UNet2D, UNetConfig, create_unet_model
from .vae import VAE, VAEConfig, create_vae_model, vae_loss
from .vit import ViT, ViTConfig, create_vit_model, vit_classification_loss
from .whisper import WhisperConfig, WhisperModel, create_whisper_model

__all__ = [
    "BertConfig",
    "CLIPConfig",
    "CLIPModel",
    "GPT2Config",
    "GPT2Model",
    "GPTNeoXConfig",
    "GPTNeoXModel",
    "Gemma2Config",
    "Gemma3Config",
    "GemmaConfig",
    "LlamaConfig",
    "MistralConfig",
    "MixtralConfig",
    "MixtralModel",
    "Olmo2Config",
    "Phi3Config",
    "Qwen2Config",
    "Qwen3Config",
    "Qwen3MoeConfig",
    "Qwen3MoeModel",
    "ResNetConfig",
    "T5Config",
    "T5Model",
    "UNet2D",
    "UNetConfig",
    "VAE",
    "VAEConfig",
    "ViT",
    "ViTConfig",
    "WhisperConfig",
    "WhisperModel",
    "bert_classification_loss",
    "bert_params_from_jax",
    "causal_lm_loss",
    "causal_lm_loss_state",
    "clip_contrastive_loss",
    "clip_params_from_jax",
    "create_bert_model",
    "create_clip_model",
    "create_gemma2_model",
    "create_gemma3_model",
    "create_gemma_model",
    "create_gpt2_model",
    "create_gptneox_model",
    "create_llama_model",
    "create_mistral_model",
    "create_mixtral_model",
    "create_olmo2_model",
    "create_phi3_model",
    "create_qwen2_model",
    "create_qwen3_model",
    "create_qwen3_moe_model",
    "create_resnet_model",
    "create_t5_model",
    "create_unet_model",
    "create_vae_model",
    "create_vit_model",
    "create_whisper_model",
    "gpt2_params_from_jax",
    "gptneox_params_from_jax",
    "llama_params_from_jax",
    "mixtral_lm_loss",
    "mixtral_params_from_jax",
    "next_token_cross_entropy",
    "qwen3_moe_lm_loss",
    "resnet_classification_loss",
    "resnet_params_from_jax",
    "seq2seq_lm_loss",
    "t5_params_from_jax",
    "unet_params_from_jax",
    "vae_loss",
    "vae_params_from_jax",
    "vit_classification_loss",
    "vit_params_from_jax",
    "whisper_params_from_jax",
]
