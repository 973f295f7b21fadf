"""CLIP dual encoder: a ViT vision tower, a causal text tower, projection
heads, a learned logit scale and the contrastive loss.

Counterpart of :mod:`accelerate_tpu.models.clip`, with its arithmetic:

* the vision tower: a bias-free strided patch convolution on the NHWC
  pixels, ``class_embedding`` in front, ``pos_embed``, ``pre_norm``, the
  blocks, ``post_norm`` on the class token, ``visual_projection``;
* the text tower: ``token_embed`` plus ``pos_embed``, causal blocks,
  ``final_norm``, pooled at the EOS position, ``text_projection``. A
  config with ``eos_token_id == 2`` (the legacy OpenAI configs, whose real
  end-of-text id is the vocabulary's highest) pools at ``argmax(input_ids)``;
  any other at the first ``eos_token_id``;
* both embeddings L2-normalised; ``logit_scale`` an f32 scalar;
* every LayerNorm outputs the stream's dtype (statistics in f32), every
  dense layer is a plain ``nn.Linear`` computing in the stream's dtype (the
  reference's ``nn.Dense`` here takes no policy ``dot_general``), and the
  activation is ``quick_gelu``, ``x * sigmoid(1.702 x)``.

``forward(pixel_values=None, input_ids=None, output_hidden=False)``
returns ``(image_embeds, text_embeds, logit_scale)``, either tower may be
skipped (None), and ``output_hidden`` appends the text tower's per-token
states ``[B, T, D]``, which ``model.encode_text(params, ids)`` returns:
what latent diffusion's cross-attention conditions on. Module names are the
flax ones with ``/`` read as a submodule (``vision.block_0``), and a
``.../embedding`` parameter as the parameter itself (``vision.pos_embed``).
The towers' lengths (257 and 77 positions at ViT-L/14) stay under
``FLASH_MIN_SEQ``: the einsum path, as in the JAX package.
``CLIP_SHARDING_RULES`` waits for the mesh (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..utils.environment import resolve_device
from .gpt2 import LayerNorm
from .whisper import _dense


@dataclasses.dataclass
class CLIPConfig:
    """A copy of :class:`accelerate_tpu.models.clip.CLIPConfig` (same fields
    and defaults)."""

    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_hidden_size: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_ffn_dim: int = 3072
    # text tower
    vocab_size: int = 49408
    max_text_positions: int = 77
    text_hidden_size: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_ffn_dim: int = 2048
    eos_token_id: int = 49407
    # joint space
    projection_dim: int = 512
    logit_scale_init: float = 2.6592  # ln(1/0.07), HF default
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls, **kw) -> "CLIPConfig":
        kw.setdefault("image_size", 16)
        kw.setdefault("patch_size", 8)
        kw.setdefault("vision_hidden_size", 32)
        kw.setdefault("vision_layers", 2)
        kw.setdefault("vision_heads", 4)
        kw.setdefault("vision_ffn_dim", 64)
        kw.setdefault("vocab_size", 128)
        kw.setdefault("max_text_positions", 16)
        kw.setdefault("text_hidden_size", 32)
        kw.setdefault("text_layers", 2)
        kw.setdefault("text_heads", 4)
        kw.setdefault("text_ffn_dim", 64)
        kw.setdefault("eos_token_id", 2)
        kw.setdefault("projection_dim", 32)
        return cls(**kw)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: ``x * sigmoid(1.702 x)`` (HF ``quick_gelu``)."""
    return x * torch.sigmoid(1.702 * x)


class CLIPBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, eps: float, causal: bool = False):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.ln1 = LayerNorm(d_model, eps=eps)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d_model, d_model) for _ in range(4))
        self.ln2 = LayerNorm(d_model, eps=eps)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, width = hidden.shape

        def split(x):
            return x.view(b, s, self.num_heads, width // self.num_heads)

        h = self.ln1(hidden)
        dtype = h.dtype
        q, k, v = (split(_dense(p, h, dtype)) for p in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention(q, k, v, causal=self.causal).reshape(b, s, width)
        hidden = hidden + _dense(self.out_proj, out, dtype)
        h = self.ln2(hidden)
        return hidden + _dense(self.fc2, quick_gelu(_dense(self.fc1, h, h.dtype)), h.dtype)


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c, grid = cfg.vision_hidden_size, cfg.image_size // cfg.patch_size
        self.patch_embed = nn.Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c))
        self.pos_embed = nn.Parameter(torch.empty(grid * grid + 1, c))
        self.pre_norm = LayerNorm(c, eps=cfg.layer_norm_eps)
        for i in range(cfg.vision_layers):
            self.add_module(f"block_{i}", CLIPBlock(c, cfg.vision_heads, cfg.vision_ffn_dim, cfg.layer_norm_eps))
        self.post_norm = LayerNorm(c, eps=cfg.layer_norm_eps)
        self.layers = cfg.vision_layers

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The class token's state after ``post_norm``, ``[B, C]``."""
        dtype = pixel_values.dtype
        w = self.patch_embed.weight
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2), w.to(dtype), stride=w.shape[-1])
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.to(dtype).expand(b, 1, c), x], dim=1)
        x = self.pre_norm(x + self.pos_embed[None].to(dtype))
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return self.post_norm(x)[:, 0]


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d = cfg.text_hidden_size
        self.token_embed = nn.Embedding(cfg.vocab_size, d)
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_text_positions, d))
        for i in range(cfg.text_layers):
            self.add_module(f"block_{i}", CLIPBlock(d, cfg.text_heads, cfg.text_ffn_dim, cfg.layer_norm_eps, True))
        self.final_norm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = cfg.text_layers

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The per-token states after ``final_norm``, ``[B, T, D]``."""
        t = self.token_embed(input_ids.long())
        t = t + self.pos_embed[None, : t.shape[1]].to(t.dtype)
        for i in range(self.layers):
            t = getattr(self, f"block_{i}")(t)
        return self.final_norm(t)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.config = cfg
        self.vision = CLIPVision(cfg)
        self.visual_projection = nn.Linear(cfg.vision_hidden_size, cfg.projection_dim, bias=False)
        self.text = CLIPText(cfg)
        self.text_projection = nn.Linear(cfg.text_hidden_size, cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def forward(self, pixel_values=None, input_ids=None, output_hidden: bool = False):
        cfg = self.config
        image_embeds = text_embeds = text_hidden = None
        if pixel_values is not None:
            if pixel_values.is_floating_point():  # apply_fn's cast to the parameters' dtype
                pixel_values = pixel_values.to(self.vision.patch_embed.weight.dtype)
            pooled = self.vision(pixel_values)
            image_embeds = _unit(_dense(self.visual_projection, pooled, pooled.dtype))
        if input_ids is not None:
            text_hidden = self.text(input_ids)
            if cfg.eos_token_id == 2:  # the legacy configs: the real end-of-text id is the highest
                eos_pos = torch.argmax(input_ids, dim=-1)
            else:  # the first eos_token_id (0 when a row has none, as jnp.argmax gives)
                eos_pos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
            pooled = text_hidden[torch.arange(text_hidden.shape[0], device=text_hidden.device), eos_pos]
            text_embeds = _unit(_dense(self.text_projection, pooled, pooled.dtype))
        if output_hidden:
            return image_embeds, text_embeds, self.logit_scale, text_hidden
        return image_embeds, text_embeds, self.logit_scale


def create_clip_model(
    config: Optional[CLIPConfig] = None,
    seed: int = 0,
    batch_size: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """A CLIP with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), in ``dtype``: dense, convolution and embedding
    weights ``N(0, 1/fan_in)`` from a ``torch.Generator`` seeded with
    ``seed``, biases zero, LayerNorm scales one, the class and position
    embeddings ``N(0, 0.02)``, ``logit_scale`` at ``logit_scale_init`` (f32
    whatever ``dtype``). ``batch_size`` is the JAX signature's; here it
    shapes nothing. ``model.apply_fn(params, pixel_values=None,
    input_ids=None)`` and ``model.encode_text(params, input_ids) -> [B, T,
    D]``."""
    config = config or CLIPConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = CLIPModel(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name == "logit_scale":
                p.fill_(config.logit_scale_init)
                continue
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith(("class_embedding", "pos_embed")):
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            p.data = p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()
    model = Model(module, config, name="clip")

    def apply_fn(params, pixel_values=None, input_ids=None):
        return functional_call(module, params, (pixel_values, input_ids))

    def encode_text(params, input_ids):
        """Per-token text states ``[B, T, D]`` for cross-attention conditioning."""
        return functional_call(module, params, (None, input_ids), {"output_hidden": True})[3]

    model.apply_fn = apply_fn
    model.encode_text = encode_text
    return model


def clip_contrastive_loss(params: dict, batch: dict, apply_fn) -> torch.Tensor:
    """Symmetric InfoNCE over the batch: every image against every text,
    f32 similarities times ``exp(logit_scale)``."""
    img, txt, logit_scale = apply_fn(params, batch["pixel_values"], batch["input_ids"])
    logits = img.float() @ txt.float().T * torch.exp(logit_scale)
    labels = torch.arange(logits.shape[0], device=logits.device)
    nll_i = F.cross_entropy(logits, labels)
    nll_t = F.cross_entropy(logits.T, labels)
    return 0.5 * (nll_i + nll_t)
