"""Vision Transformer: the transformer CV model of the zoo.

Counterpart of :mod:`accelerate_tpu.models.vit`, with its arithmetic:

* the patches are a strided convolution (kernel = stride = patch, no
  padding) on the NHWC images, flattened row by row into tokens, behind a
  zero-initialised class token, plus a learned position table;
* pre-LN blocks whose LayerNorms compute in f32 and cast back, the
  attention through :func:`~..ops.attention.dot_product_attention`, and
  flax's ``nn.gelu``, the **tanh** approximation, between ``mlp/up`` and
  ``mlp/down``;
* the six dense layers of a block (``attention/{query,key,value,out}``,
  ``mlp/{up,down}``) are :class:`~..ops.fp8.PolicyLinear`, as the JAX
  module hands them ``policy_dot_general()``;
* ``final_norm`` outputs f32 and the ``head`` reads the class token in f32;
* ``apply_fn`` casts the images to the parameters' dtype.

Module names are the flax ones with ``/`` read as a submodule
(``block_0.attention.query``), so
:func:`~.convert.vit_params_from_jax` is a walk of the tree. Dropout
draws from a ``torch.Generator`` (``rngs={"dropout": generator}``), one
seed a block so that ``remat`` recomputes the same masks. The 197
positions of ViT-B/16 stay under ``FLASH_MIN_SEQ``: the attention is the
einsum path in both packages. ``VIT_SHARDING_RULES`` waits for the mesh
(ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..ops.fp8 import PolicyLinear
from ..utils.environment import resolve_device
from .bert import _dropout
from .gpt2 import LayerNorm


@dataclasses.dataclass
class ViTConfig:
    """A copy of :class:`accelerate_tpu.models.vit.ViTConfig` (same fields
    and defaults: ``base()`` is ViT-B/16 at 224 px, 1,000 classes)."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    dropout_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    remat: bool = False

    @classmethod
    def base(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.norm1 = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.attention = nn.ModuleDict({name: PolicyLinear(h, h) for name in ("query", "key", "value", "out")})
        self.norm2 = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"up": PolicyLinear(h, cfg.intermediate_size),
                                  "down": PolicyLinear(cfg.intermediate_size, h)})

    def forward(self, hidden: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """``seed`` seeds this block's dropout generator (None: no dropout)."""
        cfg = self.config
        rng = None if seed is None else torch.Generator(device=hidden.device).manual_seed(seed)
        b, s, width = hidden.shape
        attn = self.attention

        def split(t):
            return t.view(b, s, cfg.num_attention_heads, width // cfg.num_attention_heads)

        x = self.norm1(hidden)
        out = dot_product_attention(split(attn["query"](x)), split(attn["key"](x)), split(attn["value"](x)))
        out = _dropout(attn["out"](out.reshape(b, s, width)), cfg.dropout_rate, rng)
        hidden = hidden + out
        x = F.gelu(self.mlp["up"](self.norm2(hidden)), approximate="tanh")
        return hidden + _dropout(self.mlp["down"](x), cfg.dropout_rate, rng)


class ViT(nn.Module):
    """``forward(images [B, H, W, 3], deterministic=True, rngs=None)`` ->
    f32 logits ``[B, num_classes]``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        p, h = cfg.patch_size, cfg.hidden_size
        grid = cfg.image_size // p
        self.patch_embed = nn.Conv2d(3, h, p, stride=p)
        self.cls_token = nn.Parameter(torch.empty(1, 1, h))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, h))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"block_{i}", ViTBlock(cfg))
        self.final_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.head = nn.Linear(h, cfg.num_classes)

    def forward(self, images: torch.Tensor, deterministic: bool = True, rngs=None) -> torch.Tensor:
        cfg = self.config
        if not deterministic and cfg.dropout_rate and rngs is None:
            raise ValueError("deterministic=False (dropout on) requires rngs={'dropout': generator}")
        w = self.patch_embed.weight
        if images.is_floating_point():
            images = images.to(w.dtype)
        dtype = images.dtype
        x = F.conv2d(images.permute(0, 3, 1, 2), w.to(dtype), self.patch_embed.bias.to(dtype), stride=cfg.patch_size)
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # [B, h * w, C], the patches row by row
        x = torch.cat([self.cls_token.to(dtype).expand(b, 1, c), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]].to(dtype)
        seeds = [None] * cfg.num_hidden_layers
        if not deterministic and cfg.dropout_rate:  # one draw for every block: a checkpointed block reseeds the same
            rng = rngs["dropout"]
            seeds = torch.randint(0, 2**62, (cfg.num_hidden_layers,), generator=rng, device=rng.device).tolist()
        for i, seed in enumerate(seeds):
            block = getattr(self, f"block_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, seed, use_reentrant=False)
            else:
                x = block(x, seed)
        n = self.final_norm
        x = F.layer_norm(x.float(), n.normalized_shape, n.weight.float(), n.bias.float(), n.eps)
        return F.linear(x[:, 0], self.head.weight.float(), self.head.bias.float())


def create_vit_model(
    config: Optional[ViTConfig] = None,
    seed: int = 0,
    batch_size: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """A ViT with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), in ``dtype``: convolution and dense weights
    ``N(0, 1/fan_in)`` from a ``torch.Generator`` seeded with ``seed``,
    biases and the class token zero, LayerNorm scales one, positions ``N(0,
    0.02)``. ``batch_size`` is the JAX signature's (its init traces a dummy
    batch); here it shapes nothing. ``model.apply_fn(params, images,
    deterministic=True, rngs=None)``."""
    config = config or ViTConfig.base()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = ViT(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias") or name == "cls_token":
                p.zero_()
            elif name == "pos_embed":
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            p.data = p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()
    model = Model(module, config, name="vit")

    def apply_fn(params, images, deterministic=True, rngs=None):
        return functional_call(module, params, (images, deterministic, rngs))

    model.apply_fn = apply_fn
    return model


def vit_classification_loss(params: dict, batch: dict, apply_fn=None) -> torch.Tensor:
    """Cross entropy on ``{"images", "labels"}`` (f32 logits and loss)."""
    logits = apply_fn(params, batch["images"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, batch["labels"].long()[:, None], dim=-1)[:, 0].mean()
