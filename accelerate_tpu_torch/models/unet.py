"""UNet2D diffusion denoiser with sinusoidal time conditioning.

Counterpart of :mod:`accelerate_tpu.models.unet`, with its arithmetic:

* the sample and the output are NHWC (``[B, H, W, C]``) as in the JAX
  signature; inside, the activations are NCHW tensors in
  ``channels_last`` memory (the NHWC bytes), which cuDNN convolves without
  a transpose;
* ``_GroupNorm`` computes in f32 with flax's ``epsilon`` 1e-6 (torch's
  default is 1e-5) and casts back; flax's statistics are the fast variance
  ``E[x^2] - E[x]^2``, torch's ``group_norm`` a two-pass one, which moves
  an output by about an f32 ulp of its largest value;
* convolutions pad as flax's ``padding="SAME"`` (a 3x3 stride-2 window on
  an even size pads (0, 1), :func:`~.resnet.same_pads`) and compute in
  the stream's dtype; ``conv_out`` computes in f32;
* a ResBlock scales and shifts its second norm's output by a projection of
  the time embedding (FiLM), with a 1x1 ``skip_proj`` where the channels
  change; the up path concatenates the skips along channels in the
  reference's pop order, and upsamples by nearest 2x (row ``i`` reads row
  ``i // 2``, as ``jax.image.resize(..., "nearest")`` does at exactly 2x);
* ``AttnBlock`` is self-attention over the positions and, with a
  ``context``, a cross-attention sub-block whose keys and values are
  projections of the conditioning sequence, both through
  :func:`~..ops.attention.dot_product_attention`: at Stable Diffusion
  v1.5's widths the 64 x 64 level's 4,096 positions in 8 heads of 40 go
  to the flash kernels on the card (K1, and K2/K3 in training), the
  lower levels to the einsum path, as in the JAX package;
* the time embedding is f32, cast to the sample's dtype.

The JAX module's ``_skip_safe`` pins a skip's layout on the mesh; with no
mesh (ROADMAP.md Queue 1 item 8) it is the identity here, and
``UNET_SHARDING_RULES`` waits for it too. Module names are the flax ones
(``down_0_0.norm_1.gn``), so :func:`~.convert.unet_params_from_jax` is a
walk of the tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..modeling import Model
from ..ops.attention import dot_product_attention
from ..utils.environment import resolve_device
from .resnet import same_pads
from .whisper import _dense

GN_EPS = 1e-6  # flax nn.GroupNorm's default


@dataclasses.dataclass
class UNetConfig:
    """A copy of :class:`accelerate_tpu.models.unet.UNetConfig` (same fields
    and defaults)."""

    in_channels: int = 3
    out_channels: int = 3
    sample_size: int = 32  # H = W
    base_channels: int = 64
    channel_mults: Sequence[int] = (1, 2, 2)
    layers_per_block: int = 1
    attention_levels: Sequence[int] = (2,)  # indices into channel_mults
    num_heads: int = 4
    num_groups: int = 8
    num_classes: Optional[int] = None  # class-conditional when set
    context_dim: Optional[int] = None  # cross-attention text conditioning when set
    dropout: float = 0.0

    @classmethod
    def tiny(cls, **kw) -> "UNetConfig":
        kw.setdefault("sample_size", 8)
        kw.setdefault("base_channels", 16)
        kw.setdefault("channel_mults", (1, 2))
        kw.setdefault("attention_levels", (1,))
        kw.setdefault("num_groups", 4)
        kw.setdefault("num_heads", 2)
        return cls(**kw)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding ``[B] -> [B, dim]`` in f32 (DDPM convention:
    cos | sin halves, a zero column when ``dim`` is odd)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def conv_same(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", dtype=dtype)`` on an NCHW ``x``: input,
    weight and bias in ``dtype`` (None: ``x``'s)."""
    dtype = dtype or x.dtype
    x, w = x.to(dtype), conv.weight.to(dtype)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    k = w.shape[-1]
    (top, bottom), (left, right) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, bias, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, bias, stride=stride)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x on an NCHW ``x``: output row ``i`` is input row ``i // 2``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (under the name ``gn``) in f32, cast back."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.gn = nn.GroupNorm(groups, channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.gn
        return F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), gn.eps).to(x.dtype)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, groups: int, temb_dim: int, dropout: float = 0.0):
        super().__init__()
        self.channels, self.dropout = channels, dropout
        self.norm_1 = _GroupNorm(groups, in_channels)
        self.conv_1 = nn.Conv2d(in_channels, channels, 3)
        self.temb_proj = nn.Linear(temb_dim, 2 * channels)
        self.norm_2 = _GroupNorm(groups, channels)
        self.conv_2 = nn.Conv2d(channels, channels, 3)
        if in_channels != channels:
            self.skip_proj = nn.Conv2d(in_channels, channels, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = conv_same(F.silu(self.norm_1(x)), self.conv_1)
        ss = _dense(self.temb_proj, F.silu(temb), x.dtype)
        scale, shift = ss[:, : self.channels, None, None], ss[:, self.channels:, None, None]
        h = F.silu(self.norm_2(h) * (1 + scale) + shift)
        if rng is not None and self.dropout > 0.0:
            keep = torch.rand(h.shape, generator=rng, device=h.device) < 1.0 - self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        h = conv_same(h, self.conv_2)
        if hasattr(self, "skip_proj"):
            x = conv_same(x, self.skip_proj)
        return x + h


class AttnBlock(nn.Module):
    """Self-attention over the spatial positions; with ``context_dim``, a
    cross-attention sub-block over the conditioning sequence too."""

    def __init__(self, channels: int, num_heads: int, groups: int, context_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = _GroupNorm(groups, channels)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(channels, channels) for _ in range(4))
        if context_dim is not None:
            self.cross_norm = _GroupNorm(groups, channels)
            self.cross_q_proj = nn.Linear(channels, channels)
            self.cross_k_proj = nn.Linear(context_dim, channels)
            self.cross_v_proj = nn.Linear(context_dim, channels)
            self.cross_out_proj = nn.Linear(channels, channels)

    def _attend(self, x, norm, q_proj, k_proj, v_proj, out_proj, kv=None):
        b, c, hh, ww = x.shape
        dtype = x.dtype
        h = norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)  # [B, positions, C]
        src = h if kv is None else kv

        def split(y):
            return y.view(b, -1, self.num_heads, c // self.num_heads)

        q, k, v = split(_dense(q_proj, h, dtype)), split(_dense(k_proj, src, dtype)), split(_dense(v_proj, src, dtype))
        out = dot_product_attention(q, k, v, causal=False).reshape(b, hh * ww, c)
        return x + _dense(out_proj, out, dtype).view(b, hh, ww, c).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._attend(x, self.norm, self.q_proj, self.k_proj, self.v_proj, self.out_proj)
        if context is not None:
            x = self._attend(x, self.cross_norm, self.cross_q_proj, self.cross_k_proj, self.cross_v_proj,
                             self.cross_out_proj, kv=context.to(x.dtype))
        return x


class UNet2D(nn.Module):
    """``forward(sample [B, H, W, C], timesteps [B], class_labels=None,
    encoder_hidden_states=None, deterministic=True, rngs=None)`` -> the
    predicted noise ``[B, H, W, out_channels]`` in f32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        base, groups, temb_dim = cfg.base_channels, cfg.num_groups, cfg.base_channels * 4
        last = len(cfg.channel_mults) - 1

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, groups, temb_dim, cfg.dropout))

        def attn(name, ch):
            self.add_module(name, AttnBlock(ch, cfg.num_heads, groups, cfg.context_dim))

        self.time_mlp_1 = nn.Linear(base, temb_dim)
        self.time_mlp_2 = nn.Linear(temb_dim, temb_dim)
        if cfg.num_classes is not None:
            self.label_embed = nn.Embedding(cfg.num_classes, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, base, 3)
        ch_in, skips = base, [base]
        for lvl, mult in enumerate(cfg.channel_mults):
            ch = base * mult
            for i in range(cfg.layers_per_block):
                res(f"down_{lvl}_{i}", ch_in, ch)
                if lvl in cfg.attention_levels:
                    attn(f"down_attn_{lvl}_{i}", ch)
                ch_in = ch
                skips.append(ch)
            if lvl != last:
                self.add_module(f"downsample_{lvl}", nn.Conv2d(ch, ch, 3))
                skips.append(ch)
        res("mid_1", ch_in, ch_in)
        attn("mid_attn", ch_in)
        res("mid_2", ch_in, ch_in)
        for lvl, mult in reversed(list(enumerate(cfg.channel_mults))):
            ch = base * mult
            for i in range(cfg.layers_per_block + 1):
                res(f"up_{lvl}_{i}", ch_in + skips.pop(), ch)
                if lvl in cfg.attention_levels:
                    attn(f"up_attn_{lvl}_{i}", ch)
                ch_in = ch
            if lvl != 0:
                self.add_module(f"upsample_{lvl}", nn.Conv2d(ch, ch, 3))
        self.norm_out = _GroupNorm(groups, ch_in)
        self.conv_out = nn.Conv2d(ch_in, cfg.out_channels, 3)

    def forward(self, sample, timesteps, class_labels=None, encoder_hidden_states=None, deterministic: bool = True,
                rngs=None):
        cfg = self.config
        if cfg.context_dim is not None and encoder_hidden_states is None:
            raise ValueError("text-conditional UNet needs encoder_hidden_states")
        if not deterministic and cfg.dropout > 0.0 and rngs is None:
            raise ValueError("deterministic=False (dropout on) requires rngs={'dropout': generator}")
        rng = None if deterministic else (rngs or {}).get("dropout")
        ctx = encoder_hidden_states if cfg.context_dim is not None else None
        if sample.is_floating_point():  # apply_fn's cast to the parameters' dtype
            sample = sample.to(self.conv_in.weight.dtype)
        dtype = sample.dtype
        temb = timestep_embedding(timesteps, cfg.base_channels).to(dtype)
        temb = _dense(self.time_mlp_1, temb, dtype)
        temb = _dense(self.time_mlp_2, F.silu(temb), dtype)
        if cfg.num_classes is not None:
            if class_labels is None:
                raise ValueError("class-conditional UNet needs class_labels")
            temb = temb + self.label_embed(class_labels.long()).to(temb.dtype)

        h = conv_same(sample.permute(0, 3, 1, 2), self.conv_in)  # NHWC bytes, NCHW view: channels_last
        skips = [h]
        last = len(cfg.channel_mults) - 1
        for lvl in range(len(cfg.channel_mults)):
            for i in range(cfg.layers_per_block):
                h = getattr(self, f"down_{lvl}_{i}")(h, temb, rng)
                if lvl in cfg.attention_levels:
                    h = getattr(self, f"down_attn_{lvl}_{i}")(h, ctx)
                skips.append(h)
            if lvl != last:
                h = conv_same(h, getattr(self, f"downsample_{lvl}"), stride=2)
                skips.append(h)
        h = self.mid_2(self.mid_attn(self.mid_1(h, temb, rng), ctx), temb, rng)
        for lvl in reversed(range(len(cfg.channel_mults))):
            for i in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{lvl}_{i}")(torch.cat([h, skips.pop()], dim=1), temb, rng)
                if lvl in cfg.attention_levels:
                    h = getattr(self, f"up_attn_{lvl}_{i}")(h, ctx)
            if lvl != 0:
                h = conv_same(upsample_nearest(h), getattr(self, f"upsample_{lvl}"))
        h = F.silu(self.norm_out(h))
        return conv_same(h, self.conv_out, dtype=torch.float32).permute(0, 2, 3, 1)


def _init(module: nn.Module, dtype: torch.dtype, seed: int, dev) -> None:
    """Seeded weights: every convolution, dense and embedding weight ``N(0,
    1/fan_in)`` from a ``torch.Generator`` (a convolution's fan-in is its
    input channels times its taps), biases zero, GroupNorm scales one, all
    in ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            p.data = p.data.to(dtype)
    module.requires_grad_(False)
    module.eval()


def create_unet_model(
    config: Optional[UNetConfig] = None,
    seed: int = 0,
    batch_size: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """A UNet2D with seeded random weights (:func:`_init`) on ``device``
    (``cuda`` unless ``"cpu"`` is asked for), in ``dtype``. ``batch_size``
    is the JAX signature's; here it shapes nothing.
    ``model.apply_fn(params, sample, timesteps, class_labels=None,
    encoder_hidden_states=None, deterministic=True)``."""
    config = config or UNetConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = UNet2D(config)
    module.to_empty(device=dev)
    _init(module, dtype, seed, dev)
    model = Model(module, config, name="unet2d")

    def apply_fn(params, sample, timesteps, class_labels=None, encoder_hidden_states=None, deterministic=True):
        return functional_call(module, params, (sample, timesteps, class_labels, encoder_hidden_states,
                                                deterministic))

    model.apply_fn = apply_fn
    return model
