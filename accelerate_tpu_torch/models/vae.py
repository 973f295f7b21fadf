"""Convolutional VAE (the AutoencoderKL shape) for latent diffusion.

Counterpart of :mod:`accelerate_tpu.models.vae`, with its arithmetic:

* the encoder is ``conv_in``, a UNet :class:`~.unet.ResBlock` a level with
  a stride-2 SAME ``downsample`` between levels, a ``mid`` ResBlock, the
  f32 ``_GroupNorm`` and SiLU, then the f32 ``latent_head`` giving the
  mean and the log-variance, the latter clipped to [-30, 20];
* the decoder mirrors it with nearest-2x upsampling and an f32
  ``conv_out``;
* the ResBlocks take a zero time embedding (their FiLM projection acts as
  a learned bias);
* ``encode`` returns the latents scaled by ``scaling_factor`` (the SD
  convention) with the moments, ``decode`` divides by it first, and
  ``decode`` computes in the latents' dtype (f32 latents decode in f32, as
  in the JAX package, whose ``decode_fn`` does not cast).

Images, latents and moments are NHWC as in the JAX signatures. A sampled
latent is ``mean + exp(logvar / 2) * eps`` with ``eps`` drawn from a
``torch.Generator`` (``rng``); with ``rng=None`` it is the mean.
Module names are the flax ones (``encoder.down_0.norm_1.gn``), so
:func:`~.convert.vae_params_from_jax` is a walk of the tree. No kernel of
the JAX package runs here: its convolutions are XLA's, so here they are
cuDNN's. ``VAE_SHARDING_RULES`` waits for the mesh (ROADMAP.md Queue 1
item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..modeling import Model
from ..utils.environment import resolve_device
from .unet import ResBlock, _GroupNorm, _init, conv_same, upsample_nearest


@dataclasses.dataclass
class VAEConfig:
    """A copy of :class:`accelerate_tpu.models.vae.VAEConfig` (same fields,
    defaults and properties)."""

    in_channels: int = 3
    latent_channels: int = 4
    sample_size: int = 32  # H = W of the image
    base_channels: int = 32
    channel_mults: Sequence[int] = (1, 2)  # len = number of levels; stride-2 between levels
    num_groups: int = 8
    scaling_factor: float = 0.18215  # SD latents convention
    kl_weight: float = 1e-4

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)

    @property
    def latent_size(self) -> int:
        return self.sample_size // self.downsample_factor

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        kw.setdefault("sample_size", 16)
        kw.setdefault("base_channels", 16)
        kw.setdefault("channel_mults", (1, 2))
        kw.setdefault("num_groups", 4)
        kw.setdefault("latent_channels", 2)
        return cls(**kw)


def _zero_temb(x: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    return torch.zeros(x.shape[0], cfg.base_channels, dtype=x.dtype, device=x.device)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        base, groups = cfg.base_channels, cfg.num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, base, 3)
        ch_in = base
        for lvl, mult in enumerate(cfg.channel_mults):
            ch = base * mult
            self.add_module(f"down_{lvl}", ResBlock(ch_in, ch, groups, base))
            if lvl != len(cfg.channel_mults) - 1:
                self.add_module(f"downsample_{lvl}", nn.Conv2d(ch, ch, 3))
            ch_in = ch
        self.mid = ResBlock(ch_in, ch_in, groups, base)
        self.norm_out = _GroupNorm(groups, ch_in)
        self.latent_head = nn.Conv2d(ch_in, 2 * cfg.latent_channels, 3)

    def forward(self, x: torch.Tensor):
        """NCHW ``x`` -> ``(mean, logvar)``, NCHW f32."""
        cfg = self.config
        temb = _zero_temb(x, cfg)
        h = conv_same(x, self.conv_in)
        for lvl in range(len(cfg.channel_mults)):
            h = getattr(self, f"down_{lvl}")(h, temb)
            if lvl != len(cfg.channel_mults) - 1:
                h = conv_same(h, getattr(self, f"downsample_{lvl}"), stride=2)
        h = F.silu(self.norm_out(self.mid(h, temb)))
        mean, logvar = conv_same(h, self.latent_head, dtype=torch.float32).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        base, groups = cfg.base_channels, cfg.num_groups
        ch = base * cfg.channel_mults[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3)
        self.mid = ResBlock(ch, ch, groups, base)
        ch_in = ch
        for lvl, mult in reversed(list(enumerate(cfg.channel_mults))):
            ch = base * mult
            self.add_module(f"up_{lvl}", ResBlock(ch_in, ch, groups, base))
            if lvl != 0:
                self.add_module(f"upsample_{lvl}", nn.Conv2d(ch, ch, 3))
            ch_in = ch
        self.norm_out = _GroupNorm(groups, ch_in)
        self.conv_out = nn.Conv2d(ch_in, cfg.in_channels, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> NCHW f32 image, computed in ``z``'s dtype."""
        cfg = self.config
        temb = _zero_temb(z, cfg)
        h = self.mid(conv_same(z, self.conv_in), temb)
        for lvl in reversed(range(len(cfg.channel_mults))):
            h = getattr(self, f"up_{lvl}")(h, temb)
            if lvl != 0:
                h = conv_same(upsample_nearest(h), getattr(self, f"upsample_{lvl}"))
        return conv_same(F.silu(self.norm_out(h)), self.conv_out, dtype=torch.float32)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class VAE(nn.Module):
    """``forward(x, rng=None, method="reconstruct")``: ``"reconstruct"``
    gives ``(image, mean, logvar)``, ``"encode"`` ``(scaled latents, mean,
    logvar)``, ``"decode"`` (``x`` the scaled latents) the image; all NHWC,
    the image f32. ``_eps`` (NHWC, the mean's shape) stands in for the
    generator's draw."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)

    def _latent(self, x, rng, eps):
        if x.is_floating_point():  # apply_fn's and encode_fn's cast to the parameters' dtype
            x = x.to(self.encoder.conv_in.weight.dtype)
        mean, logvar = (_nhwc(m) for m in self.encoder(_nchw(x)))
        if eps is None and rng is not None:
            eps = torch.randn(mean.shape, generator=rng, device=mean.device)
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
        return x, z, mean, logvar

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None, method: str = "reconstruct",
                _eps: Optional[torch.Tensor] = None):
        if method == "decode":
            return _nhwc(self.decoder(_nchw(x / self.config.scaling_factor)))
        if method not in ("reconstruct", "encode"):
            raise ValueError(f"method must be reconstruct|encode|decode, got {method!r}")
        x, z, mean, logvar = self._latent(x, rng, _eps)
        if method == "encode":
            return z * self.config.scaling_factor, mean, logvar
        return _nhwc(self.decoder(_nchw(z.to(x.dtype)))), mean, logvar


def vae_loss(params: dict, batch: dict, apply_fn, rng=None, kl_weight: Optional[float] = None,
             config: Optional[VAEConfig] = None) -> torch.Tensor:
    """ELBO: MSE reconstruction plus ``kl_weight`` x KL(q(z|x) || N(0, 1)),
    in f32 with per-element means (the weight is resolution-independent).
    ``rng`` is the step's generator (the sampled latent)."""
    recon, mean, logvar = apply_fn(params, batch["pixel_values"], rng)
    x = batch["pixel_values"].float()
    rec = torch.mean((recon - x) ** 2)
    kl = 0.5 * torch.mean(torch.exp(logvar) + mean**2 - 1.0 - logvar)
    weight = kl_weight if kl_weight is not None else (config.kl_weight if config else 1e-4)
    return rec + weight * kl


def create_vae_model(
    config: Optional[VAEConfig] = None,
    seed: int = 0,
    batch_size: int = 2,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Model:
    """A VAE with seeded random weights (the UNet's :func:`~.unet._init`) on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), in ``dtype``.
    ``batch_size`` is the JAX signature's; here it shapes nothing.
    ``model.apply_fn(params, pixel_values, rng=None)`` reconstructs,
    ``model.encode_fn(params, x, rng=None)`` and ``model.decode_fn(params,
    z)`` are the halves."""
    config = config or VAEConfig.tiny()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = VAE(config)
    module.to_empty(device=dev)
    _init(module, dtype, seed, dev)
    model = Model(module, config, name="vae")

    def apply_fn(params, pixel_values, rng=None):
        return functional_call(module, params, (pixel_values, rng))

    model.apply_fn = apply_fn
    model.encode_fn = lambda p, x, rng=None: functional_call(module, p, (x, rng, "encode"))
    model.decode_fn = lambda p, z: functional_call(module, p, (z, None, "decode"))
    return model
