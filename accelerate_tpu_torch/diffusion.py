"""Diffusion: the noise schedule, the training losses and the DDPM/DDIM
samplers, with ``text_to_image`` on top.

Counterpart of :mod:`accelerate_tpu.diffusion`, with its arithmetic:

* :func:`make_schedule` (linear or cosine betas, in numpy f64, stored as
  f32) is a copy of the JAX package's;
* the losses draw a timestep per row and Gaussian noise, forward-noise the
  sample with the schedule's f32 square roots, and take the f32 MSE of the
  predicted noise; :func:`latent_diffusion_loss` runs the frozen VAE
  encoder and text encoder under ``no_grad`` (the reference's
  ``stop_gradient``) and zeroes each row's conditioning with probability
  ``cond_drop_prob``;
* :func:`sample` walks the same timestep sequence (``np.linspace(0, T -
  1, num_steps).round()`` descending, the last step's predecessor -1),
  clips the predicted x0 to +-4, and steps DDIM with ``eta`` or DDPM's
  posterior sigma; under guidance the denoiser runs once over the
  concatenated [cond; uncond] batch, whose null branch is the last class
  id or ``uncond_hidden_states`` (zeros when omitted).

The JAX package compiles the loop once as a ``lax.scan`` and caches the
runner by the schedule's content; here the loop is eager, one denoiser call
a step, and nothing is cached, so a changed schedule can never be served
stale. Randomness comes from ``torch.Generator``s: ``seed`` seeds one on
the model's device, and the losses take the train step's generator
(``build_train_step`` passes it as ``rng``). ``jax.random`` and
``torch.Generator`` never agree, so the private seams below take the
draws as tensors (``_sample``'s and ``_text_to_image``'s ``x_T``,
``_noise_mse``'s ``t`` and ``noise``, ``_latent_mse``'s latents, keep
mask, ``t`` and ``noise``), which is how the tests replay the JAX
package's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def make_schedule(num_train_steps: int = 1000, beta_start: float = 1e-4, beta_end: float = 0.02, kind: str = "linear"):
    """Precompute the DDPM noise schedule as a dict of [T] arrays."""
    if kind == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_steps, dtype=np.float64)
    elif kind == "cosine":  # Nichol & Dhariwal
        s = 0.008
        t = np.arange(num_train_steps + 1, dtype=np.float64) / num_train_steps
        f = np.cos((t + s) / (1 + s) * math.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(f"kind must be linear|cosine, got {kind!r}")
    alphas = 1.0 - betas
    alphas_bar = np.cumprod(alphas)
    return {
        "betas": betas.astype(np.float32),
        "alphas": alphas.astype(np.float32),
        "alphas_bar": alphas_bar.astype(np.float32),
        "sqrt_alphas_bar": np.sqrt(alphas_bar).astype(np.float32),
        "sqrt_one_minus_alphas_bar": np.sqrt(1.0 - alphas_bar).astype(np.float32),
        "num_train_steps": num_train_steps,
    }


def _draw_noise(schedule, x0: torch.Tensor, rng: torch.Generator):
    """A uniform timestep per row and Gaussian noise of ``x0``'s shape and
    dtype: ``(t [B], noise)``."""
    t = torch.randint(0, schedule["num_train_steps"], (x0.shape[0],), generator=rng, device=x0.device)
    return t, torch.randn(x0.shape, generator=rng, device=x0.device, dtype=x0.dtype)


def _add_noise(schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward-noise ``x0`` (NHWC) to the timesteps ``t``:
    ``sqrt(abar_t) x0 + sqrt(1 - abar_t) noise``."""
    sab = torch.as_tensor(schedule["sqrt_alphas_bar"], device=x0.device)[t][:, None, None, None]
    somab = torch.as_tensor(schedule["sqrt_one_minus_alphas_bar"], device=x0.device)[t][:, None, None, None]
    return sab * x0 + somab * noise


def _noise_mse(params, apply_fn, schedule, x0, t, noise, labels=None, ctx=None) -> torch.Tensor:
    """The noise-prediction MSE from given draws, in f32."""
    x_t = _add_noise(schedule, x0, t, noise)
    pred = apply_fn(params, x_t, t, labels) if ctx is None else apply_fn(params, x_t, t, labels, ctx)
    return torch.mean((pred.float() - noise.float()) ** 2)


def diffusion_loss(params, batch, apply_fn, schedule, rng: torch.Generator) -> torch.Tensor:
    """Noise-prediction MSE (DDPM's simple loss): t ~ U, add noise, predict
    it. ``batch = {"images": [B, H, W, C](, "labels": [B])}``; bind it for
    ``build_train_step`` with ``lambda p, b, rng: diffusion_loss(p, b,
    model.apply_fn, schedule, rng)``."""
    t, noise = _draw_noise(schedule, batch["images"], rng)
    return _noise_mse(params, apply_fn, schedule, batch["images"], t, noise, batch.get("labels"))


def _timesteps(num_steps: int, T: int):
    """The evenly spaced timestep subsequence, descending, and each step's
    predecessor (-1 after the last)."""
    ts = np.linspace(0, T - 1, num_steps).round().astype(np.int32)[::-1].copy()
    return ts, np.concatenate([ts[1:], [-1]]).astype(np.int32)


def sample(
    model,
    batch_size: int,
    num_steps: int = 50,
    schedule=None,
    method: str = "ddim",
    eta: float = 0.0,
    class_labels=None,
    guidance_scale: Optional[float] = None,
    seed: int = 0,
    encoder_hidden_states=None,
    uncond_hidden_states=None,
) -> torch.Tensor:
    """Generate ``[B, H, W, C]`` f32 samples by an eager denoising loop.

    ``method="ddim"`` (deterministic when ``eta=0``) or ``"ddpm"``
    (ancestral, the full posterior variance). ``guidance_scale`` enables
    classifier-free guidance; the null branch is the reserved LAST class id
    (class-conditional models) or ``uncond_hidden_states`` (text-conditional
    models: the empty prompt's encoding, zeros when omitted); each step runs
    the denoiser on both and extrapolates. Text-conditional models
    (``config.context_dim``) condition every step on
    ``encoder_hidden_states`` ``[B, T, D]``. ``seed`` seeds the generator of
    x_T and of DDPM's (or ``eta``'s) noise on the model's device."""
    return _sample(model, batch_size, num_steps, schedule, method, eta, class_labels, guidance_scale, seed,
                   encoder_hidden_states, uncond_hidden_states)


def _sample(model, batch_size, num_steps=50, schedule=None, method="ddim", eta=0.0, class_labels=None,
            guidance_scale=None, seed=0, encoder_hidden_states=None, uncond_hidden_states=None, x_T=None):
    """:func:`sample`, from ``x_T`` when it is given (the seam the tests feed
    the JAX package's draw through)."""
    schedule = schedule or make_schedule()
    cfg = model.config
    shape = (batch_size, cfg.sample_size, cfg.sample_size, cfg.out_channels)
    T = schedule["num_train_steps"]
    if not 1 <= num_steps <= T:
        raise ValueError(f"num_steps must be in [1, {T}], got {num_steps}")
    if method not in ("ddim", "ddpm"):
        raise ValueError(f"method must be ddim|ddpm, got {method!r}")
    text_conditional = getattr(cfg, "context_dim", None) is not None
    if text_conditional and encoder_hidden_states is None:
        raise ValueError("text-conditional UNet needs encoder_hidden_states")
    if guidance_scale is not None and cfg.num_classes is None and not text_conditional:
        raise ValueError("guidance needs a class-conditional or text-conditional UNet")
    ts, ts_prev = _timesteps(num_steps, T)
    dev = model.device

    labels = None
    if cfg.num_classes is not None:
        if class_labels is None:
            raise ValueError("class-conditional UNet needs class_labels")
        labels = torch.as_tensor(class_labels, device=dev).long()
    ctx = uctx = None
    if text_conditional:
        ctx = torch.as_tensor(encoder_hidden_states, device=dev)
        if guidance_scale is not None:
            uctx = torch.zeros_like(ctx) if uncond_hidden_states is None else torch.as_tensor(uncond_hidden_states,
                                                                                              device=dev)
    # the guided batch's conditioning, built once: [cond; uncond]
    labels2 = None if labels is None or guidance_scale is None else torch.cat(
        [labels, torch.full_like(labels, cfg.num_classes - 1)])
    ctx2 = None if ctx is None or guidance_scale is None else torch.cat([ctx, uctx.to(ctx.dtype)])
    params = model.params

    def denoise(x, t_b):
        if guidance_scale is None:
            args = (labels, ctx) if text_conditional else (labels,)
            return model.apply_fn(params, x, t_b, *args)
        args = (labels2, ctx2) if text_conditional else (labels2,)
        eps = model.apply_fn(params, torch.cat([x, x]), torch.cat([t_b, t_b]), *args)
        cond, uncond = eps.chunk(2)
        return uncond + guidance_scale * (cond - uncond)

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) if x_T is None else torch.as_tensor(x_T, device=dev).float()
    ab = torch.as_tensor(schedule["alphas_bar"], device=dev)
    one = torch.ones((), device=dev)
    noisy = method == "ddpm" or eta != 0.0
    with torch.no_grad():
        for t, t_prev in zip(ts.tolist(), ts_prev.tolist()):
            t_b = torch.full((batch_size,), t, dtype=torch.int32, device=dev)
            eps = denoise(x, t_b).float()
            a_t, a_prev = ab[t], ab[t_prev] if t_prev >= 0 else one
            x0 = ((x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)).clamp(-4.0, 4.0)
            if method == "ddim":
                sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
            else:  # ddpm ancestral
                sigma = torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
            dir_xt = torch.sqrt(torch.clamp_min(1.0 - a_prev - sigma**2, 0.0)) * eps
            x = torch.sqrt(a_prev) * x0 + dir_xt
            if noisy and t_prev >= 0:
                x = x + sigma * torch.randn(shape, generator=gen, device=dev)
    return x


def latent_diffusion_loss(
    params,
    batch,
    apply_fn,
    schedule,
    rng: torch.Generator,
    *,
    vae,
    vae_params=None,
    text_encoder=None,
    text_params=None,
    cond_drop_prob: float = 0.1,
) -> torch.Tensor:
    """Noise-prediction MSE in the VAE's latent space (the Stable Diffusion
    training objective). ``params`` are the UNet's, the only trainable
    tree; the VAE (``vae.encode_fn``, sampled with ``rng``) and the text
    encoder (``text_encoder(text_params, input_ids)``, e.g. a CLIP model's
    ``encode_text``) are frozen, run under ``no_grad``. ``batch =
    {"pixel_values": [B, H, W, C], "encoder_hidden_states": [B, T, D]}``,
    or ``"input_ids"`` in place of the states to encode in the step.
    ``cond_drop_prob`` zeroes a row's conditioning, so the model learns the
    unconditional branch classifier-free guidance needs."""
    with torch.no_grad():
        vp = vae.params if vae_params is None else vae_params
        latents = vae.encode_fn(vp, batch["pixel_values"], rng)[0].float()
        ctx = _conditioning(batch, text_encoder, text_params)
    keep = torch.rand((latents.shape[0],), generator=rng, device=latents.device) < 1.0 - cond_drop_prob
    t, noise = _draw_noise(schedule, latents, rng)
    return _latent_mse(params, apply_fn, schedule, latents, ctx, keep if cond_drop_prob > 0.0 else None, t, noise)


def _conditioning(batch, text_encoder, text_params):
    ctx = batch.get("encoder_hidden_states")
    if ctx is None:
        if text_encoder is None:
            raise ValueError("need encoder_hidden_states in the batch or a text_encoder")
        ctx = text_encoder(text_params, batch["input_ids"])
    return ctx


def _latent_mse(params, apply_fn, schedule, latents, ctx, keep, t, noise) -> torch.Tensor:
    """:func:`latent_diffusion_loss` from given latents, conditioning, keep
    mask (None: no drop), timesteps and noise."""
    ctx = ctx.detach()
    if keep is not None:
        ctx = torch.where(keep[:, None, None], ctx, torch.zeros_like(ctx))
    return _noise_mse(params, apply_fn, schedule, latents.detach(), t, noise, None, ctx)


def text_to_image(
    unet,
    vae,
    text_model,
    prompt_ids,
    uncond_ids=None,
    guidance_scale: Optional[float] = 7.5,
    num_steps: int = 50,
    schedule=None,
    method: str = "ddim",
    eta: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Prompts -> images ``[B, H, W, C]`` f32: encode the text, denoise the
    latents under classifier-free guidance, decode with the VAE.
    ``text_model`` exposes ``encode_text(params, ids) -> [B, T, D]``
    (:func:`~.models.clip.create_clip_model`); ``prompt_ids`` is ``[B, T]``
    or one unbatched prompt ``[T]``; ``uncond_ids`` is the tokenized empty
    prompt, one row broadcast to every prompt or ``[B, T]`` (zero states
    when omitted: training's dropped conditioning)."""
    return _text_to_image(unet, vae, text_model, prompt_ids, uncond_ids, guidance_scale, num_steps, schedule,
                          method, eta, seed)


def _text_to_image(unet, vae, text_model, prompt_ids, uncond_ids=None, guidance_scale=7.5, num_steps=50,
                   schedule=None, method="ddim", eta=0.0, seed=0, x_T=None):
    """:func:`text_to_image` from the latents ``x_T`` when they are given."""
    dev = text_model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=dev).long()
    if prompt_ids.ndim == 1:  # one unbatched prompt
        prompt_ids = prompt_ids[None]
    with torch.no_grad():
        ctx = text_model.encode_text(text_model.params, prompt_ids)
        uctx = None
        if guidance_scale is not None:
            if uncond_ids is None:
                uctx = torch.zeros_like(ctx)
            else:
                uncond_ids = torch.as_tensor(uncond_ids, device=dev).long()
                if uncond_ids.ndim == 1:
                    uncond_ids = uncond_ids[None].expand(prompt_ids.shape)
                uctx = text_model.encode_text(text_model.params, uncond_ids)
        latents = _sample(unet, prompt_ids.shape[0], num_steps, schedule, method, eta, None, guidance_scale, seed,
                          ctx, uctx, x_T=x_T)
        return vae.decode_fn(vae.params, latents)
