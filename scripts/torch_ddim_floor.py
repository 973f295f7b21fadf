#!/usr/bin/env python3
"""How far f32 itself is from exact in the guided DDIM sampler: the f64
floor behind ``chip_smoke.py``'s ``DDIM_CUT_TOL``.

    python3 scripts/torch_ddim_floor.py [--steps 4]

``diffusion_consistency`` holds the card's 4-step guided DDIM sample of a
cut Stable Diffusion v1.5 UNet (one 64 x 64 level of 320 channels, 8
heads of 40, SD's 768-wide text conditioning; seeded random weights) to
the CPU's. The first step divides the predicted noise by sqrt(abar_999) =
6.4e-3 after guidance multiplied cond - uncond by 7.5, so an f32 rounding
of the noise is amplified before the x0 clip. This runs the same cut, the
same x_T and text states (``chip_smoke.py``'s draws) and the same loop on
the CPU twice: ``diffusion._sample`` in f32, and the loop written again in
f64 over the model in f64 (its GroupNorms and output convolution compute
in f32 by design, in both runs). It prints one JSON line: the f32
sample's largest distance from the f64 one over the f64 sample's RMS,
and the UNet's single forward likewise. CPU only; about a minute and 6 GB
(the f64 einsum attention over 4,096 positions).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from accelerate_tpu_torch.diffusion import _sample, _timesteps, make_schedule  # noqa: E402
from accelerate_tpu_torch.models import UNetConfig, create_unet_model  # noqa: E402


def ddim_f64(unet, x_T, ctx, steps, guidance, sched):
    """``diffusion.sample``'s guided DDIM loop (eta 0, zero states as the
    unconditional branch) written again in f64, over ``unet`` in f64."""
    ts, ts_prev = _timesteps(steps, sched["num_train_steps"])
    ab = torch.as_tensor(sched["alphas_bar"], dtype=torch.float64)
    x = x_T.double()
    ctx2 = torch.cat([ctx, torch.zeros_like(ctx)]).double()
    for t, t_prev in zip(ts.tolist(), ts_prev.tolist()):
        cond, uncond = unet.apply_fn(unet.params, torch.cat([x, x]), torch.full((2 * x.shape[0],), t), None,
                                     ctx2).double().chunk(2)
        eps = uncond + guidance * (cond - uncond)
        a_t, a_prev = ab[t], ab[t_prev] if t_prev >= 0 else torch.ones((), dtype=torch.float64)
        x0 = ((x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)).clamp(-4.0, 4.0)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp_min(1 - a_prev, 0.0)) * eps
    return x


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=4)
    args = parser.parse_args()
    # diffusion_consistency's cut and draws
    rng = np.random.default_rng(45)
    cfg = UNetConfig(**{**cs.SD15_UNET, "channel_mults": (1,), "layers_per_block": 1, "attention_levels": (0,)})
    lat = cs.SD15_UNET["sample_size"]
    x = torch.as_tensor(rng.standard_normal((1, lat, lat, 4)), dtype=torch.float32)
    t = torch.tensor([500], dtype=torch.int32)
    ctx = torch.as_tensor(rng.standard_normal((1, cs.CLIP_L14["max_text_positions"], cs.SD15_UNET["context_dim"])),
                          dtype=torch.float32)
    sched = make_schedule()
    unet = create_unet_model(cfg, seed=7, device="cpu")
    with torch.no_grad():
        eps32 = unet.apply_fn(unet.params, x, t, None, ctx)
        sample32 = _sample(unet, 1, args.steps, sched, guidance_scale=cs.SD_GUIDANCE, encoder_hidden_states=ctx,
                           x_T=x)
        unet.module.double()
        eps64 = unet.apply_fn(unet.params, x.double(), t, None, ctx.double())
        sample64 = ddim_f64(unet, x, ctx, args.steps, cs.SD_GUIDANCE, sched)
    print(json.dumps({"what": "f32 against f64 on the CPU, over the f64 tensor's RMS", "steps": args.steps,
                      "guidance": cs.SD_GUIDANCE, "unet_eps": cs.cut_err(eps32, eps64),
                      "ddim_sample": cs.cut_err(sample32, sample64),
                      "sample_rms": float(sample64.pow(2).mean().sqrt())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
