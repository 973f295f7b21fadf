"""The port's UNet2D, VAE and diffusion loop (accelerate_tpu_torch.models.unet
/ .vae, accelerate_tpu_torch.diffusion) against the JAX package's on the
same weights and inputs: the UNet's noise prediction unconditional, class-
and text-conditional; the VAE's reconstruction, encode (the mean, and a
sampled latent from the JAX package's draw) and decode; ``make_schedule``;
``diffusion_loss``, ``latent_diffusion_loss`` and ``vae_loss`` from the
JAX package's draws, replayed from its key splits; DDIM ``sample`` and
``text_to_image`` from its x_T with and without guidance; DDPM and the
generators by their properties; every ``ValueError``; the nearest 2x
upsample and the stride-2 SAME padding; the losses through
``build_train_step``. The JAX weights are perturbed before they cross
(every leaf still at its constant initial value: biases, GroupNorm scales),
so a bias or a norm in the wrong place shows. f32 within 1e-5 unless a
test says otherwise; ``jax.random`` and ``torch.Generator`` never agree, so
the private seams take the JAX package's draws as tensors."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import diffusion as jax_diffusion
from accelerate_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from accelerate_tpu.models.clip import create_clip_model as jax_create_clip_model
from accelerate_tpu.models.unet import UNetConfig as JaxUNetConfig
from accelerate_tpu.models.unet import create_unet_model as jax_create_unet_model
from accelerate_tpu.models.unet import timestep_embedding as jax_timestep_embedding
from accelerate_tpu.models.vae import VAEConfig as JaxVAEConfig
from accelerate_tpu.models.vae import create_vae_model as jax_create_vae_model
from accelerate_tpu.models.vae import vae_loss as jax_vae_loss
from accelerate_tpu_torch import Accelerator, diffusion
from accelerate_tpu_torch.models import (
    CLIPConfig,
    UNetConfig,
    VAEConfig,
    clip_params_from_jax,
    create_clip_model,
    create_unet_model,
    create_vae_model,
    unet_params_from_jax,
    vae_loss,
    vae_params_from_jax,
)
from accelerate_tpu_torch.models import unet as port_unet
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

ATOL = 1e-5
# DDIM from x_T: the first step divides the predicted noise by sqrt(abar_999) = 6.4e-3 (x156) and guidance
# multiplies cond - uncond by 7.5, so an f32 rounding of the noise becomes ~1e-4 of the sample. The f64 floor
# (the port's UNet and loop in f64 from the same x_T, 4 steps, samples of RMS ~3): the JAX package's f32
# samples 2.5e-5 to 1.4e-4 from it, the port's 3.4e-5 to 1.9e-4; the two packages 4.4e-5 to 2.3e-4 apart.
# Held to 4e-4.
SAMPLE_ATOL = 4e-4
# text_to_image's images, decoded from those latents by the VAE (its 1 / scaling_factor and a decoder with
# no norm before its first ResBlock): 1.3e-5 apart at most; held to 5e-5
IMAGE_ATOL = 5e-5
T = 1000
TEXT = 32  # the tiny CLIP's text width: the text-conditional UNet's context_dim
SCHED = jax_diffusion.make_schedule()


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def perturbed(params, seed=1):
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            return (a + rng.normal(0.0, 0.3, a.shape)).astype(np.float32)
        return a

    return jax.tree.map(move, params)


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=what)


UNET_KINDS = {
    "uncond": dict(in_channels=2, out_channels=2),
    "class": dict(in_channels=2, out_channels=2, num_classes=5),
    # attention on both levels, so the cross-attention runs at 8 x 8 and 4 x 4
    "text": dict(in_channels=2, out_channels=2, context_dim=TEXT, attention_levels=(0, 1)),
}


@functools.cache
def _unet(kind):
    """(JAX model with the perturbed params, the params, the port model)."""
    jmodel = jax_create_unet_model(JaxUNetConfig.tiny(**UNET_KINDS[kind]))
    params = perturbed(jmodel.params)
    jmodel.params = jax.tree.map(jnp.asarray, params)
    model = create_unet_model(UNetConfig.tiny(**UNET_KINDS[kind]), device="cpu")
    model.load_state_dict(unet_params_from_jax(params))
    return jmodel, params, model


@functools.cache
def _vae():
    jmodel = jax_create_vae_model(JaxVAEConfig.tiny())
    params = perturbed(jmodel.params)
    jmodel.params = jax.tree.map(jnp.asarray, params)
    model = create_vae_model(VAEConfig.tiny(), device="cpu")
    model.load_state_dict(vae_params_from_jax(params))
    return jmodel, params, model


@functools.cache
def _clip():
    jmodel = jax_create_clip_model(JaxCLIPConfig.tiny())
    params = perturbed(jmodel.params)
    jmodel.params = jax.tree.map(jnp.asarray, params)
    model = create_clip_model(CLIPConfig.tiny(), device="cpu")
    model.load_state_dict(clip_params_from_jax(params))
    return jmodel, params, model


def _normal(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ids(n, seed=0):
    ids = np.random.default_rng(seed).integers(3, 100, (n, 16)).astype(np.int32)
    ids[np.arange(n), 4 + np.arange(n)] = 127  # the legacy EOS: the row's highest id
    return ids


def _cond(kind, n, seed=0):
    """(JAX keyword arguments, port positional extras) of a UNet call."""
    if kind == "class":
        labels = np.arange(n, dtype=np.int32) % 5
        return {"class_labels": labels}, (torch.from_numpy(labels),)
    if kind == "text":
        ctx = _normal((n, 7, TEXT), seed + 50)
        return {"encoder_hidden_states": ctx}, (None, torch.from_numpy(ctx))
    return {}, ()


# --------------------------------------------------------------------------- #
# the UNet
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", list(UNET_KINDS))
def test_unet_params_from_jax_carries_every_weight(kind):
    _, params, model = _unet(kind)
    sd = unet_params_from_jax(params)
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    assert "down_0_0.norm_1.gn.weight" in sd and "conv_out.weight" in sd


@pytest.mark.parametrize("kind", list(UNET_KINDS))
def test_unet_forward_matches_jax(kind):
    """The noise prediction ``[B, H, W, out]`` f32 within 1e-5, at mixed
    timesteps (0 and the last included)."""
    jmodel, params, model = _unet(kind)
    x, t = _normal((3, 8, 8, 2), 1), np.array([0, 417, T - 1], np.int32)
    kw, extra = _cond(kind, 3)
    want = np.asarray(jmodel.apply_fn(params, x, t, **kw))
    with torch.no_grad():
        got = model.apply_fn(model.params, torch.from_numpy(x), torch.from_numpy(t), *extra)
    assert got.dtype == torch.float32 and got.shape == (3, 8, 8, 2)
    _close(got, want)


def test_unet_dropout_by_its_properties():
    """A ResBlock's dropout under ``deterministic=False`` draws from the
    ``dropout`` generator: the same seed gives the same prediction, another
    seed another; without a generator it refuses."""
    model = create_unet_model(UNetConfig.tiny(dropout=0.5), device="cpu")
    x, t = torch.from_numpy(_normal((2, 8, 8, 3), 60)), torch.tensor([3, 700])

    def run(seed):
        return model.apply_fn(model.params, x, t, None, None, False) if seed is None else model.module(
            x, t, deterministic=False, rngs={"dropout": torch.Generator().manual_seed(seed)})

    with torch.no_grad():
        det, a, b, c = model.apply_fn(model.params, x, t), run(0), run(0), run(1)
        assert not torch.equal(a, det) and torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="rngs"):
            run(None)


def test_unet_refuses_a_missing_condition_like_jax():
    for kind, match in (("class", "class_labels"), ("text", "encoder_hidden_states")):
        jmodel, params, model = _unet(kind)
        x, t = np.zeros((1, 8, 8, 2), np.float32), np.zeros((1,), np.int32)
        with pytest.raises(ValueError, match=match):
            jmodel.apply_fn(params, x, t)
        with pytest.raises(ValueError, match=match):
            model.apply_fn(model.params, torch.from_numpy(x), torch.from_numpy(t))


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 250, 999], np.int32)
    _close(port_unet.timestep_embedding(torch.from_numpy(t), dim), jax_timestep_embedding(jnp.asarray(t), dim),
           atol=1e-6)


def test_nearest_upsample_is_jax_resize():
    """Row and column ``i`` of the 2x output read ``i // 2``, as
    ``jax.image.resize(..., "nearest")`` at exactly 2x."""
    x = _normal((2, 5, 6, 3))
    want = jax.image.resize(jnp.asarray(x), (2, 10, 12, 3), "nearest")
    got = port_unet.upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x[:, np.arange(10) // 2][:, :, np.arange(12) // 2])


@pytest.mark.parametrize("size", [8, 9])
def test_stride2_same_padding_is_flax(size):
    """A 3x3 stride-2 SAME convolution pads (0, 1) on an even size and (1, 1)
    on an odd one, as flax's ``nn.Conv(padding="SAME")``."""
    x, w, b = _normal((2, size, size, 3)), _normal((3, 3, 3, 4), 1), _normal((4,), 2)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    conv = torch.nn.Conv2d(3, 4, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(b))
        got = port_unet.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2), conv, stride=2).permute(0, 2, 3, 1)
    assert got.shape == (2, (size + 1) // 2, (size + 1) // 2, 4)
    _close(got, want)


# --------------------------------------------------------------------------- #
# the VAE
# --------------------------------------------------------------------------- #


def test_vae_params_from_jax_carries_every_weight():
    _, params, model = _vae()
    sd = vae_params_from_jax(params)
    assert sd.keys() == model.state_dict().keys()
    assert "encoder.latent_head.weight" in sd and "decoder.upsample_1.weight" in sd


def test_vae_reconstruction_encode_and_decode_match_jax():
    """``rng=None``: the mean's reconstruction, the scaled mean latents and
    the moments, and the decode of given latents, within 1e-5."""
    jmodel, params, model = _vae()
    x, z = _normal((2, 16, 16, 3), 3), _normal((2, 8, 8, 2), 4)
    p = model.params
    with torch.no_grad():
        got_rec = model.apply_fn(p, torch.from_numpy(x))
        got_enc = model.encode_fn(p, torch.from_numpy(x))
        got_dec = model.decode_fn(p, torch.from_numpy(z))
    for g, w, what in zip((*got_rec, *got_enc, got_dec),
                          (*jmodel.apply_fn(params, x), *jmodel.encode_fn(params, x), jmodel.decode_fn(params, z)),
                          ("recon", "mean", "logvar", "latents", "mean", "logvar", "decoded")):
        _close(g, w, what=what)
    assert got_dec.shape == (2, 16, 16, 3) and got_enc[0].shape == (2, 8, 8, 2)


def test_vae_sampled_encode_and_loss_match_jax_from_its_draw():
    """``encode_fn`` and ``vae_loss`` with an rng: the JAX package's draw
    ``normal(rng, mean.shape)`` fed in as ``_eps`` gives its latents and
    its loss."""
    jmodel, params, model = _vae()
    x = _normal((2, 16, 16, 3), 5)
    key = jax.random.key(7)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (2, 8, 8, 2))))
    want_z = jmodel.encode_fn(params, x, key)[0]
    want_loss = jax_vae_loss(params, {"pixel_values": x}, jmodel.apply_fn, key)
    with torch.no_grad():
        got_z = model.module(torch.from_numpy(x), None, "encode", _eps=eps)[0]
        got_loss = vae_loss(model.params, {"pixel_values": torch.from_numpy(x)},
                            lambda p, px, rng: model.module(px, rng, _eps=eps))
    _close(got_z, want_z)
    _close(got_loss, want_loss)


def test_vae_sampling_by_its_properties():
    """A generator-drawn latent is ``mean + exp(logvar / 2) eps`` with eps
    standard normal: the same seed gives the same latent, another seed
    another; ``rng=None`` is the mean, scaled."""
    _, _, model = _vae()
    x = torch.from_numpy(_normal((8, 16, 16, 3), 6))
    with torch.no_grad():
        z1, mean, logvar = model.encode_fn(model.params, x, torch.Generator().manual_seed(1))
        z1b = model.encode_fn(model.params, x, torch.Generator().manual_seed(1))[0]
        z2 = model.encode_fn(model.params, x, torch.Generator().manual_seed(2))[0]
        z0 = model.encode_fn(model.params, x)[0]
    s = VAEConfig.tiny().scaling_factor
    assert torch.equal(z1, z1b) and not torch.equal(z1, z2)
    torch.testing.assert_close(z0, mean * s)
    eps = (z1 / s - mean) / torch.exp(0.5 * logvar)
    assert abs(eps.mean().item()) < 0.1 and abs(eps.std().item() - 1.0) < 0.1


# --------------------------------------------------------------------------- #
# schedule, losses
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_make_schedule_is_the_reference(kind):
    want, got = jax_diffusion.make_schedule(T, kind=kind), diffusion.make_schedule(T, kind=kind)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        if name != "num_train_steps":
            assert got[name].dtype == np.float32


def _jax_noise_draws(key, shape):
    """``_add_noise``'s draws from its key: ``(t, noise)``."""
    t_key, n_key = jax.random.split(key)
    t = jax.random.randint(t_key, (shape[0],), 0, T)
    return np.array(t), np.array(jax.random.normal(n_key, shape, jnp.float32))


@pytest.mark.parametrize("kind", ["uncond", "class"])
def test_diffusion_loss_matches_jax_from_its_draws(kind):
    jmodel, params, model = _unet(kind)
    x = _normal((3, 8, 8, 2), 8)
    batch = {"images": x}
    if kind == "class":
        batch["labels"] = np.array([0, 4, 2], np.int32)
    key = jax.random.key(11)
    want = jax_diffusion.diffusion_loss(params, batch, jmodel.apply_fn, SCHED, key)
    t, noise = _jax_noise_draws(key, x.shape)
    labels = torch.from_numpy(batch["labels"]) if "labels" in batch else None
    with torch.no_grad():
        got = diffusion._noise_mse(model.params, model.apply_fn, SCHED, torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(noise), labels)
    _close(got, want)


def test_latent_diffusion_loss_matches_jax_from_its_draws():
    """The frozen VAE encoder (sampled) and CLIP text tower inside the loss,
    half the rows' conditioning dropped: the JAX package's three key
    splits replayed (the encoder's eps, the keep mask, then t and the
    noise)."""
    junet, uparams, unet = _unet("text")
    jvae, _, vae = _vae()
    jclip, cparams, clip = _clip()
    x, ids = _normal((4, 16, 16, 3), 9), _ids(4, 9)
    key = jax.random.key(5)
    loss = functools.partial(jax_diffusion.latent_diffusion_loss, apply_fn=junet.apply_fn, schedule=SCHED, vae=jvae,
                             text_encoder=jclip.encode_text, cond_drop_prob=0.5)
    want = jax.jit(lambda p, b, k, tp: loss(p, b, rng=k, text_params=tp))(
        uparams, {"pixel_values": x, "input_ids": ids}, key, cparams)
    enc_key, noise_key, drop_key = jax.random.split(key, 3)
    eps = torch.from_numpy(np.array(jax.random.normal(enc_key, (4, 8, 8, 2))))
    keep = torch.from_numpy(np.array(jax.random.bernoulli(drop_key, 0.5, (4,))))
    assert 0 < int(keep.sum()) < 4  # both branches of the drop run
    t, noise = _jax_noise_draws(noise_key, (4, 8, 8, 2))
    with torch.no_grad():
        latents = vae.module(torch.from_numpy(x), None, "encode", _eps=eps)[0]
        ctx = clip.encode_text(clip.params, torch.from_numpy(ids))
        got = diffusion._latent_mse(unet.params, unet.apply_fn, SCHED, latents, ctx, keep, torch.from_numpy(t),
                                    torch.from_numpy(noise))
    _close(got, want)


def test_losses_train_through_build_train_step():
    """``build_train_step`` hands each loss the step's generator as ``rng``:
    two steps of ``diffusion_loss``, ``latent_diffusion_loss`` (the frozen
    VAE and CLIP text tower in the step, ``input_ids`` in the batch) and
    ``vae_loss``, each finite and moving the weights; the frozen models
    stay as they were."""
    _, _, vae = _vae()
    _, _, clip = _clip()
    vae_before = {k: v.clone() for k, v in vae.state_dict().items()}
    x, ids, imgs = torch.from_numpy(_normal((4, 16, 16, 3), 12)), torch.from_numpy(_ids(4)), _normal((4, 8, 8, 2))
    cases = (
        ("uncond", lambda m: lambda p, b, rng: diffusion.diffusion_loss(p, b, m.apply_fn, SCHED, rng),
         {"images": torch.from_numpy(imgs)}),
        ("text", lambda m: lambda p, b, rng: diffusion.latent_diffusion_loss(
            p, b, m.apply_fn, SCHED, rng, vae=vae, text_encoder=clip.encode_text, text_params=clip.params),
         {"pixel_values": x, "input_ids": ids}),
        ("vae", lambda m: lambda p, b, rng: vae_loss(p, b, m.apply_fn, rng), {"pixel_values": x}),
    )
    for kind, loss, batch in cases:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        acc = Accelerator(cpu=True)
        model = create_vae_model(VAEConfig.tiny(), device="cpu") if kind == "vae" else create_unet_model(
            UNetConfig.tiny(**UNET_KINDS[kind]), device="cpu")
        model = acc.prepare_model(model)
        acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=1e-3))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = acc.build_train_step(loss(model))
        losses = [float(step(batch)) for _ in range(2)]
        assert all(np.isfinite(losses)), (kind, losses)
        assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items()), kind
    for k, v in vae.state_dict().items():
        assert torch.equal(vae_before[k], v), k


# --------------------------------------------------------------------------- #
# the samplers
# --------------------------------------------------------------------------- #

SAMPLE_CASES = {
    "uncond": dict(),
    "class-guided": dict(class_labels=np.array([1, 3], np.int32), guidance_scale=3.0),
    "text": dict(encoder_hidden_states=_normal((2, 7, TEXT), 20)),
    "text-guided": dict(encoder_hidden_states=_normal((2, 7, TEXT), 20), guidance_scale=7.5,
                        uncond_hidden_states=_normal((2, 7, TEXT), 21)),
    "text-guided-zeros": dict(encoder_hidden_states=_normal((2, 7, TEXT), 20), guidance_scale=7.5),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_ddim_sample_matches_jax_from_its_x_T(case):
    """4 DDIM steps (eta 0) from the JAX package's x_T (``normal(key(seed),
    shape)``): every branch of the conditioning and of the guidance within
    SAMPLE_ATOL (f32's own distance from f64 there, see above)."""
    kind = case.split("-")[0] if case != "class-guided" else "class"
    jmodel, _, model = _unet(kind)
    kw = SAMPLE_CASES[case]
    want = jax_diffusion.sample(jmodel, 2, num_steps=4, schedule=SCHED, seed=3, **kw)
    x_T = np.array(jax.random.normal(jax.random.key(3), (2, 8, 8, 2), jnp.float32))
    pkw = {k: torch.from_numpy(v) for k, v in kw.items() if isinstance(v, np.ndarray)}
    got = diffusion._sample(model, 2, num_steps=4, schedule=SCHED, guidance_scale=kw.get("guidance_scale"),
                            x_T=torch.from_numpy(x_T), **pkw)
    assert got.shape == (2, 8, 8, 2) and got.dtype == torch.float32
    _close(got, want, SAMPLE_ATOL)


def test_ddpm_and_eta_by_their_properties():
    """DDPM and DDIM with eta > 0 draw noise every step but the last: from
    one x_T another seed gives another sample, the same seed the same;
    DDIM at eta 0 ignores the seed. The public ``sample`` draws x_T from
    the seed."""
    _, _, model = _unet("uncond")
    x_T = torch.from_numpy(_normal((2, 8, 8, 2), 30))

    def run(seed, **kw):
        return diffusion._sample(model, 2, num_steps=5, schedule=SCHED, seed=seed, x_T=x_T, **kw)

    for kw in ({"method": "ddpm"}, {"eta": 0.7}):
        a, b, c = run(0, **kw), run(0, **kw), run(1, **kw)
        assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(0), run(1))
    s0, s0b, s1 = (diffusion.sample(model, 2, num_steps=2, schedule=SCHED, seed=s) for s in (0, 0, 1))
    assert torch.equal(s0, s0b) and not torch.equal(s0, s1)


@pytest.mark.parametrize("guidance", [7.5, None], ids=["guided-batched", "unguided-unbatched"])
def test_text_to_image_matches_jax_from_its_x_T(guidance):
    """Prompts through CLIP's text tower, 3 DDIM steps from the JAX package's
    x_T, the VAE's decoder: images within IMAGE_ATOL. Guided: two prompts
    and the empty prompt's ids as one row, broadcast; unguided: one
    unbatched prompt."""
    junet, _, unet = _unet("text")
    jvae, _, vae = _vae()
    jclip, _, clip = _clip()
    prompt = _ids(2, 40) if guidance else _ids(1, 41)[0]
    un = None
    if guidance:
        un = np.zeros(16, np.int32)
        un[0] = 127
    n = 1 if prompt.ndim == 1 else prompt.shape[0]
    want = jax_diffusion.text_to_image(junet, jvae, jclip, prompt, un, guidance_scale=guidance, num_steps=3,
                                       schedule=SCHED, seed=2)
    x_T = np.array(jax.random.normal(jax.random.key(2), (n, 8, 8, 2), jnp.float32))
    got = diffusion._text_to_image(unet, vae, clip, torch.from_numpy(prompt),
                                   None if un is None else torch.from_numpy(un), guidance_scale=guidance,
                                   num_steps=3, schedule=SCHED, x_T=torch.from_numpy(x_T))
    assert got.shape == (n, 16, 16, 3)
    _close(got, want, IMAGE_ATOL)


@pytest.mark.parametrize(
    "kind,kw,match",
    [
        ("uncond", {"num_steps": 0}, r"num_steps must be in \[1, 1000\]"),
        ("uncond", {"num_steps": 1001}, r"num_steps must be in \[1, 1000\]"),
        ("uncond", {"method": "euler"}, "method must be ddim|ddpm"),
        ("uncond", {"guidance_scale": 2.0}, "guidance needs a class-conditional or text-conditional UNet"),
        ("class", {}, "class-conditional UNet needs class_labels"),
        ("text", {}, "text-conditional UNet needs encoder_hidden_states"),
    ],
)
def test_sample_refuses_like_jax(kind, kw, match):
    jmodel, _, model = _unet(kind)
    with pytest.raises(ValueError, match=match):
        jax_diffusion.sample(jmodel, 1, schedule=SCHED, **kw)
    with pytest.raises(ValueError, match=match):
        diffusion.sample(model, 1, schedule=SCHED, **kw)


def test_schedule_and_latent_loss_refusals_match_jax():
    with pytest.raises(ValueError, match="kind must be linear|cosine"):
        jax_diffusion.make_schedule(kind="sigmoid")
    with pytest.raises(ValueError, match="kind must be linear|cosine"):
        diffusion.make_schedule(kind="sigmoid")
    jvae, _, vae = _vae()
    junet, uparams, unet = _unet("text")
    x = _normal((1, 16, 16, 3))
    with pytest.raises(ValueError, match="need encoder_hidden_states in the batch or a text_encoder"):
        jax_diffusion.latent_diffusion_loss(uparams, {"pixel_values": x}, junet.apply_fn, SCHED, jax.random.key(0),
                                            vae=jvae)
    with pytest.raises(ValueError, match="need encoder_hidden_states in the batch or a text_encoder"):
        diffusion.latent_diffusion_loss(unet.params, {"pixel_values": torch.from_numpy(x)}, unet.apply_fn, SCHED,
                                        torch.Generator(), vae=vae)


def test_the_configs_are_the_reference_ones():
    for port, ref in ((UNetConfig, JaxUNetConfig), (VAEConfig, JaxVAEConfig)):
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
        assert dataclasses.asdict(port.tiny()) == dataclasses.asdict(ref.tiny())
    assert VAEConfig.tiny().latent_size == JaxVAEConfig.tiny().latent_size == 8


def test_entry_points_run_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    """The four families' ``create_*`` pick the card by default: without one
    they refuse, and ``device="cpu"`` builds on the CPU."""
    from accelerate_tpu_torch.models import ViTConfig, create_vit_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for create, cfg in ((create_vit_model, ViTConfig.tiny()), (create_clip_model, CLIPConfig.tiny()),
                        (create_unet_model, UNetConfig.tiny()), (create_vae_model, VAEConfig.tiny())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create(cfg)
        assert create(cfg, device="cpu").device.type == "cpu"
