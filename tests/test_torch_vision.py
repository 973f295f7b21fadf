"""The port's ViT and CLIP (accelerate_tpu_torch.models.vit / .clip)
against the JAX package's on the same weights and inputs: the weights
carried across, ViT's logits (with and without remat), CLIP's embeddings,
logit scale and per-token text states on both pooling branches (the legacy
``eos_token_id == 2`` argmax and the first-EOS one), one tower at a time,
and three AdamW steps of ``vit_classification_loss`` and of
``clip_contrastive_loss`` through ``build_train_step``, losses step by
step. The JAX weights are perturbed before they cross (every leaf still
at its constant initial value: biases, norm scales, ViT's class token,
the logit scale), so a bias or a norm in the wrong place shows. f32
within 1e-5; the JAX steps run on the suite's 8-device CPU mesh (a batch
of 8 is one row a shard). Inputs come from numpy seeds."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from accelerate_tpu.models.clip import clip_contrastive_loss as jax_clip_loss
from accelerate_tpu.models.clip import create_clip_model as jax_create_clip_model
from accelerate_tpu.models.vit import ViTConfig as JaxViTConfig
from accelerate_tpu.models.vit import create_vit_model as jax_create_vit_model
from accelerate_tpu.models.vit import vit_classification_loss as jax_vit_loss
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import (
    CLIPConfig,
    ViTConfig,
    clip_contrastive_loss,
    clip_params_from_jax,
    create_clip_model,
    create_vit_model,
    vit_classification_loss,
    vit_params_from_jax,
)
from accelerate_tpu_torch.models.clip import quick_gelu
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

ATOL = 1e-5
BATCH, LR, WD, STEPS = 8, 1e-3, 1e-4, 3


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def perturbed(params, seed=1):
    """``params`` as numpy, every leaf still at one constant value (zero
    biases, unit scales, the class token, the logit scale) moved off it."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            return (a + rng.normal(0.0, 0.3, a.shape)).astype(np.float32)
        return a

    return jax.tree.map(move, params)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=what)


# --------------------------------------------------------------------------- #
# ViT
# --------------------------------------------------------------------------- #


@functools.cache
def _vit_jax():
    model = jax_create_vit_model(JaxViTConfig.tiny())
    return model, perturbed(model.params)


def _vit_port(params, **kw):
    cfg = ViTConfig.tiny(**kw)
    model = create_vit_model(cfg, device="cpu")
    model.load_state_dict(vit_params_from_jax(params))
    return model


def test_vit_params_from_jax_carries_every_weight():
    _, params = _vit_jax()
    sd = vit_params_from_jax(params)
    model = create_vit_model(ViTConfig.tiny(), device="cpu")
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    assert sd["block_0.attention.query.weight"].shape == (64, 64)
    assert sd["patch_embed.weight"].shape == (64, 3, 8, 8)  # [out, in, kh, kw]
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(),
                                  np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("remat", [False, True])
def test_vit_logits_match_jax(remat):
    """f32 logits (the f32 final norm and head on the class token, flax's
    tanh GELU) within 1e-5; remat changes nothing."""
    jmodel, params = _vit_jax()
    x = _images(4, 32)
    want = np.asarray(jmodel.apply_fn(params, x))
    model = _vit_port(params, remat=remat)
    with torch.no_grad():
        got = model.apply_fn(model.params, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    _close(got, want)


def test_vit_dropout_by_its_properties():
    """``deterministic=False`` with a generator drops activations (flax
    ``nn.Dropout``: ``jax.random`` and ``torch.Generator`` never agree, so
    by property): the same seed gives the same logits, with remat too (a
    seed a block, drawn once), another seed others; without a generator it
    refuses."""
    model = create_vit_model(ViTConfig.tiny(dropout_rate=0.3), device="cpu")
    remat = create_vit_model(ViTConfig.tiny(dropout_rate=0.3, remat=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    x = torch.from_numpy(_images(2, 32))

    def run(m, seed):
        return m.apply_fn(m.params, x, False, {"dropout": torch.Generator().manual_seed(seed)})

    with torch.no_grad():
        det = model.apply_fn(model.params, x)
        a, b, c = run(model, 0), run(model, 0), run(model, 1)
    assert not torch.equal(a, det) and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(remat, 0), a)  # grad mode on: the blocks run under checkpoint
    with pytest.raises(ValueError, match="rngs"):
        model.apply_fn(model.params, x, False)


def _jax_steps(jmodel, params, loss, batches):
    acc = JaxAccelerator()
    jmodel.params = jax.tree.map(jnp.asarray, params)
    jmodel = acc.prepare_model(jmodel)
    acc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    step = acc.build_train_step(lambda p, b: loss(p, b, jmodel.apply_fn))
    return [float(step(jax.device_put(jax.tree.map(jnp.asarray, b), batch_sharding(acc.mesh)))) for b in batches]


def _port_steps(model, loss, batches):
    acc = Accelerator(cpu=True)
    model = acc.prepare_model(model)
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD))
    step = acc.build_train_step(lambda p, b: loss(p, b, model.apply_fn))
    return [float(step({k: torch.from_numpy(v) for k, v in b.items()})) for b in batches]


def test_vit_three_adamw_steps_match_jax():
    """AdamW(1e-3, weight decay 1e-4) against optax.adamw from the same
    weights on three batches: the losses step by step within 1e-5."""
    rng = np.random.default_rng(3)
    batches = [{"images": _images(BATCH, 32, seed=i), "labels": rng.integers(0, 10, BATCH).astype(np.int32)}
               for i in range(STEPS)]
    _, params = _vit_jax()
    want = _jax_steps(jax_create_vit_model(JaxViTConfig.tiny()), params, jax_vit_loss, batches)
    got = _port_steps(_vit_port(params), vit_classification_loss, batches)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[-1] != got[0]


# --------------------------------------------------------------------------- #
# CLIP
# --------------------------------------------------------------------------- #


@functools.cache
def _clip_jax(eos=2):
    model = jax_create_clip_model(JaxCLIPConfig.tiny(eos_token_id=eos))
    return model, perturbed(model.params)


def _clip_port(params, eos=2):
    model = create_clip_model(CLIPConfig.tiny(eos_token_id=eos), device="cpu")
    model.load_state_dict(clip_params_from_jax(params))
    return model


def _ids(n, eos, seed=0):
    """[n, 16] ids: the legacy branch's EOS the row's highest id at a
    row-dependent place; the other branch's EOS (5) once or twice in a row
    (the first counts) and in one row not at all (pools at 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(6, 100, (n, 16)).astype(np.int32)
    for r in range(n):
        if eos == 2:
            ids[r, 3 + r] = 127
        elif r != 1:
            ids[r, 2 + r] = eos
            ids[r, 12] = eos
    return ids


def test_clip_params_from_jax_carries_every_weight():
    _, params = _clip_jax()
    sd = clip_params_from_jax(params)
    want = create_clip_model(CLIPConfig.tiny(), device="cpu").state_dict()
    assert sd.keys() == want.keys()
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    # flax names holding "/" were indexed whole
    np.testing.assert_array_equal(sd["vision.pos_embed"].numpy(), params["vision/pos_embed/embedding"])
    np.testing.assert_array_equal(sd["text.token_embed.weight"].numpy(), params["text/token_embed"]["embedding"])


@pytest.mark.parametrize("eos", [2, 5], ids=["argmax-pool", "first-eos-pool"])
def test_clip_forward_matches_jax(eos):
    """Both embeddings, the logit scale and the per-token text states
    (``output_hidden``) within 1e-5, on both pooling branches."""
    jmodel, params = _clip_jax(eos)
    pix, ids = _images(4, 16), _ids(4, eos)
    want = jmodel.module.apply({"params": params}, pix, ids, output_hidden=True)
    model = _clip_port(params, eos)
    with torch.no_grad():
        got = model.module(torch.from_numpy(pix), torch.from_numpy(ids), output_hidden=True)
    for g, w, what in zip(got, want, ("image_embeds", "text_embeds", "logit_scale", "text_hidden")):
        _close(g, w, what=what)
    np.testing.assert_allclose(torch.linalg.vector_norm(got[0], dim=-1).numpy(), 1.0, atol=1e-6)


def test_clip_encode_text_and_single_towers_match_jax():
    jmodel, params = _clip_jax()
    pix, ids = _images(2, 16, seed=4), _ids(2, 2, seed=4)
    model = _clip_port(params)
    with torch.no_grad():
        hidden = model.encode_text(model.params, torch.from_numpy(ids))
        img_only = model.apply_fn(model.params, torch.from_numpy(pix))
        txt_only = model.apply_fn(model.params, None, torch.from_numpy(ids))
    assert hidden.shape == (2, 16, 32)
    _close(hidden, jmodel.encode_text(params, ids))
    j_img, _, _ = jmodel.apply_fn(params, pix, None)
    _, j_txt, _ = jmodel.apply_fn(params, None, ids)
    assert img_only[1] is None and txt_only[0] is None
    _close(img_only[0], j_img)
    _close(txt_only[1], j_txt)


def test_quick_gelu_is_the_reference_activation():
    from accelerate_tpu.models.clip import quick_gelu as jax_quick_gelu

    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(quick_gelu(torch.from_numpy(x)), jax_quick_gelu(jnp.asarray(x)), atol=1e-6)


def test_clip_three_adamw_steps_match_jax():
    """``clip_contrastive_loss`` over 8 image-text pairs, AdamW against
    optax.adamw from the same weights: the losses step by step within
    1e-5."""
    batches = [{"pixel_values": _images(BATCH, 16, seed=10 + i), "input_ids": _ids(BATCH, 2, seed=10 + i)}
               for i in range(STEPS)]
    _, params = _clip_jax()
    want = _jax_steps(jax_create_clip_model(JaxCLIPConfig.tiny()), params, jax_clip_loss, batches)
    got = _port_steps(_clip_port(params), clip_contrastive_loss, batches)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[-1] != got[0]


def test_the_configs_are_the_reference_ones():
    """The copies keep the JAX package's fields and defaults."""
    for port, ref in ((ViTConfig, JaxViTConfig), (CLIPConfig, JaxCLIPConfig)):
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
        assert dataclasses.asdict(port.tiny()) == dataclasses.asdict(ref.tiny())
    assert dataclasses.asdict(ViTConfig.base()) == dataclasses.asdict(JaxViTConfig.base())
