"""The port's T5 (models/t5.py) against the JAX package's, at ``tiny()``
on the same weights (tests/torch_seq2seq_common.py): the bucket ids of
every relative position in +-4,096 both ways, exactly; forward logits in
f32 (with and without a padding mask, a tied and an untied head, remat)
and in bf16; ``seq2seq_lm_loss`` and its gradients, with ``-100`` labels
and ``decoder_loss_mask``; the relative bias in layer 0 only; the cached
decode step by step; one AdamW step through ``build_train_step`` (remat on
and off) and one fp8 step, each against the JAX Accelerator's. Inputs are
made with numpy from a seed; everything runs on the CPU."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import T5Config, create_t5_model, seq2seq_lm_loss, t5_params_from_jax
from accelerate_tpu_torch.models.t5 import _bucketize, relative_position_buckets
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from torch_seq2seq_common import SRC, decoder_ids, jax_model, jax_params, padding_mask, port_model, source

torch.set_num_threads(2)

F32_ATOL = 1e-5
GRAD_ATOL = LOSS_RTOL = PARAM_ATOL = 1e-4
BATCH, TGT, LR, WD = 8, 6, 1e-3, 0.01


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def test_config_matches_jax():
    for name in ("tiny", "small"):
        assert dataclasses.asdict(getattr(T5Config, name)()) == dataclasses.asdict(getattr(jt5.T5Config, name)())
    assert dataclasses.asdict(T5Config()) == dataclasses.asdict(jt5.T5Config())


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (32, 64)])
def test_bucket_ids_equal_jax_for_every_relative_position(buckets, distance, bidirectional):
    """Every rel in +-4,096: the f32 quotient lands exactly on a bin edge
    at some distances (|rel| 16, 32, 64 for (32, 128) both ways), where a
    one-ulp difference would truncate to the bucket below."""
    rel = np.arange(-4096, 4097)
    want = np.asarray(jt5._bucketize(jnp.asarray(rel), buckets, distance, bidirectional))
    got = _bucketize(torch.as_tensor(rel), buckets, distance, bidirectional)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q_len,k_len", [(7, 7), (1, 33), (12, 5)])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_relative_position_buckets_equal_jax(q_len, k_len, bidirectional):
    want = np.asarray(jt5.relative_position_buckets(q_len, k_len, 32, 128, bidirectional))
    got = relative_position_buckets(q_len, k_len, 32, 128, bidirectional)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_parameter_names_and_the_bias_only_in_layer_0(tied):
    """The converter fills every parameter; the relative bias table is
    layer 0's alone in each stack (the JAX tree has it nowhere else)."""
    cfg = T5Config.tiny(tie_word_embeddings=tied)
    model = create_t5_model(cfg, device="cpu")
    sd = t5_params_from_jax(jax_params("t5", tied), cfg)
    assert set(model.state_dict()) == set(sd)
    assert sorted(k for k in sd if "relative_bias" in k) == [
        "dec_layers.0.self_attn.relative_bias", "enc_layers.0.attn.relative_bias"]
    assert ("lm_head.weight" in sd) == (not tied)
    assert sd["enc_layers.0.attn.relative_bias"].shape == (cfg.relative_attention_num_buckets,
                                                           cfg.num_attention_heads)


def _forward(model, src, dec, mask):
    return model(torch.as_tensor(src), torch.as_tensor(dec), None if mask is None else torch.as_tensor(mask))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padded"])
def test_forward_logits_match_jax_f32(masked, tied, remat):
    """With ``remat`` the port runs in training mode with gradients on, so
    every layer goes through the recompute wrapper."""
    jmodel = jax_model("t5", tied, remat=remat)
    model = port_model("t5", tied, remat=remat)
    src, dec = source("t5"), decoder_ids()
    mask = padding_mask() if masked else None
    want = np.asarray(jmodel.apply_fn(jmodel.params, src, dec, mask))
    if remat:
        model.module.train()
        model.module.requires_grad_(True)
    got = _forward(model, src, dec, mask)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL, rtol=0)


def test_forward_logits_match_jax_bf16():
    """A bf16 stream on the same bf16-rounded weights: 4 bf16 ulps of the
    largest logit (the tied head scales in bf16, then multiplies in f32)."""
    jmodel, model = jax_model("t5", dtype=jnp.bfloat16), port_model("t5", dtype=torch.bfloat16)
    src, dec, mask = source("t5", seed=3), decoder_ids(seed=4), padding_mask()
    want = np.asarray(jmodel.apply_fn(jmodel.params, src, dec, mask)).astype(np.float32)
    got = _forward(model, src, dec, mask)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, atol=4 * ulp, rtol=0)


def _batch(seed, variant):
    """A batch of 8: source ids and mask, labels with a ``-100`` tail, and
    the variant's extra key."""
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(2, 256, size=(BATCH, SRC)).astype(np.int32),
             "attention_mask": np.arange(SRC)[None] < rng.integers(3, SRC + 1, size=(BATCH, 1)),
             "labels": rng.integers(0, 256, size=(BATCH, TGT)).astype(np.int32)}
    batch["labels"][:, -2:] = -100
    batch["labels"][0, 1] = -100  # a -100 that shifts into the decoder input
    if variant == "loss_mask":
        batch["decoder_loss_mask"] = (rng.random((BATCH, TGT)) < 0.7).astype(np.float32)
    if variant == "decoder_input_ids":
        batch["decoder_input_ids"] = rng.integers(0, 256, size=(BATCH, TGT)).astype(np.int32)
    if variant == "all_ignored":
        batch["labels"][:] = -100
    return batch


@pytest.mark.parametrize("variant", ["shifted", "loss_mask", "decoder_input_ids", "all_ignored"])
def test_seq2seq_lm_loss_and_gradients_match_jax(variant):
    jmodel, model = jax_model("t5"), port_model("t5")
    batch = _batch(5, variant)
    want, grads = jax.value_and_grad(lambda p: jt5.seq2seq_lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jmodel.apply_fn))(jmodel.params)
    model.module.requires_grad_(True)
    got = seq2seq_lm_loss(model.params, {k: torch.as_tensor(v) for k, v in batch.items()}, model.apply_fn)
    assert float(got.detach()) == pytest.approx(float(want), abs=F32_ATOL)
    got.backward()
    want_grads = t5_params_from_jax(jax.tree.map(np.asarray, grads), model.config)
    for name, p in model.module.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, want_grads[name].numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("prefill", [1, 3])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padded"])
def test_cached_decode_matches_jax_step_by_step(masked, prefill):
    """The prefill (encoder, stored output and mask, cross K/V, ``prefill``
    decoder tokens) and then one token a step: every step's logits within
    1e-5 of ``apply_fn(decode=True)``'s; the cache's index is the decoder
    position and its cross K/V and encoder output are f32."""
    jmodel, model = jax_model("t5"), port_model("t5")
    src, dec = source("t5", seed=2), decoder_ids(s=8, seed=6)
    mask = padding_mask() if masked else None
    logits, jcache = jmodel.apply_fn(jmodel.params, src, dec[:, :prefill], mask, decode=True, cache=None)
    got, cache = model(torch.as_tensor(src), torch.as_tensor(dec[:, :prefill]),
                       None if mask is None else torch.as_tensor(mask), decode=True, cache=None)
    errs = [float(np.abs(got.numpy() - np.asarray(logits)).max())]
    for i in range(prefill, 8):
        logits, jcache = jmodel.apply_fn(jmodel.params, src, dec[:, i:i + 1], decode=True, cache=jcache)
        got, cache = model(torch.as_tensor(src), torch.as_tensor(dec[:, i:i + 1]), decode=True, cache=cache)
        errs.append(float(np.abs(got.numpy() - np.asarray(logits)).max()))
    assert max(errs) <= F32_ATOL, errs
    assert cache.self_kv.index == 8
    assert cache.enc_out.dtype == torch.float32 and cache.cross_key[0].dtype == torch.float32


def _jax_step(jmodel, batch, opt):
    jacc = JaxAccelerator(mixed_precision=opt.get("mixed_precision", "no"))
    if opt.get("f32_compute"):
        jacc.state.dtype_policy.compute_dtype = "float32"
    jmodel = jacc.prepare_model(jmodel)
    jacc.prepare_optimizer(opt["jax_opt"])
    step = jacc.build_train_step(lambda p, b: jt5.seq2seq_lm_loss(p, b, jmodel.apply_fn))
    loss = float(step(jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, batch_sharding(jacc.mesh))))
    return loss, jax.tree.map(np.asarray, jmodel.params)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_matches_jax(remat):
    """One AdamW step, f32: the loss, then every parameter. The JAX side
    runs on the suite's 8-device CPU mesh (a batch of 8); an element whose
    gradient is under 1e-6 (about 100 times Adam's eps) follows the
    rounding of ``g / (|g| + eps)`` and is held to 2 lr."""
    batch = _batch(9, "shifted")
    want_loss, want_params = _jax_step(jax_model("t5", remat=remat), batch, {"jax_opt": optax.adamw(LR, weight_decay=WD)})
    model = port_model("t5", remat=remat)
    want = t5_params_from_jax(want_params, model.config)
    model.module.requires_grad_(True)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    seq2seq_lm_loss(model.params, tbatch, model.apply_fn).backward()
    tiny_grad = {n: p.grad.abs() < 1e-6 for n, p in model.module.named_parameters()}
    model.module.zero_grad(set_to_none=True)
    acc = Accelerator(cpu=True)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD))
    step = acc.build_train_step(lambda p, b: seq2seq_lm_loss(p, b, model.apply_fn))
    assert float(step(tbatch)) == pytest.approx(want_loss, rel=LOSS_RTOL)
    got = model.state_dict()
    for name in want:
        atol = torch.where(tiny_grad[name], 2 * LR, PARAM_ATOL)
        err = (got[name] - want[name]).abs()
        assert bool((err <= atol).all()), f"{name}: {float((err - atol).max())} past its tolerance"


def test_fp8_step_matches_jax():
    """Under ``mixed_precision="fp8"`` (compute dtype set to f32 in both
    packages, as tests/test_torch_fp8.py holds the fp8 paths alone) every
    projection takes the dynamic fp8 product in both: one SGD step's loss
    and the update as a whole (relative error) against the JAX step's; the
    products are the plain version here (no launch counted)."""
    batch = _batch(11, "shifted")
    want_loss, want_params = _jax_step(jax_model("t5"), batch, {"jax_opt": optax.sgd(0.5), "mixed_precision": "fp8",
                                                                 "f32_compute": True})
    model = port_model("t5")
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    acc.state.dtype_policy.compute_dtype = "float32"
    model, _ = acc.prepare(model, torch.optim.SGD(model.module.parameters(), lr=0.5))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = acc.build_train_step(lambda p, b: seq2seq_lm_loss(p, b, model.apply_fn))
    launches = fp8.launches
    got_loss = float(step({k: torch.as_tensor(v) for k, v in batch.items()}))
    assert fp8.launches == launches
    assert got_loss == pytest.approx(want_loss, abs=1e-4)
    want = t5_params_from_jax(want_params, model.config)
    got = model.state_dict()
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float(((w - before[n]) ** 2).sum()) for n, w in want.items())
    assert (num / den) ** 0.5 <= 1e-3


def test_remat_recomputes_each_layer_in_the_backward():
    """With ``remat`` every layer of both stacks runs again in the backward
    (a forward counter on each stack's layer 0), and the gradients equal
    the plain backward's."""
    grads, calls = {}, {}
    src, dec = torch.as_tensor(source("t5")), torch.as_tensor(decoder_ids())
    for remat in (False, True):
        model = port_model("t5", remat=remat)
        model.module.train()
        model.module.requires_grad_(True)
        n = [0, 0]
        model.module.enc_layers[0].attn.register_forward_pre_hook(lambda *a: n.__setitem__(0, n[0] + 1))
        model.module.dec_layers[0].cross_attn.register_forward_pre_hook(lambda *a: n.__setitem__(1, n[1] + 1))
        model(src, dec).sum().backward()
        calls[remat] = tuple(n)
        grads[remat] = {k: p.grad.clone() for k, p in model.module.named_parameters()}
    assert calls == {False: (1, 1), True: (2, 2)}
    for k in grads[False]:
        torch.testing.assert_close(grads[True][k], grads[False][k], atol=1e-6, rtol=0)
