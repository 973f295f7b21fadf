"""The port's one-card training step (accelerate_tpu_torch.Accelerator ->
build_train_step) against the JAX package's on a tiny Llama carrying the
same weights: the f32 loss trajectory and final parameters, gradient
accumulation, clipping set inside the loop, bf16 mixed precision and fp16
loss scaling; then the port's own rules (remat, the rng argument, the
scheduler on sync boundaries, what raises). The JAX side runs on the
suite's 8-device CPU mesh, so a batch is 8 sequences; the port runs on the
CPU. Token ids are made with numpy from a seed."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import causal_lm_loss as jax_causal_lm_loss
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu.utils.dataclasses import GradScalerKwargs as JaxGradScalerKwargs
from accelerate_tpu_torch import Accelerator, LlamaConfig, causal_lm_loss, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.models import llama as port_llama
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import GradScalerKwargs, MeshConfig, ParallelismPlugin
from accelerate_tpu_torch.utils.random import generator_for_step, set_seed

torch.set_num_threads(2)

SEQ, BATCH, LR, WD = 16, 8, 1e-3, 0.01


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(BATCH, SEQ)).astype(np.int32) for _ in range(n)]


@functools.cache
def _init_params():
    """The JAX tiny llama's initial params as numpy (stacked, scanned layout)."""
    model = jax_create_llama_model(JaxLlamaConfig.tiny(), seed=3, seq_len=SEQ)
    return jax.tree.map(np.asarray, model.params)


def _port_state(params, cfg):
    return {k: v.numpy() for k, v in llama_params_from_jax(params, cfg).items()}


def _run_jax(batches, mixed_precision="no", accum=1, clip=None, init_scale=None):
    """Losses, grad norms, final params (port names) and loss scales of the
    JAX step; ``clip=(i, norm)`` calls clip_grad_norm_ before step i."""
    handlers = [JaxGradScalerKwargs(init_scale=init_scale)] if init_scale else None
    acc = JaxAccelerator(mixed_precision=mixed_precision, gradient_accumulation_steps=accum, kwargs_handlers=handlers)
    model = jax_create_llama_model(JaxLlamaConfig.tiny(), seed=3, seq_len=SEQ)
    model = acc.prepare_model(model)
    acc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    step = acc.build_train_step(lambda p, b: jax_causal_lm_loss(p, b, model.apply_fn))
    losses, norms, scales = [], [], []
    for i, ids in enumerate(batches):
        if clip is not None and i == clip[0]:
            acc.clip_grad_norm_(max_norm=clip[1])
        losses.append(float(step(jax.device_put({"input_ids": jnp.asarray(ids)}, batch_sharding(acc.mesh)))))
        norms.append(float(acc._last_grad_norm))
        scales.append(float(acc._fast_scale_boxes[-1]["scale_state"]["scale"]))
    params = jax.tree.map(np.asarray, model.params)
    return losses, norms, _port_state(params, LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny()))), scales


def _port_model(remat=True):
    cfg = LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny(remat=remat)))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(_init_params(), cfg))
    return model


def _run_port(batches, mixed_precision="no", accum=1, clip=None, init_scale=None, remat=True):
    handlers = [GradScalerKwargs(init_scale=init_scale)] if init_scale else None
    model = _port_model(remat)
    # the optimizer is built before prepare_model: the masters keep their identity
    opt = torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD)
    acc = Accelerator(cpu=True, mixed_precision=mixed_precision, gradient_accumulation_steps=accum,
                      kwargs_handlers=handlers)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    losses, norms, scales = [], [], []
    for i, ids in enumerate(batches):
        if clip is not None and i == clip[0]:
            acc.clip_grad_norm_(max_norm=clip[1])
        losses.append(float(step({"input_ids": torch.tensor(ids)})))
        norms.append(float(acc._last_grad_norm))
        scales.append(acc._loss_scale)
    params = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return losses, norms, params, scales, acc, model, opt


def _assert_params_close(got, want, atol=1e-4):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0, err_msg=name)


def test_f32_trajectory_and_final_params_match_jax():
    batches = _batches(1) * 5  # one batch five times: the loss must fall
    j_losses, j_norms, j_params, _ = _run_jax(batches)
    losses, norms, params, _, acc, model, opt = _run_port(batches)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    _assert_params_close(params, j_params)
    assert losses[-1] < losses[0]
    # the optimizer built before prepare stepped the model's own parameters
    assert all(p is q for p, q in zip(opt.param_groups[0]["params"], model.module.parameters()))
    assert acc.step == 5


def test_gradient_accumulation_matches_jax():
    """accum 2 over 4 microbatches: two updates, each on the mean gradient."""
    batches = _batches(4, seed=1)
    j_losses, j_norms, j_params, _ = _run_jax(batches, accum=2)
    losses, norms, params, *_ = _run_port(batches, accum=2)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4, atol=1e-7)  # 0 off the boundaries
    assert norms[0] == 0 and norms[2] == 0 and norms[1] > 0
    _assert_params_close(params, j_params)


def test_clip_set_inside_the_loop_matches_jax():
    """clip_grad_norm_(0.5) before step 1 applies from step 1 on."""
    batches = _batches(3, seed=2)
    j_losses, j_norms, j_params, _ = _run_jax(batches, clip=(1, 0.5))
    losses, norms, params, *_ = _run_port(batches, clip=(1, 0.5))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    assert norms[1] > 0.5  # the pre-clip norm is returned
    _assert_params_close(params, j_params)


def test_bf16_mixed_precision():
    batches = _batches(1, seed=3)
    j_losses, *_ = _run_jax(batches, mixed_precision="bf16")
    losses, _, _, _, acc, model, _ = _run_port(batches, mixed_precision="bf16")
    assert abs(losses[0] - j_losses[0]) < 2e-2
    compute = acc._compute_cast(model.params)
    for name, t in compute.items():
        assert t.dtype == (torch.float32 if "norm" in name else torch.bfloat16), name
    for name, p in model.module.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name


def test_fp16_loss_scaling_skips_and_backs_off_like_jax():
    """init_scale 1e38 overflows: every boundary skips, the params stay,
    the scale halves each time, as in the JAX step."""
    batches = _batches(3, seed=4)
    *_, j_scales = _run_jax(batches, mixed_precision="fp16", init_scale=1e38)
    before = {k: v.detach().clone() for k, v in _port_model().module.state_dict().items()}
    _, _, params, scales, _, _, opt = _run_port(batches, mixed_precision="fp16", init_scale=1e38)
    assert opt.step_was_skipped
    np.testing.assert_allclose(scales, j_scales, rtol=1e-6)
    assert scales == [5e37, 2.5e37, 1.25e37]
    _assert_params_close(params, {k: v.numpy() for k, v in before.items()}, atol=0)


def test_remat_recomputes_each_layer_and_keeps_the_gradients(monkeypatch):
    calls = []
    forward = port_llama.LlamaLayer.forward

    def counting(self, *a, **kw):
        calls.append(1)
        return forward(self, *a, **kw)

    monkeypatch.setattr(port_llama.LlamaLayer, "forward", counting)
    grads = {}
    for remat in (True, False):
        calls.clear()
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        *_, model, _ = _run_port(_batches(1, seed=5), remat=remat)
        assert len(calls) == (4 if remat else 2)  # 2 layers, run again in the backward with remat
        grads[remat] = {n: p.grad.clone() for n, p in model.module.named_parameters()}
    for name in grads[True]:
        torch.testing.assert_close(grads[True][name], grads[False][name], rtol=1e-6, atol=1e-7)


def test_loss_fn_with_rng_gets_a_generator_per_step():
    set_seed(11)
    seen = []
    model = _port_model()
    acc = Accelerator(cpu=True)
    model = acc.prepare_model(model)
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=LR))

    def loss_fn(params, batch, rng):
        seen.append(torch.rand(3, generator=rng))
        return causal_lm_loss(params, batch, model.apply_fn)

    step = acc.build_train_step(loss_fn)
    ids = torch.tensor(_batches(1)[0])
    step({"input_ids": ids})
    step({"input_ids": ids})
    assert torch.equal(seen[0], torch.rand(3, generator=generator_for_step(0)))
    assert not torch.equal(seen[0], seen[1])


def test_has_aux_returns_the_aux():
    model = _port_model()
    acc = Accelerator(cpu=True)
    model = acc.prepare_model(model)
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=LR))
    step = acc.build_train_step(lambda p, b: (causal_lm_loss(p, b, model.apply_fn), {"n": b["input_ids"].numel()}),
                                has_aux=True)
    loss, aux = step({"input_ids": torch.tensor(_batches(1)[0])})
    assert aux == {"n": BATCH * SEQ} and torch.isfinite(loss)


def test_scheduler_and_dataloader_end_force_and_follow_sync():
    """The scheduler steps on sync boundaries only; the last batch of the
    active loader forces a sync mid-window."""
    model = _port_model()
    acc = Accelerator(cpu=True, gradient_accumulation_steps=4)
    model = acc.prepare_model(model)
    opt = acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=LR))
    sched = acc.prepare_scheduler(torch.optim.lr_scheduler.LambdaLR(opt.optimizer, lambda s: 0.5**s))
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    ids = {"input_ids": torch.tensor(_batches(1)[0])}
    step(ids)
    assert not acc.sync_gradients and sched.step_count == 0

    class Loader:
        end_of_dataloader = True

    acc.gradient_state._add_dataloader(Loader())
    step(ids)
    assert acc.sync_gradients and sched.step_count == 1
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * 0.5)


def test_what_is_not_ported_raises(monkeypatch):
    model = _port_model()
    acc = Accelerator(cpu=True)
    model = acc.prepare_model(model)
    acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=LR))
    with pytest.raises(ValueError, match="has_state"):  # ported; a model without mutable state is refused
        acc.build_train_step(lambda p, s, b: 0.0, has_state=True)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    with pytest.raises(NotImplementedError, match="one card"):
        Accelerator(cpu=True, parallelism_plugin=ParallelismPlugin(mesh_config=MeshConfig(data=2)))
    with pytest.raises(NotImplementedError, match="ZeRO"):
        ParallelismPlugin(zero_stage=1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="WORLD_SIZE"):
        Accelerator(cpu=True)


def test_accelerator_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Accelerator()
    assert Accelerator(cpu=True).device == torch.device("cpu")
