"""The port's imperative training path (``Accelerator.accumulate`` /
``backward`` / ``optimizer.step`` / ``zero_grad``, ``clip_grad_norm_``,
``clip_grad_value_``, ``no_sync``) against the JAX package's imperative
loop, against a plain loop, and against the port's own
``build_train_step``, which it must equal bit for bit. Mirrors
tests/test_accelerator.py's imperative cases. The JAX side runs on the
suite's 8-device CPU mesh; the port runs on the CPU. Data comes from numpy
seeds (RegressionDataset, token ids)."""

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
from accelerate_tpu.test_utils import RegressionDataset as JaxRegressionDataset
from accelerate_tpu.test_utils import RegressionModel as JaxRegressionModel
from accelerate_tpu.test_utils import linear_loss_fn as jax_linear_loss_fn
from accelerate_tpu_torch import Accelerator, LlamaConfig, causal_lm_loss, create_llama_model, llama_params_from_jax
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.test_utils import RegressionDataset, RegressionModel, linear_loss_fn
from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin, GradScalerKwargs

torch.set_num_threads(2)

SEQ, BATCH, LR, WD = 16, 8, 1e-3, 0.01


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _reset():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _regression(accum=1, lr=0.1, length=64, **kwargs):
    """A CPU Accelerator, RegressionModel, SGD(lr) and a loader of 16-row
    batches over RegressionDataset(length)."""
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum, **kwargs)
    m = RegressionModel()
    opt = torch.optim.SGD(m.module.parameters(), lr=lr)
    model, opt, loader = acc.prepare(m, opt, RegressionDataset(length=length))
    loader.batch_size = 16
    return acc, model, opt, loader


def _ab(model):
    return np.array([model.module.a.item(), model.module.b.item()], np.float32)


def _imperative_epochs(acc, model, opt, loader, epochs, clip=None):
    for _ in range(epochs):
        for batch in loader:
            with acc.accumulate(model):
                acc.backward(linear_loss_fn, batch)
                if clip is not None:
                    acc.clip_grad_norm_(model, clip)
                opt.step()
                opt.zero_grad()


def _numpy_baseline(steps, lr=0.1, batch=16, accum=1, length=64):
    """Plain SGD on y = a x + b with the mean gradient of each window."""
    ds = RegressionDataset(length=length)
    a = b = np.float32(0.0)
    ga = gb = np.float32(0.0)
    for s in range(steps):
        idx = np.arange(s * batch, (s + 1) * batch) % length
        x, y = ds.x[idx], ds.y[idx]
        r = 2 * (a * x + b - y)
        ga, gb = ga + np.mean(r * x) / accum, gb + np.mean(r) / accum
        if (s + 1) % accum == 0:
            a, b = a - lr * ga, b - lr * gb
            ga = gb = np.float32(0.0)
    return np.array([a, b], np.float32)


# --------------------------------------------------------------------------- #
# the reference's imperative cases (tests/test_accelerator.py)
# --------------------------------------------------------------------------- #


def test_imperative_path_matches_baseline():
    acc, model, opt, loader = _regression()
    _imperative_epochs(acc, model, opt, loader, epochs=2)  # 4 batches an epoch: 8 steps
    np.testing.assert_allclose(_ab(model), _numpy_baseline(8), rtol=1e-5)


def test_imperative_grad_accumulation_sync_flags():
    acc, model, opt, loader = _regression(accum=2)
    flags, moved = [], []
    before = _ab(model)
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(linear_loss_fn, batch)
            flags.append(acc.sync_gradients)
            opt.step()
            opt.zero_grad()
        moved.append(not np.array_equal(_ab(model), before))
    assert flags == [False, True, False, True]  # 4 batches: a boundary every second one, the last one too
    assert moved == [False, True, True, True]
    np.testing.assert_allclose(_ab(model), _numpy_baseline(4, accum=2), rtol=1e-5)


def test_clip_grad_norm_imperative():
    """The live buffer is clipped in place and its pre-clip norm returned."""
    acc, model, opt, loader = _regression()
    acc.backward(linear_loss_fn, next(iter(loader)))
    norm = acc.clip_grad_norm_(max_norm=0.01)
    assert float(norm) > 0.01
    _, buf = acc._buffer_for(model)
    assert float(torch.linalg.vector_norm(torch.stack([b.norm() for b in buf]))) <= 0.0101


def test_clip_grad_norm_zero_freezes_step():
    acc, model, opt, loader = _regression(lr=1.0)
    batch = next(iter(loader))
    with acc.accumulate(model):
        acc.backward(linear_loss_fn, batch)
        acc.clip_grad_norm_(model, 0.0)
        opt.step()
    np.testing.assert_array_equal(_ab(model), [0.0, 0.0])


def test_clip_grad_norm_clips_twice_as_the_reference_does():
    """clip_grad_norm_ scales the live buffer now and records the bound,
    which the boundary applies again: after a clip on the first microbatch
    of a window of two, the second adds its gradient unclipped, and the
    boundary still steps by at most the bound (lr 1)."""
    acc, model, opt, loader = _regression(accum=2, lr=1.0)
    it = iter(loader)
    with acc.accumulate(model):
        acc.backward(linear_loss_fn, next(it))
        pre = float(acc.clip_grad_norm_(model, 0.5))
        opt.step()
    _, buf = acc._buffer_for(model)
    assert pre > 0.5 and float(torch.linalg.vector_norm(torch.stack(buf))) == pytest.approx(0.5, rel=1e-5)
    with acc.accumulate(model):
        acc.backward(linear_loss_fn, next(it))
        opt.step()
    assert float(acc._last_grad_norm) > 0.5  # the boundary's pre-clip norm
    assert float(np.linalg.norm(_ab(model))) == pytest.approx(0.5, rel=1e-5)


def test_non_l2_clip_raises_as_the_reference_does():
    acc, model, opt, loader = _regression()
    with pytest.raises(NotImplementedError, match="L2"):
        acc.clip_grad_norm_(model, 1.0, norm_type=1.0)


def test_clip_grad_value_clamps_the_buffer():
    acc, model, opt, loader = _regression(lr=1.0)
    batch = next(iter(loader))
    acc.backward(linear_loss_fn, batch)
    _, raw = acc._buffer_for(model)
    raw = [b.clone() for b in raw]
    acc.clip_grad_value_(model, 0.25)
    _, buf = acc._buffer_for(model)
    for got, want in zip(buf, raw):
        torch.testing.assert_close(got, want.clamp(-0.25, 0.25), rtol=0, atol=0)
    assert max(float(b.abs()) for b in raw) > 0.25
    opt.step()
    np.testing.assert_allclose(_ab(model), [-float(g) for g in buf], rtol=1e-6)


def test_accumulate_syncs_on_end_of_dataloader():
    acc, model, opt, loader = _regression(accum=4, length=32)  # 2 batches a pass, accum 4
    syncs = []
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(linear_loss_fn, batch)
            syncs.append(acc.sync_gradients)
            opt.step()
            opt.zero_grad()
    assert syncs == [False, True]
    assert acc.step == 0  # the end of the loader restarts the count
    assert not np.array_equal(_ab(model), [0.0, 0.0])


def test_sync_each_batch_applies_every_microbatch():
    plugin = GradientAccumulationPlugin(num_steps=4, sync_each_batch=True)
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=plugin)
    m = RegressionModel()
    model, opt = acc.prepare(m, torch.optim.SGD(m.module.parameters(), lr=0.1))
    ds = RegressionDataset(length=16)
    batch = {"x": torch.tensor(ds.x), "y": torch.tensor(ds.y)}
    for _ in range(2):
        with acc.accumulate(model):
            acc.backward(linear_loss_fn, batch)
            assert acc.sync_gradients
            opt.step()
            opt.zero_grad()
    # each step applied the microbatch's gradient / 4
    np.testing.assert_allclose(_ab(model), _numpy_baseline(2, lr=0.025, length=16), rtol=1e-5)


def test_step_and_zero_grad_are_no_ops_inside_the_window():
    acc, model, opt, loader = _regression(accum=2)
    it = iter(loader)
    with acc.accumulate(model):
        acc.backward(linear_loss_fn, next(it))
        opt.step()
        assert not opt.step_was_skipped
        opt.zero_grad()  # mid-window: keeps the buffer
    _, buf = acc._buffer_for(model)
    assert buf is not None
    np.testing.assert_array_equal(_ab(model), [0.0, 0.0])
    with acc.accumulate(model):
        acc.backward(linear_loss_fn, next(it))
        opt.step()
        opt.zero_grad()
    assert acc._buffer_for(model)[1] is None
    np.testing.assert_allclose(_ab(model), _numpy_baseline(2, accum=2), rtol=1e-5)


def test_scheduler_skips_mid_window_and_after_a_skipped_step():
    acc = Accelerator(cpu=True, mixed_precision="fp16", gradient_accumulation_steps=2,
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0**10)])
    m = RegressionModel()
    opt = torch.optim.SGD(m.module.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.5**s)
    model, opt, sched = acc.prepare(m, opt, sched)
    ds = RegressionDataset(length=16)
    good = {"x": torch.tensor(ds.x), "y": torch.tensor(ds.y)}
    bad = {"x": torch.tensor(ds.x), "y": torch.full((16,), 1e38)}
    counts = []
    for batch in (good, good, good, bad):
        with acc.accumulate(model):
            acc.backward(linear_loss_fn, batch)
            opt.step()
            sched.step()
            opt.zero_grad()
        counts.append(sched.step_count)
    assert counts == [0, 1, 1, 1]  # mid-window, boundary, mid-window, skipped boundary
    assert opt.step_was_skipped


def test_trigger_roundtrip():
    acc = Accelerator(cpu=True)
    assert not acc.check_trigger()
    acc.set_trigger()
    assert acc.check_trigger()
    assert not acc.check_trigger()


def test_unprepared_optimizer_step_raises():
    from accelerate_tpu_torch.optimizer import AcceleratedOptimizer

    opt = AcceleratedOptimizer(torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1))
    with pytest.raises(RuntimeError, match="not prepared"):
        opt.step()


def test_each_optimizer_applies_the_buffer_of_the_model_prepared_before_it():
    """prepare records the optimizer's model, as the JAX package does:
    backward into two models, and each optimizer steps and zeroes its own
    model's buffer only."""
    acc = Accelerator(cpu=True)
    pairs = []
    for _ in range(2):
        m = RegressionModel()
        pairs.append(acc.prepare(m, torch.optim.SGD(m.module.parameters(), lr=0.1)))
    (m1, o1), (m2, o2) = pairs
    assert o1._model is m1 and o2._model is m2
    batch = {"x": torch.ones(4), "y": torch.ones(4)}
    for m in (m1, m2):
        acc.backward(linear_loss_fn, batch, model=m)
    o1.step()
    o1.zero_grad()
    assert not np.array_equal(_ab(m1), _ab(m2))
    assert acc._grad_buffers[id(m1)] is None and acc._grad_buffers[id(m2)] is not None
    o2.step()
    np.testing.assert_array_equal(_ab(m1), _ab(m2))


def test_fp16_overflow_skips_the_step_and_backs_off():
    """init_scale 1e38 overflows every boundary: params stay, the scale
    halves each time, step_was_skipped says so."""
    acc, model, opt, loader = _regression(mixed_precision="fp16", kwargs_handlers=[GradScalerKwargs(init_scale=1e38)])
    scales = []
    for batch in loader:
        with acc.accumulate(model):
            loss = acc.backward(linear_loss_fn, batch)
            opt.step()
            assert opt.step_was_skipped
            opt.zero_grad()
        scales.append(acc._loss_scale)
        assert torch.isfinite(loss)
    assert scales == [5e37, 2.5e37, 1.25e37, 6.25e36]
    np.testing.assert_array_equal(_ab(model), [0.0, 0.0])


# --------------------------------------------------------------------------- #
# against the JAX package's imperative loop
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("accum", [2, 4])
def test_regression_imperative_loop_matches_jax(accum):
    """Two passes of 16-row batches, accumulation 2 and 4 (4 batches a pass,
    the last one a boundary)."""
    jacc = JaxAccelerator(gradient_accumulation_steps=accum)
    jmodel, jopt, jloader = jacc.prepare(JaxRegressionModel(), optax.sgd(0.1), JaxRegressionDataset(length=64))
    jloader.batch_size = 16 // jacc.num_data_shards
    j_losses = []
    for _ in range(2):
        for batch in jloader:
            with jacc.accumulate(jmodel):
                j_losses.append(float(jacc.backward(jax_linear_loss_fn, batch)))
                jopt.step()
                jopt.zero_grad()
    want = np.array([float(jmodel.params["a"]), float(jmodel.params["b"])], np.float32)

    acc, model, opt, loader = _regression(accum=accum)
    losses = []
    for _ in range(2):
        for batch in loader:
            with acc.accumulate(model):
                losses.append(float(acc.backward(linear_loss_fn, batch)))
                opt.step()
                opt.zero_grad()
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(_ab(model), want, rtol=1e-4, atol=1e-6)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(BATCH, SEQ)).astype(np.int32) for _ in range(n)]


@functools.cache
def _init_params():
    model = jax_create_llama_model(JaxLlamaConfig.tiny(), seed=3, seq_len=SEQ)
    return jax.tree.map(np.asarray, model.params)


def _port_llama(accum, **kwargs):
    cfg = LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny()))
    model = create_llama_model(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(_init_params(), cfg))
    opt = torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum, **kwargs)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt, cfg


def _port_imperative(acc, model, opt, batches, clip=None):
    loss_fn = lambda p, b: causal_lm_loss(p, b, model.apply_fn)  # noqa: E731
    losses = []
    for ids in batches:
        with acc.accumulate(model):
            losses.append(float(acc.backward(loss_fn, {"input_ids": torch.tensor(ids)})))
            if clip is not None:
                acc.clip_grad_norm_(model, clip)
            opt.step()
            opt.zero_grad()
    return losses


def test_tiny_llama_imperative_loop_with_clipping_matches_jax():
    """Accumulation 2 over 4 microbatches, clip_grad_norm_(0.05) in the
    loop (below the gradient's norm, so it bites), AdamW."""
    batches = _batches(4, seed=6)
    jacc = JaxAccelerator(gradient_accumulation_steps=2)
    jmodel = jacc.prepare_model(jax_create_llama_model(JaxLlamaConfig.tiny(), seed=3, seq_len=SEQ))
    jopt = jacc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
    jloss_fn = lambda p, b: jax_causal_lm_loss(p, b, jmodel.apply_fn)  # noqa: E731
    j_losses, j_norms = [], []
    for ids in batches:
        with jacc.accumulate(jmodel):
            batch = jax.device_put({"input_ids": jnp.asarray(ids)}, batch_sharding(jacc.mesh))
            j_losses.append(float(jacc.backward(jloss_fn, batch)))
            j_norms.append(float(jacc.clip_grad_norm_(jmodel, 0.05)))
            jopt.step()
            jopt.zero_grad()
    cfg = LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny()))
    want = llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg)

    acc, model, opt, _ = _port_llama(2)
    loss_fn = lambda p, b: causal_lm_loss(p, b, model.apply_fn)  # noqa: E731
    losses, norms = [], []
    for ids in batches:
        with acc.accumulate(model):
            losses.append(float(acc.backward(loss_fn, {"input_ids": torch.tensor(ids)})))
            norms.append(float(acc.clip_grad_norm_(model, 0.05)))
            opt.step()
            opt.zero_grad()
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    assert min(norms) > 0.05
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), atol=1e-4, rtol=0, err_msg=name)


# --------------------------------------------------------------------------- #
# against the port's own build_train_step: bit for bit
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("accum", [1, 2])
def test_tiny_llama_imperative_loop_equals_build_train_step(accum):
    """Same weights, same batches, 6 microbatches: the losses, every
    parameter and every AdamW tensor bit-equal."""
    batches = _batches(6, seed=7)
    acc, model, opt, _ = _port_llama(accum)
    losses = _port_imperative(acc, model, opt, batches)
    imperative = ({k: v.detach().clone() for k, v in model.state_dict().items()}, opt.state_dict())
    _reset()

    acc2, model2, opt2, _ = _port_llama(accum)
    step = acc2.build_train_step(lambda p, b: causal_lm_loss(p, b, model2.apply_fn))
    assert losses == [float(step({"input_ids": torch.tensor(ids)})) for ids in batches]
    for name, value in model2.state_dict().items():
        assert torch.equal(imperative[0][name], value), name
    for i, state in opt2.state_dict()["state"].items():
        for key, value in state.items():
            assert torch.equal(imperative[1]["state"][i][key], value), (i, key)


def test_regression_imperative_loop_equals_build_train_step():
    """Accumulation 4 over two passes of a loader whose end falls
    mid-window: the end-of-loader boundaries agree too."""
    acc, model, opt, loader = _regression(accum=4, length=48)  # 3 batches a pass
    _imperative_epochs(acc, model, opt, loader, epochs=2)
    imperative = _ab(model)
    _reset()
    acc, model, opt, loader = _regression(accum=4, length=48)
    step = acc.build_train_step(linear_loss_fn)
    for _ in range(2):
        for batch in loader:
            step(batch)
    np.testing.assert_array_equal(imperative, _ab(model))


def test_no_sync_blocks_apply_until_exit():
    acc, model, opt, loader = _regression(lr=0.5)
    batch = next(iter(loader))
    with acc.no_sync():
        acc.backward(linear_loss_fn, batch)
        opt.step()
        np.testing.assert_array_equal(_ab(model), [0.0, 0.0])
    acc.backward(linear_loss_fn, batch)
    opt.step()
    # the buffer held both microbatches' gradients (each / accum = 1)
    np.testing.assert_allclose(_ab(model), 2 * _numpy_baseline(1, lr=0.5), rtol=1e-5)


def test_gradient_accumulation_example_fits_the_line_on_both_paths():
    """examples/torch_gradient_accumulation.py --cpu: both paths reach
    a ~ 2, b ~ 3 and end bit-equal."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / "torch_gradient_accumulation.py"
    spec = importlib.util.spec_from_file_location("torch_gradient_accumulation", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    imperative, fused = example.main(["--cpu"])
    assert imperative == fused
    assert abs(imperative[0] - 2) < 0.3 and abs(imperative[1] - 3) < 0.3


def test_negative_clip_bound_turns_clipping_off():
    """A negative bound leaves the live buffer as it is and the boundary
    unclipped (the applier's reading of it), rather than flipping the
    gradient's sign as a scale of min(1, bound / norm) would."""
    acc, model, opt, loader = _regression(lr=1.0)
    acc.backward(linear_loss_fn, next(iter(loader)))
    _, buf = acc._buffer_for(model)
    raw = [b.clone() for b in buf]
    acc.clip_grad_norm_(model, -1.0)
    for got, want in zip(acc._buffer_for(model)[1], raw):
        assert torch.equal(got, want)
    opt.step()
    np.testing.assert_allclose(_ab(model), [-float(g) for g in raw], rtol=1e-6)
