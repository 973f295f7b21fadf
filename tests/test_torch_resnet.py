"""The port's ResNet v1.5 (accelerate_tpu_torch.models.resnet) and mutable
model state (``build_train_step(has_state=True)``, ``Model.state``)
against the JAX package's flax ResNet carrying the same weights and
BatchNorm statistics: logits at even and odd image sizes (flax's
asymmetric SAME padding), three has_state steps (losses, parameters,
running statistics), remat, bf16, and the statistics' checkpoint round
trip. The JAX weights are perturbed before they cross (every BatchNorm
scale and bias, ``bn3``'s zero scale included, and the running
statistics), so a BatchNorm in the wrong place or reading the wrong
statistics shows. The JAX side runs on the suite's 8-device CPU mesh; the
port on the CPU. Images come from numpy seeds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models import ResNetConfig as JaxResNetConfig
from accelerate_tpu.models import create_resnet_model as jax_create_resnet_model
from accelerate_tpu.models import resnet_classification_loss as jax_resnet_loss
from accelerate_tpu.models.resnet import ResNet as JaxResNet
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu_torch import (
    Accelerator,
    ResNetConfig,
    create_resnet_model,
    resnet_classification_loss,
    resnet_params_from_jax,
)
from accelerate_tpu_torch.models import resnet as port_resnet
from accelerate_tpu_torch.modeling import flatten
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

BATCH, LR = 8, 0.05


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _jax_weights(size, seed=0, config=None):
    """The JAX tiny ResNet's params and batch_stats (numpy), every 1-d leaf
    (BatchNorm scale and bias, head bias) moved off its initial value and
    the statistics off 0 and 1."""
    model = jax_create_resnet_model(config or JaxResNetConfig.tiny(), seed=seed, image_size=size)
    rng = np.random.default_rng(seed + 1)

    def perturb(a):
        a = np.asarray(a)
        return a + rng.normal(0.0, 0.3, a.shape).astype(np.float32) if a.ndim == 1 else a

    params = jax.tree.map(perturb, model.params)
    stats = jax.tree.map(lambda a: np.asarray(a) + np.abs(rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
                         model.state["batch_stats"])
    return params, stats


def _port_model(params, stats, config=None):
    model = create_resnet_model(config or ResNetConfig.tiny(), device="cpu")
    model.load_state_dict(resnet_params_from_jax(params, stats))
    return model


def _images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


def _labels(n, seed=0, classes=10):
    return np.random.default_rng(seed + 100).integers(0, classes, size=(n,)).astype(np.int32)


def _flat_state(model) -> dict:
    return {k: v.detach().clone().numpy() for k, v in flatten(model.state["batch_stats"]).items()}


@pytest.mark.parametrize("size", [16, 17, 33])
def test_logits_match_jax_at_even_and_odd_sizes(size):
    """Eval (running statistics) and train (batch statistics, new running
    ones) forwards carried across, f32, within 1e-5."""
    params, stats = _jax_weights(size)
    jmodel = jax_create_resnet_model(JaxResNetConfig.tiny(), image_size=size)
    x = _images(4, size)
    j_eval = np.asarray(jmodel.apply_fn(params, x, state={"batch_stats": stats}))
    j_train, j_new = jmodel.apply_fn(params, x, state={"batch_stats": stats}, train=True)
    model = _port_model(params, stats)
    with torch.no_grad():
        p_eval = model.apply_fn(model.params, torch.tensor(x)).numpy()
        p_train, p_new = model.apply_fn(model.params, torch.tensor(x), None, train=True)
    assert p_eval.dtype == np.float32 and p_eval.shape == (4, 10)
    np.testing.assert_allclose(p_eval, j_eval, atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_train.numpy(), np.asarray(j_train), atol=1e-5, rtol=0)
    want = flatten(jax.tree.map(np.asarray, j_new["batch_stats"]))
    got = flatten(p_new["batch_stats"])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=1e-5, rtol=0, err_msg=name)
    # the forward wrote no buffer: the model's state is still the carried one
    for name, value in _flat_state(model).items():
        np.testing.assert_array_equal(value, flatten(stats)[name])


def test_same_pads_are_flax_padding():
    """flax SAME: the smaller half first; a 3x3 stride-2 window on an even
    size pads (0, 1)."""
    assert port_resnet.same_pads(16, 3, 2) == (0, 1)
    assert port_resnet.same_pads(17, 3, 2) == (1, 1)
    assert port_resnet.same_pads(16, 3, 1) == (1, 1)
    assert port_resnet.same_pads(16, 1, 2) == (0, 0)
    for size in range(3, 12):
        for k, s in ((3, 2), (3, 1), (1, 2), (7, 2)):
            lo, hi = port_resnet.same_pads(size, k, s)
            (want,) = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
            assert (lo, hi) == tuple(want), (size, k, s)


def _jax_train(params, stats, batches, size):
    acc = JaxAccelerator()
    model = jax_create_resnet_model(JaxResNetConfig.tiny(), image_size=size)
    model.params = jax.tree.map(jnp.asarray, params)
    model.state = {"batch_stats": jax.tree.map(jnp.asarray, stats)}
    model = acc.prepare_model(model)
    acc.prepare_optimizer(optax.sgd(LR, momentum=0.9))
    step = acc.build_train_step(lambda p, s, b: jax_resnet_loss(p, s, b, model.apply_fn), has_state=True)
    losses = []
    for images, labels in batches:
        batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
        batch = jax.device_put(batch, batch_sharding(acc.mesh))
        losses.append(float(step(batch)))
    return losses, jax.tree.map(np.asarray, model.params), jax.tree.map(np.asarray, model.state["batch_stats"])


def _port_train(params, stats, batches, config=None):
    model = _port_model(params, stats, config)
    opt = torch.optim.SGD(model.module.parameters(), lr=LR, momentum=0.9)
    acc = Accelerator(cpu=True)
    model, opt = acc.prepare(model, opt)
    step = acc.build_train_step(lambda p, s, b: resnet_classification_loss(p, s, b, model.apply_fn), has_state=True)
    losses = [float(step({"images": torch.tensor(x), "labels": torch.tensor(y)})) for x, y in batches]
    return losses, acc, model, opt


def test_three_has_state_steps_match_jax():
    """SGD with momentum 0.9: losses, every parameter within 1e-4 and every
    running statistic within 1e-5 after three steps."""
    size = 16
    params, stats = _jax_weights(size)
    batches = [(_images(BATCH, size, seed=i), _labels(BATCH, seed=i)) for i in range(3)]
    j_losses, j_params, j_stats = _jax_train(params, stats, batches, size)
    losses, acc, model, _ = _port_train(params, stats, batches)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    want = resnet_params_from_jax(j_params, j_stats)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        tol = 1e-5 if name.endswith((".mean", ".var")) else 1e-4
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=tol, rtol=0, err_msg=name)
    # the statistics moved: three updates from the carried values
    moved = {k: v for k, v in _flat_state(model).items() if not np.allclose(v, flatten(stats)[k])}
    assert len(moved) == len(flatten(stats))


def test_bf16_logits_within_four_ulps_of_jax():
    """bf16 compute: the convolutions in bf16, statistics and head in f32,
    the same carried weights. Each package rounds the same tensors to bf16,
    its convolutions summing in its own order; held to 4 bf16 ulps of the
    largest logit."""
    size = 16
    params, stats = _jax_weights(size)
    x = _images(BATCH, size, seed=9)
    jacc = JaxAccelerator(mixed_precision="bf16")
    jmodel = jax_create_resnet_model(JaxResNetConfig.tiny(), image_size=size)
    jmodel.params = jax.tree.map(jnp.asarray, params)
    jmodel.state = {"batch_stats": jax.tree.map(jnp.asarray, stats)}
    jmodel = jacc.prepare_model(jmodel)
    jacc.prepare_optimizer(optax.sgd(LR))
    j_eval = jacc.build_eval_step(lambda p, s, images: jmodel.apply_fn(p, images, state=s))
    want = np.asarray(j_eval(jnp.asarray(x)))

    model = _port_model(params, stats)
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    model = acc.prepare_model(model)
    eval_step = acc.build_eval_step(lambda p, s, images: model.apply_fn(p, images, s))
    got = eval_step(torch.tensor(x))
    assert got.dtype == torch.float32
    assert {t.dtype for t in acc.cast_to_compute(model.params).values()} == {torch.bfloat16}
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, atol=4 * ulp, rtol=0)


def test_remat_recomputes_the_blocks_and_updates_the_state_once(monkeypatch):
    """With remat each block runs again in the backward; the state comes
    from the first forward only, so one step gives the statistics and the
    gradients of the step without remat."""
    calls = []
    forward = port_resnet.BottleneckBlock.forward

    def counting(self, *a, **kw):
        calls.append(1)
        return forward(self, *a, **kw)

    monkeypatch.setattr(port_resnet.BottleneckBlock, "forward", counting)
    size = 16
    params, stats = _jax_weights(size)
    batches = [(_images(BATCH, size, seed=3), _labels(BATCH, seed=3))]
    runs = {}
    for remat in (True, False):
        calls.clear()
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        _, _, model, _ = _port_train(params, stats, batches, config=ResNetConfig.tiny(remat=remat))
        assert len(calls) == (4 if remat else 2)  # two blocks, again in the backward with remat
        runs[remat] = (_flat_state(model), {n: p.grad.clone() for n, p in model.module.named_parameters()})
    for name, value in runs[False][0].items():
        np.testing.assert_array_equal(runs[True][0][name], value, err_msg=name)
    for name, grad in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][name], grad, rtol=1e-6, atol=1e-7)


def test_model_state_roundtrip(tmp_path):
    """The counterpart of tests/test_checkpointing.py::test_model_state_roundtrip:
    the running statistics ride in model.safetensors (they are buffers of
    the module's state_dict); zeroed after the save, load_state brings them
    back bit for bit."""
    size = 16
    params, stats = _jax_weights(size)
    batches = [(_images(BATCH, size, seed=i), _labels(BATCH, seed=i)) for i in range(3)]
    _, acc, model, _ = _port_train(params, stats, batches)
    saved = _flat_state(model)
    acc.save_state(str(tmp_path / "ckpt"))
    model.state = {"batch_stats": jax.tree.map(lambda t: torch.zeros_like(t), model.state["batch_stats"])}
    assert all(not v.any() for v in _flat_state(model).values())
    acc.load_state(str(tmp_path / "ckpt"))
    restored = _flat_state(model)
    assert restored.keys() == saved.keys()
    for name, value in saved.items():
        np.testing.assert_array_equal(restored[name], value, err_msg=name)


def test_has_state_loss_with_rng_and_aux():
    """The arity rule with state: ``loss_fn(params, state, batch, rng)``
    gets the per-step generator, and with ``has_aux`` returns ``(loss,
    (new_state, aux))``."""
    size = 16
    params, stats = _jax_weights(size)
    model = _port_model(params, stats)
    acc = Accelerator(cpu=True)
    model, _ = acc.prepare(model, torch.optim.SGD(model.module.parameters(), lr=LR))
    seen = []

    def loss_fn(p, s, b, rng):
        seen.append(rng)
        loss, new_state = resnet_classification_loss(p, s, b, model.apply_fn)
        return loss, (new_state, {"rows": b["images"].shape[0]})

    step = acc.build_train_step(loss_fn, has_state=True, has_aux=True)
    loss, aux = step({"images": torch.tensor(_images(BATCH, size)), "labels": torch.tensor(_labels(BATCH))})
    assert aux == {"rows": BATCH} and torch.isfinite(loss)
    assert isinstance(seen[0], torch.Generator)
    assert any(not np.array_equal(v, flatten(stats)[k]) for k, v in _flat_state(model).items())


def test_eval_step_reads_the_running_statistics_and_leaves_them():
    size = 16
    params, stats = _jax_weights(size)
    model = _port_model(params, stats)
    acc = Accelerator(cpu=True)
    model = acc.prepare_model(model)
    seen = []

    def eval_fn(p, s, images):
        seen.append(s)
        return model.apply_fn(p, images, s)

    before = _flat_state(model)
    logits = acc.build_eval_step(eval_fn)(torch.tensor(_images(4, size)))
    assert logits.shape == (4, 10)
    assert seen[0] is not None and set(seen[0]) == {"batch_stats"}
    for name, value in _flat_state(model).items():
        np.testing.assert_array_equal(value, before[name])


def test_state_setter_refuses_a_foreign_tree():
    model = create_resnet_model(ResNetConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
        model.state = {"cache": {}}
    with pytest.raises(ValueError, match="state names"):
        model.state = {"batch_stats": {"bn_init": {"mean": torch.zeros(8)}}}


def test_resnet50_tree_maps_onto_the_port():
    """ResNet-50 v1.5 at 37 classes (the CV example's): every flax param and
    statistic has a port tensor of the converted shape, and nothing more."""
    jax_cfg = JaxResNetConfig.resnet50(num_classes=37)
    shapes = jax.eval_shape(JaxResNet(jax_cfg).init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in resnet_params_from_jax(zeros["params"], zeros["batch_stats"]).items()}
    model = create_resnet_model(ResNetConfig.resnet50(num_classes=37), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert model.num_parameters() == sum(np.prod(s.shape) for s in jax.tree.leaves(shapes["params"]))
    assert model.num_parameters() == 23_583_845


@pytest.mark.cuda
def test_cuda_has_state_steps_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model and batches live on the GPU (chip_smoke.py's resnet_consistency)")
    size = 16
    params, stats = _jax_weights(size)
    batches = [(_images(BATCH, size, seed=i), _labels(BATCH, seed=i)) for i in range(3)]
    runs = {}
    for cpu in (True, False):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        model = _port_model(params, stats)
        opt = torch.optim.SGD(model.module.parameters(), lr=LR, momentum=0.9)
        acc = Accelerator(cpu=cpu)
        model, opt = acc.prepare(model, opt)
        step = acc.build_train_step(lambda p, s, b: resnet_classification_loss(p, s, b, model.apply_fn),
                                    has_state=True)
        for x, y in batches:
            step({"images": torch.tensor(x, device=acc.device), "labels": torch.tensor(y, device=acc.device)})
        runs[cpu] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for name, value in runs[True].items():
        torch.testing.assert_close(runs[False][name], value, rtol=0, atol=1e-4)


def _cv_example():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / "torch_cv_example.py"
    spec = importlib.util.spec_from_file_location("torch_cv_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("total,peak", [(16, 3e-2), (4, 1e-1), (37, 0.5)])
def test_onecycle_schedule_gives_optax_values(total, peak):
    schedule = _cv_example().onecycle_schedule(total, peak, pct_start=0.25)
    want = optax.cosine_onecycle_schedule(total, peak, pct_start=0.25)
    for step in range(total + 3):
        assert schedule(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), step


def test_cv_example_runs_on_the_cpu(capsys):
    """examples/torch_cv_example.py --tiny --cpu: one epoch of 4 has_state
    steps, then the eval pass on the running statistics, whose
    gather_for_metrics gives back all 256 rows."""
    accuracy = _cv_example().main(["--tiny", "--cpu"])
    out = capsys.readouterr().out
    assert 0.0 <= accuracy <= 1.0
    assert "(256 samples)" in out and "loss=" in out
