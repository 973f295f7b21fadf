"""The port's BERT (accelerate_tpu_torch.models.bert) against the JAX
package's on the same weights and inputs: the weights carried across,
tiny-model logits in f32 (a padding mask with a fully masked row
included) and in bf16 compute with the policy's bf16 softmax, the
parameters kept f32, remat, dropout by its properties, a 5-step fine-tune
through ``Accelerator.prepare(model, optimizer, loader)`` against the JAX
package's optax run, and the example's eval loop on a ragged last batch.
The JAX side runs on the suite's 8-device CPU mesh (a batch of 8 is one
row a shard); inputs are made with numpy from a seed."""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.data_loader import prepare_data_loader as jax_prepare_data_loader
from accelerate_tpu.models import BertConfig as JaxBertConfig
from accelerate_tpu.models import bert_classification_loss as jax_bert_loss
from accelerate_tpu.models import create_bert_model as jax_create_bert_model
from accelerate_tpu.utils import MixedPrecisionPolicy as JaxMixedPrecisionPolicy
from accelerate_tpu_torch import (
    Accelerator,
    BertConfig,
    MixedPrecisionPolicy,
    bert_classification_loss,
    bert_params_from_jax,
    create_bert_model,
    prepare_data_loader,
)
from accelerate_tpu_torch.models import bert as port_bert
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEQ, LR, WD = 16, 1e-3, 0.01
# Tiny logits in f32: flax's LayerNorm takes E[x^2] - E[x]^2 where F.layer_norm
# takes two passes; at eps 1e-12 the two agree to f32 rounding (2.4e-7 measured).
F32_ATOL = 1e-5
# bf16 compute with the bf16 softmax: the two packages round the same
# tensors to bf16 (every Dense, the softmax, the residual adds) but GELU
# and the matmul-plus-bias round in different places. Logits reach 1.7 on
# these inputs (a bf16 ulp there is 2^-7); measured at most 0.014 over four
# seeds (about 2 ulps), held to 4 ulps.
BF16_ATOL = 4 * 2.0**-7


@pytest.fixture(autouse=True)
def reset_port_state():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _jax_cfg(**kw):
    return JaxBertConfig.tiny(num_hidden_layers=2, **kw)


@functools.cache
def _jax_params():
    """The JAX tiny BERT's initial params as numpy."""
    return jax.tree.map(np.asarray, jax_create_bert_model(_jax_cfg(), seed=1, seq_len=SEQ).params)


def _port_model(**kw):
    cfg = BertConfig(**dataclasses.asdict(_jax_cfg(**kw)))
    model = create_bert_model(cfg, device="cpu")
    model.load_state_dict(bert_params_from_jax(_jax_params(), cfg))
    return model


def _inputs(batch=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (batch, SEQ)).astype(np.int32)
    mask = np.ones((batch, SEQ), bool)
    mask[1, 10:] = False
    mask[2, :] = False  # a fully padded row: uniform attention weights, not NaN
    mask[3, 5:] = False
    return ids, mask


def _jax_logits(ids, mask, mixed_precision="no", softmax_dtype=None):
    handlers = [JaxMixedPrecisionPolicy(softmax_dtype=softmax_dtype)] if softmax_dtype else None
    acc = JaxAccelerator(mixed_precision=mixed_precision, kwargs_handlers=handlers)
    model = jax_create_bert_model(_jax_cfg(), seed=1, seq_len=SEQ)
    model = acc.prepare_model(model)
    eval_step = acc.build_eval_step(lambda p, i, m: model.apply_fn(p, i, m))
    return np.asarray(eval_step(jnp.asarray(ids), jnp.asarray(mask)))


def _port_logits(ids, mask, mixed_precision="no", softmax_dtype=None):
    handlers = [MixedPrecisionPolicy(compute_dtype={"no": "float32", "bf16": "bfloat16"}[mixed_precision],
                                     softmax_dtype=softmax_dtype)] if softmax_dtype else None
    acc = Accelerator(cpu=True, mixed_precision=mixed_precision, kwargs_handlers=handlers)
    model = acc.prepare_model(_port_model(), evaluation_mode=True)
    eval_step = acc.build_eval_step(lambda p, i, m: model.apply_fn(p, i, m), model=model)
    return eval_step(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


def test_bert_params_from_jax_carries_every_weight():
    params, cfg = _jax_params(), BertConfig(**dataclasses.asdict(_jax_cfg()))
    sd = bert_params_from_jax(params, cfg)
    model = create_bert_model(cfg, device="cpu")
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    got = model.state_dict()
    enc, layer = params["encoder"], params["encoder"]["layer_1"]
    np.testing.assert_array_equal(got["encoder.embeddings.word_embeddings.weight"],
                                  enc["embeddings/word_embeddings"]["embedding"])
    np.testing.assert_array_equal(got["encoder.layers.1.attention.query.weight"],
                                  layer["attention"]["query"]["kernel"].T)
    np.testing.assert_array_equal(got["encoder.layers.1.ffn.output.weight"], layer["ffn/output"]["kernel"].T)
    np.testing.assert_array_equal(got["encoder.layers.1.ffn_norm.weight"], layer["ffn_norm"]["scale"])
    np.testing.assert_array_equal(got["classifier.bias"], params["classifier"]["bias"])
    assert sum(v.numel() for v in sd.values()) == sum(x.size for x in jax.tree.leaves(params))
    assert model.dtype == torch.float32 and model.name == "bert"


def test_tiny_bert_f32_logits_match_jax():
    ids, mask = _inputs()
    want = _jax_logits(ids, mask)
    got = _port_logits(ids, mask)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_tiny_bert_bf16_compute_with_bf16_softmax_matches_jax():
    """bench.py's precision: bf16 compute, MixedPrecisionPolicy(softmax_dtype="bfloat16")."""
    ids, mask = _inputs(seed=1)
    want = _jax_logits(ids, mask, "bf16", "bfloat16")
    got = _port_logits(ids, mask, "bf16", "bfloat16")
    assert got.dtype == np.float32  # the classifier computes in f32
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_the_parameters_kept_f32_are_the_jax_ones():
    jacc = JaxAccelerator(mixed_precision="bf16")
    kept = jax.tree.map(lambda p: np.full(p.shape, p.dtype == jnp.float32, np.float32),
                        jacc._compute_cast(jax.tree.map(jnp.asarray, _jax_params())))
    cfg = BertConfig(**dataclasses.asdict(_jax_cfg()))
    want = {name for name, t in bert_params_from_jax(kept, cfg).items() if bool(t.all())}
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    got = {name for name, t in acc._compute_cast(_port_model().params).items() if t.dtype == torch.float32}
    assert got == want
    assert want == {f"{m}.{p}" for m in ["encoder.embeddings.norm"] + [f"encoder.layers.{i}.{n}" for i in range(2)
                                                                        for n in ("attention_norm", "ffn_norm")]
                    for p in ("weight", "bias")}


def _grads(model, batch, rng_seed):
    model.module.requires_grad_(True)
    rng = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    loss = bert_classification_loss(model.params, batch, model.apply_fn, rng=rng)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.module.named_parameters()}


@pytest.mark.parametrize("rng_seed", [None, 5], ids=["deterministic", "dropout"])
def test_remat_equals_no_remat(rng_seed, monkeypatch):
    ids, mask = _inputs()
    batch = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask),
             "labels": torch.from_numpy(np.arange(8, dtype=np.int32) % 2)}
    calls = []
    forward = port_bert.BertLayer.forward
    monkeypatch.setattr(port_bert.BertLayer, "forward", lambda self, *a: calls.append(1) or forward(self, *a))
    results = {}
    for remat in (True, False):
        calls.clear()
        results[remat] = _grads(_port_model(remat=remat), batch, rng_seed)
        assert len(calls) == (4 if remat else 2)  # 2 layers, run again in the backward with remat
    torch.testing.assert_close(results[True][0], results[False][0], rtol=0, atol=0)
    for name, g in results[False][1].items():
        torch.testing.assert_close(results[True][1][name], g, rtol=1e-6, atol=1e-7)


def test_dropout_by_its_properties():
    """jax.random and torch.Generator never agree, so dropout is held to
    what it must do: keep at 1 - rate, repeat with the seed, vanish when
    deterministic, and stay off in the loss without an rng."""
    x = torch.ones(200_000)
    rate = 0.1
    kept = port_bert._dropout(x, rate, torch.Generator().manual_seed(0))
    frac = (kept != 0).float().mean().item()
    assert abs(frac - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / x.numel())  # binomial error
    torch.testing.assert_close(kept[kept != 0], torch.full_like(kept[kept != 0], 1 / (1 - rate)))

    model = _port_model()
    ids, mask = (torch.from_numpy(a) for a in _inputs())

    def run(**kw):
        return model.apply_fn(model.params, ids, mask, **kw).detach()

    plain = run()
    dropped = run(deterministic=False, rngs={"dropout": torch.Generator().manual_seed(3)})
    assert torch.equal(dropped, run(deterministic=False, rngs={"dropout": torch.Generator().manual_seed(3)}))
    assert not torch.equal(dropped, run(deterministic=False, rngs={"dropout": torch.Generator().manual_seed(4)}))
    assert not torch.allclose(dropped, plain)
    assert torch.equal(run(deterministic=True, rngs={"dropout": torch.Generator()}), plain)
    with pytest.raises(ValueError, match="requires rngs"):
        run(deterministic=False)
    batch = {"input_ids": ids, "attention_mask": mask, "labels": torch.zeros(8, dtype=torch.int32)}
    loss = bert_classification_loss(model.params, batch, model.apply_fn)
    assert torch.equal(loss, bert_classification_loss(model.params, batch, model.apply_fn))
    assert not torch.equal(loss, bert_classification_loss(model.params, batch, model.apply_fn,
                                                          rng=torch.Generator().manual_seed(0)))


def test_loss_mask_matches_jax():
    ids, mask = _inputs()
    labels = (np.arange(8) % 2).astype(np.int32)
    loss_mask = np.array([1, 1, 0, 1, 0, 1, 1, 1], np.float32)
    jmodel = jax_create_bert_model(_jax_cfg(), seed=1, seq_len=SEQ)
    want = float(jax_bert_loss(jmodel.params, {"input_ids": ids, "attention_mask": mask, "labels": labels,
                                               "loss_mask": loss_mask}, jmodel.apply_fn))
    model = _port_model()
    batch = {k: torch.from_numpy(v) for k, v in
             {"input_ids": ids, "attention_mask": mask, "labels": labels, "loss_mask": loss_mask}.items()}
    assert float(bert_classification_loss(model.params, batch, model.apply_fn)) == pytest.approx(want, abs=1e-5)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, (n, SEQ)).astype(np.int32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    ids[labels == 1, 3] = 4
    mask = np.ones((n, SEQ), bool)
    mask[::3, 12:] = False  # every third row padded
    return [{"input_ids": ids[i], "attention_mask": mask[i], "labels": labels[i]} for i in range(n)]


def test_five_step_finetune_through_prepare_matches_jax():
    """f32, AdamW(1e-3, weight decay 0.01) against optax.adamw, over a
    shuffled loader of 37 rows: 4 full batches of 8 and a tail of 5 wrapped
    round to 8. Losses and final parameters within 1e-4, but the key
    biases: a bias on every key adds the same logit across a row, so their
    gradient is zero in exact arithmetic and Adam steps them by about lr on
    rounding noise; they are held to the 5 lr such steps can move each."""
    rows = _rows(37)
    jacc = JaxAccelerator()
    jmodel = jax_create_bert_model(_jax_cfg(), seed=1, seq_len=SEQ)
    jloader = jax_prepare_data_loader(rows, batch_size=1, shuffle=True, seed=42)
    jmodel, _, jloader = jacc.prepare(jmodel, optax.adamw(LR, weight_decay=WD), jloader)
    jstep = jacc.build_train_step(lambda p, b: jax_bert_loss(p, b, jmodel.apply_fn))
    want = [float(jstep(b)) for b in jloader]
    want_params = bert_params_from_jax(jax.tree.map(np.asarray, jmodel.params),
                                       BertConfig(**dataclasses.asdict(_jax_cfg())))

    acc = Accelerator(cpu=True)
    model = _port_model()
    loader = prepare_data_loader(rows, batch_size=8, shuffle=True, seed=42)
    model, opt, loader = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD),
                                     loader)
    step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
    got = [float(step(b)) for b in loader]
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)
    params = model.state_dict()
    for name, w in want_params.items():
        atol = 2 * 5 * LR if name.endswith("attention.key.bias") else 1e-4
        np.testing.assert_allclose(params[name].numpy(), w.numpy(), rtol=0, atol=atol, err_msg=name)


def _example():
    spec = importlib.util.spec_from_file_location("torch_nlp_example", REPO / "examples" / "torch_nlp_example.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_eval_loop_gathers_exactly_the_dataset_on_a_ragged_tail():
    """37 rows at batch 8: the last batch wraps round to 8 rows and
    gather_for_metrics hands back its 5 real ones, as in the JAX package."""
    example = _example()
    data = example.SyntheticMRPC(n=37, seq_len=SEQ, vocab_size=1024, seed=2)
    acc = Accelerator(cpu=True)
    model = acc.prepare_model(_port_model())
    loader = acc.prepare_data_loader(data, batch_size=8)
    eval_step = acc.build_eval_step(lambda p, ids, mask: model.apply_fn(p, ids, mask))
    labels = [acc.gather_for_metrics(b["labels"]) for b in loader]
    assert [len(x) for x in labels] == [8, 8, 8, 8, 5]
    np.testing.assert_array_equal(torch.cat(labels).numpy(), data.labels)
    correct, total = example.evaluate(acc, eval_step, loader)
    assert total == len(data) == 37 and 0 <= correct <= 37

    jacc = JaxAccelerator()
    jloader = jacc.prepare_data_loader(data, batch_size=1)  # 1 row a shard: batches of 8
    jlabels = [np.asarray(jacc.gather_for_metrics(b["labels"])) for b in jloader]
    assert [len(x) for x in jlabels] == [len(x) for x in labels]
    np.testing.assert_array_equal(np.concatenate(jlabels), data.labels)


@pytest.mark.cuda
def test_cuda_finetune_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batches and the model live on the GPU (chip_smoke.py's bert_consistency)")
    runs = {}
    for device in ("cuda", "cpu"):
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
        acc = Accelerator(cpu=device == "cpu")
        model = _port_model()
        model, opt, loader = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD),
                                         prepare_data_loader(_rows(24), batch_size=8, shuffle=True, seed=0))
        step = acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))
        runs[device] = [float(step(b)) for b in loader]
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)
