"""The port's checkpointing (accelerate_tpu_torch.checkpointing and
``Accelerator.save_state`` / ``load_state``), mirroring
tests/test_checkpointing.py on a tiny Llama and a tiny BERT, then held
against the JAX package: a 5-step run saved after step 3 and resumed in a
fresh Accelerator, in both packages (each bit-equal to its own unbroken
run, the port within 1e-4 of JAX); a checkpoint of either package passing
the other's manifest checks; safetensors files read both ways. All on the
CPU; token ids and rows are made with numpy from a seed."""

import dataclasses
import functools
import itertools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file

import accelerate_tpu.ft as jft
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import ProjectConfiguration as JaxProjectConfiguration
from accelerate_tpu import data_loader as jdl
from accelerate_tpu.checkpointing import load_model as jax_load_model
from accelerate_tpu.modeling import Model as JaxModel
from accelerate_tpu.models import BertConfig as JaxBertConfig
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import bert_classification_loss as jax_bert_loss
from accelerate_tpu.models import causal_lm_loss as jax_causal_lm_loss
from accelerate_tpu.models import create_bert_model as jax_create_bert_model
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu.parallel.mesh import batch_sharding
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.test_utils import RegressionModel, linear_loss_fn
from accelerate_tpu_torch import (
    Accelerator,
    BertConfig,
    CheckpointManager,
    LlamaConfig,
    ProjectConfiguration,
    bert_classification_loss,
    bert_params_from_jax,
    causal_lm_loss,
    create_bert_model,
    create_llama_model,
    llama_params_from_jax,
    load_model,
    save_model,
)
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.ft import MANIFEST_NAME, read_manifest, verify_manifest
from accelerate_tpu_torch.modeling import Model
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)

SEQ, BATCH, LR, WD = 16, 8, 1e-3, 0.01
# the port against the JAX package, per step and for the final parameters
# (tests/test_torch_train.py's and tests/test_torch_bert.py's tolerance)
JAX_TOL = 1e-4


def _reset():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _reset_jax():
    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    _reset()
    yield
    _reset()


def _token_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(BATCH, SEQ)).astype(np.int64) for _ in range(n)]


def _setup(project_dir=None, automatic=False, total_limit=None, **acc_kwargs):
    """A fresh Accelerator with a prepared tiny Llama, AdamW and its step."""
    config = ProjectConfiguration(project_dir=project_dir, automatic_checkpoint_naming=automatic,
                                  total_limit=total_limit) if project_dir else None
    acc = Accelerator(cpu=True, project_config=config, **acc_kwargs)
    model = acc.prepare_model(create_llama_model(LlamaConfig.tiny(), seed=0, device="cpu"))
    opt = acc.prepare_optimizer(torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD))
    step = acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))
    return acc, model, opt, step


def _train(step, n, seed=0):
    return [float(step({"input_ids": torch.from_numpy(ids)})) for ids in _token_batches(n, seed)]


def _clone_state(model, opt):
    params = {k: v.clone() for k, v in model.state_dict().items()}
    state = {i: {k: v.clone() for k, v in s.items()} for i, s in enumerate(opt.optimizer.state.values())}
    return params, state


def _assert_state_equal(model, opt, want):
    params, state = want
    got_params, got_state = _clone_state(model, opt)
    assert got_params.keys() == params.keys()
    for k in params:
        assert torch.equal(got_params[k], params[k]), k
    assert got_state.keys() == state.keys()
    for i in state:
        for k in state[i]:
            assert torch.equal(got_state[i][k], state[i][k]), (i, k)


def test_save_load_roundtrip(tmp_path):
    acc, model, opt, step = _setup()
    _train(step, 2)
    want = _clone_state(model, opt)
    acc.save_state(str(tmp_path / "ckpt"))
    params = list(model.module.parameters())
    with torch.no_grad():  # perturb in place, then restore
        for p in params:
            p.zero_()
    _train(step, 1, seed=5)
    acc.load_state(str(tmp_path / "ckpt"))
    _assert_state_equal(model, opt, want)
    assert all(p is q for p, q in zip(params, model.module.parameters())), "load copies into the parameters"
    assert acc.step == 2


def test_automatic_checkpoint_naming_and_total_limit(tmp_path):
    acc, _, _, step = _setup(str(tmp_path), automatic=True, total_limit=2)
    _train(step, 1)
    for _ in range(3):
        acc.save_state()
    assert [c.name for c in sorted((tmp_path / "checkpoints").iterdir())] == ["checkpoint_1", "checkpoint_2"]
    assert acc.checkpoint_manager.latest().name == "checkpoint_2"


def test_custom_object_checkpointing_and_hooks(tmp_path):
    class Counter:
        def __init__(self):
            self.n = 0

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, sd):
            self.n = sd["n"]

    acc, _, _, step = _setup()
    _train(step, 1)
    counter = Counter()
    counter.n = 42
    acc.register_for_checkpointing(counter)
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())
    seen = []
    handle = acc.register_save_state_pre_hook(lambda models, weights, out: seen.append(("save", out)))
    acc.register_load_state_pre_hook(lambda models, inp: seen.append(("load", inp)))
    acc.save_state(str(tmp_path / "ckpt"))
    counter.n = 0
    acc.load_state(str(tmp_path / "ckpt"))
    assert counter.n == 42
    assert seen == [("save", str(tmp_path / "ckpt.tmp")), ("load", str(tmp_path / "ckpt"))]
    handle.remove()
    acc.save_state(str(tmp_path / "ckpt"))
    assert len(seen) == 2


def test_save_model_safetensors_roundtrip(tmp_path):
    acc, model, _, step = _setup()
    _train(step, 2)
    acc.save_model(model, str(tmp_path / "export"))
    assert (tmp_path / "export" / "model.safetensors").exists()
    fresh = create_llama_model(LlamaConfig.tiny(), seed=9, device="cpu")
    load_model(fresh, str(tmp_path / "export"))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("safe_serialization", [True, False])
def test_save_model_sharding_splits(tmp_path, safe_serialization):
    module = torch.nn.ParameterDict({f"w{i}": torch.full((128, 128), float(i)) for i in range(4)})  # 64 KB each
    model = Model(module, config=None)
    save_model(model, str(tmp_path / "export"), max_shard_size="100KB", safe_serialization=safe_serialization)
    index = tmp_path / "export" / "model.safetensors.index.json"
    if safe_serialization:
        weight_map = json.loads(index.read_text())["weight_map"]
        assert len(set(weight_map.values())) >= 2
    else:
        assert not index.exists() and (tmp_path / "export" / "model.pkl").exists()
    fresh = Model(torch.nn.ParameterDict({f"w{i}": torch.zeros(128, 128) for i in range(4)}), config=None)
    load_model(fresh, str(tmp_path / "export"))
    assert all(torch.equal(fresh.module[f"w{i}"], module[f"w{i}"]) for i in range(4))


class Rows:
    """A map-style dataset: row i is ``{"x": float32[3], "y": int32}``."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.y = np.arange(n, dtype=np.int32)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def _fingerprint(batch):
    return tuple(np.asarray(batch[k]).tolist() for k in sorted(batch))


def _loader_setup(n=64, seed=3):
    _reset()
    acc = Accelerator(cpu=True)
    loader = acc.prepare_data_loader(Rows(n), batch_size=8, shuffle=True, seed=seed)
    return acc, loader


def test_exact_mid_epoch_resume(tmp_path):
    """Interrupted after 3 batches, saved, resumed in a fresh Accelerator:
    the batch sequence over two epochs equals an unbroken one, and the JAX
    loader's for the same seed."""
    acc, loader = _loader_setup()
    reference = [_fingerprint(b) for _ in range(2) for b in loader]

    acc, loader = _loader_setup()
    got = []
    it = iter(loader)
    for _ in range(3):
        got.append(_fingerprint(next(it)))
    acc.save_state(str(tmp_path / "ckpt"))
    del it

    acc, loader = _loader_setup()
    acc.load_state(str(tmp_path / "ckpt"))
    assert loader.skip_batches == 3
    got += [_fingerprint(b) for _ in range(2) for b in loader]
    assert got == reference, (len(got), len(reference))

    jax_loader = jdl.prepare_data_loader(Rows(64), put_on_device=False, batch_size=8, shuffle=True, seed=3)
    assert [_fingerprint(b) for _ in range(2) for b in jax_loader] == reference


def test_a_loader_made_beforehand_is_registered_by_prepare(tmp_path):
    """``prepare(model, optimizer, prepare_data_loader(...))`` -- the BERT
    example's pattern -- registers the loader, so a save records its
    position (the JAX package's prepare() passes such a loader through
    unregistered)."""
    acc = Accelerator(cpu=True)
    loader = tdl.prepare_data_loader(Rows(16), batch_size=4, device="cpu")
    assert acc.prepare(loader) is loader and acc._dataloaders == [loader]
    assert acc.prepare(loader) is loader and acc._dataloaders == [loader]  # once only
    next(iter(loader))
    acc.save_state(str(tmp_path / "ck"))
    assert json.loads((tmp_path / "ck" / "samplers.json").read_text())[0]["batches_yielded"] == 1


def test_break_then_save_resume(tmp_path):
    """Break out of the epoch, THEN save: the saved offset attaches to the
    epoch that was being read."""
    acc, loader = _loader_setup(seed=5)
    reference = [_fingerprint(b) for b in loader]
    acc, loader = _loader_setup(seed=5)
    got = []
    for i, b in enumerate(loader):
        got.append(_fingerprint(b))
        if i == 2:
            break
    acc.save_state(str(tmp_path / "ckpt"))
    acc, loader = _loader_setup(seed=5)
    acc.load_state(str(tmp_path / "ckpt"))
    got += [_fingerprint(b) for b in loader]
    assert got == reference, (len(got), len(reference))


def test_checkpointing_example_resumes_the_epoch_on_the_cpu(tmp_path):
    """examples/torch_checkpointing.py --tiny --cpu: saved after half the
    epoch, trained on, rolled back; the resumed epoch has the other half,
    and its first steps repeat the ones taken after the save."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / "torch_checkpointing.py"
    spec = importlib.util.spec_from_file_location("torch_checkpointing", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    resumed = example.main(["--tiny", "--cpu", "--batch_size", "64", "--seq_len", "16", "--keep_training", "2",
                            "--project_dir", str(tmp_path)])
    assert len(resumed) == 4  # 512 rows, 8 batches, saved after 4
    assert [p.name for p in (tmp_path / "checkpoints").iterdir()] == ["checkpoint_0"]


def test_load_before_the_first_step_into_a_step_built_earlier(tmp_path):
    """A fresh process builds its step, then loads: the step trains the
    restored tensors (the parameters were copied into, not rebound), and
    its next step equals the saving run's next step bit for bit."""
    acc, model, opt, step = _setup()
    _train(step, 2)
    acc.save_state(str(tmp_path / "ck"))
    want = _train(step, 1, seed=7)
    want_params = {k: v.clone() for k, v in model.state_dict().items()}

    _reset()
    acc2, model2, opt2, step2 = _setup()
    acc2.load_state(str(tmp_path / "ck"))
    assert _train(step2, 1, seed=7) == want
    for k, v in model2.state_dict().items():
        assert torch.equal(v, want_params[k]), k
    assert acc2.step == 3


def test_async_save_state_roundtrip(tmp_path):
    """async_save returns once the tensors are on the host; training goes
    on while the files are written, and the checkpoint holds the state at
    the save, not after."""
    acc, model, opt, step = _setup()
    _train(step, 1)
    want = _clone_state(model, opt)
    ck = str(tmp_path / "ck")
    acc.save_state(ck, async_save=True)
    _train(step, 2, seed=1)  # training continues while the write is in flight
    acc.wait_for_checkpoint()
    assert verify_manifest(ck, deep=True) == []
    assert read_manifest(ck)["step"] == 1, "the manifest names the step the tensors were copied at"
    acc.load_state(ck)
    _assert_state_equal(model, opt, want)
    _train(step, 1)  # the restored state still steps


def test_async_save_drained_by_next_load(tmp_path):
    acc, model, opt, step = _setup()
    _train(step, 1)
    want = _clone_state(model, opt)
    ck = str(tmp_path / "ck")
    acc.save_state(ck, async_save=True)
    with torch.no_grad():
        for p in model.module.parameters():
            p.add_(1.0)
    acc.load_state(ck)  # no explicit wait: load drains the pending save
    _assert_state_equal(model, opt, want)


def test_every_save_writes_commit_manifest(tmp_path):
    acc, _, _, step = _setup()
    _train(step, 1)
    out = acc.save_state(str(tmp_path / "ckpt"))
    assert (tmp_path / "ckpt" / MANIFEST_NAME).exists()
    assert verify_manifest(out, deep=True) == []
    assert not (tmp_path / "ckpt.tmp").exists()
    manifest = read_manifest(out)
    assert manifest["pytree_dirs"] == ["model", "optimizer"]
    assert manifest["orbax_metadata"] == {"model": False, "optimizer": False}
    assert set(manifest["pytree_files"]) == {"model/model.safetensors", "optimizer/optimizer.bin"}
    topo = manifest["topology"]
    assert topo["process_count"] == 1 and topo["data_parallel_degree"] == 1
    assert topo["arrays"]["model['embed_tokens.weight']"] == {
        "shape": [256, 64], "dtype": "float32", "spec": None, "bytes": 256 * 64 * 4}


def test_explicit_dir_overwrite_stays_atomic(tmp_path):
    acc, model, _, step = _setup()
    _train(step, 1)
    ck = str(tmp_path / "ckpt")
    acc.save_state(ck)
    first_step = read_manifest(ck)["step"]
    _train(step, 1)
    acc.step += 5
    acc.save_state(ck)
    assert verify_manifest(ck, deep=True) == []
    assert read_manifest(ck)["step"] == first_step + 6
    leftovers = [p.name for p in tmp_path.iterdir() if p.name != "ckpt"]
    assert leftovers == [], f"swap left debris: {leftovers}"


def test_an_open_accumulation_window_is_not_saved(tmp_path):
    """As in the JAX package, a save persists the step counter and the
    tensors, not the train step's gradient buffer: a run saved in the
    middle of an accumulation window resumes with a fresh window, so its
    next step only accumulates."""
    acc, model, opt, step = _setup(gradient_accumulation_steps=2)
    _train(step, 1)  # micro-step 1 of 2: nothing applied yet
    acc.save_state(str(tmp_path / "ck"))
    want = _clone_state(model, opt)
    _reset()
    acc2, model2, opt2, step2 = _setup(gradient_accumulation_steps=2)
    acc2.load_state(str(tmp_path / "ck"))
    _train(step2, 1, seed=4)  # micro-step 1 of a new window
    _assert_state_equal(model2, opt2, want)
    assert not acc2.sync_gradients and acc2.step == 2


def test_fp16_loss_scale_and_growth_tracker_round_trip(tmp_path):
    acc, *_ = _setup(mixed_precision="fp16")
    acc._loss_scale, acc._scale_growth_tracker = 1024.0, 17
    acc.save_state(str(tmp_path / "ck"))
    meta = json.loads((tmp_path / "ck" / "accelerate_state.json").read_text())
    assert meta["loss_scale"] == 1024.0 and meta["scale_growth_tracker"] == 17
    acc._loss_scale, acc._scale_growth_tracker = 1.0, 0
    acc.load_state(str(tmp_path / "ck"))
    assert (acc._loss_scale, acc._scale_growth_tracker) == (1024.0, 17)


def test_rng_states_come_back_without_reseeding(tmp_path, monkeypatch):
    import accelerate_tpu_torch.utils.random as port_random
    from accelerate_tpu_torch.utils.random import get_seed, set_seed

    monkeypatch.setattr(port_random, "_GLOBAL_SEED", port_random._GLOBAL_SEED)  # restored after the test

    set_seed(123)
    acc, *_ = _setup()
    np.random.rand(3), torch.rand(3)  # move the streams off their seeded start
    acc.save_state(str(tmp_path / "ck"))
    want = (np.random.rand(), float(torch.rand(())))
    set_seed(7)
    acc.load_state(str(tmp_path / "ck"))
    assert (np.random.rand(), float(torch.rand(()))) == want
    assert get_seed() == 123


# --------------------------------------------------------------------------- #
# the whole slice against the JAX package
# --------------------------------------------------------------------------- #

@functools.cache
def _jax_llama_init():
    return jax.tree.map(np.asarray, jax_create_llama_model(JaxLlamaConfig.tiny(), seed=3, seq_len=SEQ).params)


def _jax_llama_run(batches, ckpt=None, save_after=None):
    """Losses and final params (port names) of the JAX step over
    ``batches``; with ``save_after`` the run saves there and a fresh
    Accelerator resumes from the checkpoint for the rest."""
    def fresh():
        _reset_jax()
        acc = JaxAccelerator()
        model = jax_create_llama_model(JaxLlamaConfig.tiny(), seed=3, seq_len=SEQ)
        model = acc.prepare_model(model)
        acc.prepare_optimizer(optax.adamw(LR, weight_decay=WD))
        return acc, model, acc.build_train_step(lambda p, b: jax_causal_lm_loss(p, b, model.apply_fn))

    def run(acc, step, ids):
        return float(step(jax.device_put({"input_ids": jnp.asarray(ids.astype(np.int32))}, batch_sharding(acc.mesh))))

    acc, model, step = fresh()
    losses = []
    for i, ids in enumerate(batches):
        if save_after is not None and i == save_after:
            acc.save_state(ckpt)
            acc, model, step = fresh()
            acc.load_state(ckpt)
        losses.append(run(acc, step, ids))
    cfg = LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny()))
    params = {k: v.numpy() for k, v in llama_params_from_jax(jax.tree.map(np.asarray, model.params), cfg).items()}
    _reset_jax()
    return losses, params


def _port_llama_run(batches, ckpt=None, save_after=None):
    cfg = LlamaConfig(**dataclasses.asdict(JaxLlamaConfig.tiny()))

    def fresh():
        _reset()
        model = create_llama_model(cfg, device="cpu")
        model.load_state_dict(llama_params_from_jax(_jax_llama_init(), cfg))
        acc = Accelerator(cpu=True)
        model, _ = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD))
        return acc, model, acc.build_train_step(lambda p, b: causal_lm_loss(p, b, model.apply_fn))

    acc, model, step = fresh()
    losses = []
    for i, ids in enumerate(batches):
        if save_after is not None and i == save_after:
            acc.save_state(ckpt)
            acc, model, step = fresh()
            acc.load_state(ckpt)
        losses.append(float(step({"input_ids": torch.from_numpy(ids)})))
    return losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def test_five_step_llama_resumed_after_three_matches_unbroken_and_jax(tmp_path):
    """f32 AdamW, tiny Llama carried across by models/convert.py: saved after
    step 3, resumed in a fresh Accelerator for steps 4-5. Each package's
    resumed run equals its unbroken run bit for bit; the port's losses and
    final parameters are within 1e-4 of the JAX package's."""
    batches = _token_batches(5, seed=11)
    port, port_resumed = _port_llama_run(batches), _port_llama_run(batches, str(tmp_path / "port"), 3)
    jx, jx_resumed = _jax_llama_run(batches), _jax_llama_run(batches, str(tmp_path / "jax"), 3)
    assert port_resumed[0] == port[0]
    assert jx_resumed[0] == jx[0]
    for name in port[1]:
        assert np.array_equal(port_resumed[1][name], port[1][name]), name
        assert np.array_equal(jx_resumed[1][name], jx[1][name]), name
        np.testing.assert_allclose(port[1][name], jx[1][name], rtol=0, atol=JAX_TOL, err_msg=name)
    np.testing.assert_allclose(port[0], jx[0], rtol=JAX_TOL)


def _bert_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1024, (n, SEQ)).astype(np.int32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    ids[labels == 1, 3] = 4
    mask = np.ones((n, SEQ), bool)
    mask[::3, 12:] = False
    return [{"input_ids": ids[i], "attention_mask": mask[i], "labels": labels[i]} for i in range(n)]


def _jax_bert_cfg():
    return JaxBertConfig.tiny(num_hidden_layers=2)


@functools.cache
def _jax_bert_init():
    return jax.tree.map(np.asarray, jax_create_bert_model(_jax_bert_cfg(), seed=1, seq_len=SEQ).params)


def _jax_bert_run(rows, ckpt=None, save_after=None):
    """The JAX fine-tune over a shuffled loader (1 row a shard on the
    8-device mesh: batches of 8); with ``save_after`` it stops there, saves
    and resumes in a fresh Accelerator. Losses, final params (port names)
    and the saved samplers.json."""
    def fresh():
        _reset_jax()
        acc = JaxAccelerator()
        model = jax_create_bert_model(_jax_bert_cfg(), seed=1, seq_len=SEQ)
        # through prepare_data_loader: the JAX package's prepare() does not
        # register a loader made beforehand, so its position would not be saved
        model, _ = acc.prepare(model, optax.adamw(LR, weight_decay=WD))
        loader = acc.prepare_data_loader(rows, batch_size=1, shuffle=True, seed=42)
        return acc, model, loader, acc.build_train_step(lambda p, b: jax_bert_loss(p, b, model.apply_fn))

    acc, model, loader, step = fresh()
    losses, samplers = [], None
    for batch in itertools.islice(loader, save_after):  # no batch fetched past the save
        losses.append(float(step(batch)))
    if save_after is not None:
        acc.save_state(ckpt)
        samplers = json.loads(open(os.path.join(ckpt, "samplers.json")).read())
        acc, model, loader, step = fresh()
        acc.load_state(ckpt)
        losses += [float(step(b)) for b in loader]
    params = bert_params_from_jax(jax.tree.map(np.asarray, model.params), BertConfig(**dataclasses.asdict(_jax_bert_cfg())))
    _reset_jax()
    return losses, {k: v.numpy() for k, v in params.items()}, samplers


def _port_bert_run(rows, ckpt=None, save_after=None):
    cfg = BertConfig(**dataclasses.asdict(_jax_bert_cfg()))

    def fresh():
        _reset()
        model = create_bert_model(cfg, device="cpu")
        model.load_state_dict(bert_params_from_jax(_jax_bert_init(), cfg))
        acc = Accelerator(cpu=True)
        loader = tdl.prepare_data_loader(rows, batch_size=8, shuffle=True, seed=42)
        model, _, loader = acc.prepare(model, torch.optim.AdamW(model.module.parameters(), lr=LR, weight_decay=WD),
                                       loader)
        return acc, model, loader, acc.build_train_step(lambda p, b: bert_classification_loss(p, b, model.apply_fn))

    acc, model, loader, step = fresh()
    losses, samplers, resumed_state = [], None, None
    for batch in itertools.islice(loader, save_after):  # no batch fetched past the save
        losses.append(float(step(batch)))
    if save_after is not None:
        saved_state = loader.state_dict()
        acc.save_state(ckpt)
        samplers = json.loads(open(os.path.join(ckpt, "samplers.json")).read())
        assert samplers == [saved_state]
        acc, model, loader, step = fresh()
        acc.load_state(ckpt)
        resumed_state = loader.state_dict()
        losses += [float(step(b)) for b in loader]
    return losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}, samplers, resumed_state


def test_five_step_bert_resumed_after_three_matches_unbroken_and_jax(tmp_path):
    """Tiny BERT, bert_classification_loss, AdamW over a shuffled loader of
    37 rows (4 batches of 8 and a tail wrapped round to 8): saved after
    step 3 mid-epoch and resumed through samplers.json. Each package's
    resumed run equals its unbroken run; the port within 1e-4 of JAX, but
    the key biases (zero gradient in exact arithmetic, Adam steps them by
    about lr on rounding noise: held to 5 such steps, as
    tests/test_torch_bert.py holds them)."""
    rows = _bert_rows(37)
    port = _port_bert_run(rows)
    port_resumed = _port_bert_run(rows, str(tmp_path / "port"), 3)
    jx = _jax_bert_run(rows)
    jx_resumed = _jax_bert_run(rows, str(tmp_path / "jax"), 3)
    assert len(port[0]) == len(jx[0]) == 5
    assert port_resumed[0] == port[0]
    assert jx_resumed[0] == jx[0]
    saved, resumed_state = port_resumed[2][0], port_resumed[3]
    assert saved["batches_yielded"] == 3 and resumed_state == saved
    assert {k: v for k, v in saved.items() if k != "data_parallel_degree"} == \
        {k: v for k, v in jx_resumed[2][0].items() if k != "data_parallel_degree"}
    for name in port[1]:
        assert np.array_equal(port_resumed[1][name], port[1][name]), name
        assert np.array_equal(jx_resumed[1][name], jx[1][name]), name
        atol = 2 * 5 * LR if name.endswith("attention.key.bias") else JAX_TOL
        np.testing.assert_allclose(port[1][name], jx[1][name], rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(port[0], jx[0], rtol=JAX_TOL)


# --------------------------------------------------------------------------- #
# manifest schema parity
# --------------------------------------------------------------------------- #

def _jax_regression_checkpoint(project_dir):
    _reset_jax()
    acc = JaxAccelerator(project_config=JaxProjectConfiguration(project_dir=str(project_dir),
                                                                automatic_checkpoint_naming=True))
    acc.prepare_model(RegressionModel())
    acc.prepare_optimizer(optax.adam(0.05))
    step = acc.build_train_step(linear_loss_fn)
    step({"x": np.ones((8,), np.float32), "y": 2 * np.ones((8,), np.float32)})
    out = acc.save_state()
    _reset_jax()
    return out


def test_manifest_schema_parity_both_ways(tmp_path):
    acc, _, _, step = _setup(str(tmp_path / "port"), automatic=True)
    _train(step, 1)
    port_ckpt = acc.save_state()
    assert jft.verify_manifest(port_ckpt, deep=True) == []
    assert str(jft.CheckpointManager(tmp_path / "port" / "checkpoints").latest()) == port_ckpt

    jax_ckpt = _jax_regression_checkpoint(tmp_path / "jax")
    assert verify_manifest(jax_ckpt, deep=True) == []
    assert str(CheckpointManager(tmp_path / "jax" / "checkpoints").latest()) == jax_ckpt
    assert CheckpointManager(tmp_path / "jax" / "checkpoints").verify(jax_ckpt).ok

    port_m, jax_m = read_manifest(port_ckpt), read_manifest(jax_ckpt)
    assert port_m.keys() == jax_m.keys()
    assert port_m["topology"].keys() == jax_m["topology"].keys()
    assert port_m["schema_version"] == jax_m["schema_version"] == jft.MANIFEST_SCHEMA_VERSION
    assert set(jax_m["orbax_metadata"].values()) == {True}  # the port checks orbax markers where JAX wrote them
    # damage a JAX array file: the port's deep verify sees it
    rel = max(jax_m["pytree_files"], key=jax_m["pytree_files"].get)
    with open(os.path.join(jax_ckpt, rel), "ab") as f:
        f.write(b"x")
    assert any(rel in p for p in verify_manifest(jax_ckpt, deep=True))


# --------------------------------------------------------------------------- #
# safetensors format parity
# --------------------------------------------------------------------------- #

DTYPE_CASES = {
    "F32": (torch.float32, np.float32),
    "BF16": (torch.bfloat16, ml_dtypes.bfloat16),
    "F16": (torch.float16, np.float16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}


def _np_values(np_dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np_dtype == np.bool_:
        return rng.integers(0, 2, shape).astype(bool)
    if np.issubdtype(np.dtype(np_dtype), np.integer):
        info = np.iinfo(np_dtype)
        return rng.integers(max(info.min, -1000), min(info.max, 1000), shape).astype(np_dtype)
    return rng.standard_normal(shape).astype(np.float32).astype(np_dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("code", list(DTYPE_CASES))
def test_safetensors_files_read_both_ways(tmp_path, code):
    """A file the port writes loads through safetensors.numpy bit for bit,
    and one safetensors.numpy writes loads through the port's reader, with
    tensors of two element sizes, a scalar and an empty one beside it."""
    torch_dtype, np_dtype = DTYPE_CASES[code]
    arrays = {"a": _np_values(np_dtype, (3, 5), 0), "s": _np_values(np_dtype, (), 1),
              "odd": _np_values(np.int8, (7,), 2), "e": np.zeros((0, 4), np_dtype)}
    tensors = {k: torch.from_numpy(np.array(v).view(np.uint16)).view(torch.bfloat16) if v.dtype == ml_dtypes.bfloat16
               else torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    assert tensors["a"].dtype == torch_dtype
    safetensors_io.save_file(tensors, tmp_path / "port.safetensors")
    got = np_load_file(str(tmp_path / "port.safetensors"))
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(_bits(got[k]), _bits(v)), k

    np_save_file(arrays, str(tmp_path / "np.safetensors"), metadata={"format": "np"})  # a header the reader skips
    back = safetensors_io.load_file(tmp_path / "np.safetensors")
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def test_safetensors_reader_refuses_what_it_does_not_know(tmp_path):
    np_save_file({"d": np.ones(3, np.float64)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        safetensors_io.load_file(tmp_path / "f64.safetensors")
    with pytest.raises(ValueError, match="complex"):
        safetensors_io.save_file({"c": torch.ones(2, dtype=torch.complex64)}, tmp_path / "c.safetensors")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jax_load_model_reads_a_port_export(tmp_path, dtype):
    module = torch.nn.ParameterDict({"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).to(dtype),
                                     "b": torch.arange(6, dtype=torch.float32).to(dtype)})
    save_model(Model(module, config=None), str(tmp_path / "export"), max_shard_size="40B")
    assert (tmp_path / "export" / "model.safetensors.index.json").exists()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = JaxModel(lambda p, x: x, {"w": jnp.zeros((4, 6), jdtype), "b": jnp.zeros((6,), jdtype)})
    jax_load_model(jmodel, str(tmp_path / "export"))
    for name in ("w", "b"):
        want = module[name].detach().float().numpy()
        got = np.asarray(jmodel.params[name]).astype(np.float32)
        assert np.array_equal(got, want), name
