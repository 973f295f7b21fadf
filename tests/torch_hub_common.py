"""Shared set-up of the HF importer parity tests (test_torch_hub_decoders.py,
test_torch_hub_encoders.py): seeded HF-named checkpoints written with
``safetensors.numpy.save_file``, in one f32 file and as two bf16 shards
with an index, the JAX package's loads cached for a module, and the
comparison of the port's loaded state dict with the JAX loaded params
carried by ``models/convert.py``."""

import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import accelerate_tpu.models as jm
import accelerate_tpu.models.hub as jhub
import accelerate_tpu_torch.models as pm
import accelerate_tpu_torch.models.hub as phub

INDEX = "model.safetensors.index.json"
SHARDS = ("model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors")


def configs(cls_name: str, **kw):
    """The JAX ``tiny()`` config and the port's twin."""
    jcfg = getattr(jm, cls_name).tiny(**kw)
    return jcfg, getattr(pm, cls_name)(**dataclasses.asdict(jcfg))


def port_shapes(family: str, cfg) -> dict:
    """``{port parameter name: shape}`` of the port's ``family`` model at ``cfg``."""
    model = getattr(pm, f"create_{family}_model")(cfg, device="cpu")
    return {n: tuple(p.shape) for n, p in model.params.items()}


def hf_state(shapes: dict, seed: int = 0, dtype=np.float32) -> dict:
    """Seeded values at a trained model's scales: matrices ``N(0, 1/fan_in)``,
    norm scales near one, biases and vectors near zero."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, shape in shapes.items():
        noise = rng.standard_normal(shape)
        if len(shape) > 1:
            value = noise / np.sqrt(shape[-1])
        else:
            value = (1.0 if "norm" in name else 0.0) + 0.1 * noise
        state[name] = np.asarray(value, np.float32).astype(dtype)
    return state


def write_shards(state: dict, directory, split=None) -> dict:
    """``state`` as two shards and their index in ``directory``:
    ``{shard file: its names}``. ``split(name)`` puts a name in the second
    shard (default: the second half of the sorted names)."""
    names = sorted(state)
    second = set(filter(split, names)) if split else set(names[len(names) // 2:])
    files = {SHARDS[0]: [n for n in names if n not in second], SHARDS[1]: [n for n in names if n in second]}
    for fname, part in files.items():
        save_file({n: state[n] for n in part}, os.path.join(directory, fname))
    weight_map = {n: fname for fname, part in files.items() for n in part}
    with open(os.path.join(directory, INDEX), "w") as f:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map}, f)
    return files


def jax_leaves(jmodel) -> int:
    return len(jax.tree_util.tree_leaves(jmodel.params))


def assert_state_equal(got: dict, want: dict, to_bf16: bool = False):
    """Bit-equal state dicts; with ``to_bf16`` the wanted values rounded to
    bf16 first (a bf16 copy of the checkpoint)."""
    assert set(got) == set(want)
    for name, value in want.items():
        if to_bf16:
            value = value.to(torch.bfloat16).float()
        assert torch.equal(got[name].float(), value), name


def check_family(family: str, case: str, cfg, convert, jax_loaded, tmp_path):
    """The family's seeded f32 checkpoint loaded by both packages: the
    port's state dict equals the JAX params carried by ``convert``, bit for
    bit, both counting every leaf of the model; the same tensors as two
    bf16 shards with an index load as the JAX params rounded to bf16."""
    path, state, jmodel = jax_loaded(case)
    want = convert(jax.tree.map(np.asarray, jmodel.params), cfg)
    load = getattr(phub, f"load_hf_{family}")
    model = load(path, cfg, device="cpu")
    assert model.device.type == "cpu"
    assert_state_equal(model.state_dict(), want)
    assert model.imported_weight_count == jmodel.imported_weight_count == jax_leaves(jmodel)
    write_shards({n: v.astype(ml_dtypes.bfloat16) for n, v in state.items()}, tmp_path)
    sharded = load(str(tmp_path), cfg, device="cpu")
    assert_state_equal(sharded.state_dict(), want, to_bf16=True)
    assert sharded.imported_weight_count == jmodel.imported_weight_count


def make_jax_loaded(tmp_path_factory, build):
    """``get(case)``: ``(path, state, JAX model)`` of the seeded f32
    single-file checkpoint ``build(case)`` gives as ``(family, jax config,
    {HF name: shape})``, written and loaded by the JAX package once for the
    module (a JAX load is most of a test's time)."""
    cache = {}

    def get(case):
        if case not in cache:
            family, jcfg, shapes = build(case)
            state = hf_state(shapes)
            path = str(tmp_path_factory.mktemp(case) / "model.safetensors")
            save_file(state, path)
            cache[case] = path, state, getattr(jhub, f"load_hf_{family}")(path, jcfg)
        return cache[case]

    return get


def refusal_messages(family: str, jcfg, cfg, state: dict, tmp_path) -> tuple[str, str]:
    """The ``ValueError`` texts both packages' loaders raise on ``state``."""
    path = str(tmp_path / "model.safetensors")
    save_file(state, path)
    with pytest.raises(ValueError) as want:
        getattr(jhub, f"load_hf_{family}")(path, jcfg)
    with pytest.raises(ValueError) as got:
        getattr(phub, f"load_hf_{family}")(path, cfg, device="cpu")
    return str(got.value), str(want.value)
