"""The port's batch operations and one-process collectives
(accelerate_tpu_torch.utils.operations) against the JAX package's, on the
same nested dict / list / tuple structures made with numpy from a seed."""

import numpy as np
import pytest
import torch

from accelerate_tpu.utils import operations as jops
from accelerate_tpu_torch.utils import operations as tops

torch.set_num_threads(2)


def _structure(seed=0, rows=4):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((rows, 3)).astype(np.float32),
        "b": [rng.integers(0, 9, rows).astype(np.int32), (rng.standard_normal((rows, 2)).astype(np.float16), "tag")],
        "c": {"d": rng.standard_normal((rows, 5)).astype(np.float32)},
    }


def _torch(tree):
    return tops.recursively_apply(torch.from_numpy, tree)


def _numpy(tree):
    """Leaves as numpy, containers as plain dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree) if hasattr(tree, "dtype") else tree


def _assert_same(got, want, same_dtype=True):
    """Equal nesting and equal leaves; ``same_dtype=False`` lets the
    result's dtype follow each library's promotion (numpy takes an int32
    array times a float to float64, torch to float32)."""
    got, want = _numpy(got), _numpy(want)
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k], same_dtype)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, same_dtype)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and (got.dtype == want.dtype or not same_dtype)
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        assert got == want


@pytest.mark.parametrize(
    "name,args",
    [
        ("recursively_apply", lambda t: (lambda x: x * 2, t)),
        ("slice_tensors", lambda t: (t, slice(1, 3))),
        ("convert_to_fp32", lambda t: (t,)),
        ("gather", lambda t: (t,)),
        ("broadcast", lambda t: (t,)),
        ("reduce", lambda t: (t, "mean", 0.5)),
        ("reduce", lambda t: (t, "sum", 3.0)),
        ("pad_across_processes", lambda t: (t, 1)),
        ("pad_input_tensors", lambda t: (t, 4, 3)),
        ("send_to_device", lambda t: (t,)),
    ],
    ids=["recursively_apply", "slice_tensors", "convert_to_fp32", "gather", "broadcast", "reduce_mean",
         "reduce_sum", "pad_across_processes", "pad_input_tensors", "send_to_device"],
)
def test_structure_ops_match_jax(name, args):
    tree = _structure()
    want = getattr(jops, name)(*args(tree))
    got = getattr(tops, name)(*args(_torch(tree)))
    _assert_same(got, want, same_dtype=name != "reduce")


def test_concatenate_find_batch_size_and_data_structure_match_jax():
    parts = [_structure(0), _structure(1, rows=2)]
    for mod, tree in ((tops, parts), (jops, parts)):
        with pytest.raises(TypeError, match="Can only concatenate"):  # the string leaf
            mod.concatenate(tree)
    for part in parts:
        part["b"][1] = part["b"][1][:1]
    _assert_same(tops.concatenate([_torch(p) for p in parts]), jops.concatenate(parts))
    # numpy leaves stay numpy, as in the JAX package off the device
    _assert_same(tops.concatenate(parts), jops.concatenate(parts))
    tree = _structure(rows=6)
    assert tops.find_batch_size(_torch(tree)) == jops.find_batch_size(tree) == 6
    assert tops.find_batch_size({"x": "no arrays"}) is jops.find_batch_size({"x": "no arrays"}) is None
    skeleton = tops.get_data_structure(_torch(tree))
    jskeleton = jops.get_data_structure(tree)
    flat = lambda t: [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in tops._leaves(t)  # noqa: E731
                      if hasattr(x, "dtype")]
    assert flat(skeleton) == flat(jskeleton)
    _assert_same(tops.initialize_tensors(skeleton), jops.initialize_tensors(jskeleton))


def test_send_to_device_takes_numpy_leaves_and_skip_keys():
    tree = _structure()
    moved = tops.send_to_device(tree, "cpu", skip_keys=["c"])
    assert isinstance(moved["a"], torch.Tensor) and moved["c"] is tree["c"]
    _assert_same(moved["b"], tree["b"])


def test_object_collectives_and_fp32_wrapper_match_jax():
    objs = [{"k": 1}, "two", 3.0]
    assert tops.gather_object(objs) == jops.gather_object(objs) == objs
    assert tops.broadcast_object_list(objs) is objs and jops.broadcast_object_list(objs) is objs
    assert tops.scatter_object(["mine"]) == jops.scatter_object(["mine"]) == "mine"
    with pytest.raises(ValueError, match="1 payloads"):
        tops.scatter_object(["a", "b"])

    def half(x):
        return {"y": x.half(), "n": torch.arange(3)}

    out = tops.convert_outputs_to_fp32(half)(torch.ones(2))
    assert out["y"].dtype == torch.float32 and out["n"].dtype == torch.int64
    assert tops.convert_outputs_to_fp32(half).__name__ == "half"


def test_debug_mode_verifies_one_process_without_raising(monkeypatch):
    monkeypatch.setenv("ACCELERATE_DEBUG_MODE", "1")
    tree = _torch(_structure())
    _assert_same(tops.gather(tree), tree)
    assert issubclass(tops.DistributedOperationException, Exception)


def test_recursively_apply_errors_on_other_types_like_jax():
    tree = _structure()
    with pytest.raises(TypeError, match="Unsupported type"):
        jops.recursively_apply(lambda x: x, tree, error_on_other_type=True)
    with pytest.raises(TypeError, match="Unsupported type"):
        tops.recursively_apply(lambda x: x, _torch(tree), error_on_other_type=True)
