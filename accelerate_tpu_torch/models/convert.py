"""Carry weights across from the JAX package's llama.

``llama_params_from_jax`` takes the flax param tree of
:func:`accelerate_tpu.models.llama.create_llama_model` as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, model.params)``) and returns the
state dict of the port's :class:`~.llama.LlamaModel`. Both layouts of the
JAX tree are read: the scanned one (``layers/block/...`` leaves with a
leading ``[L]`` axis, from ``nn.scan`` over ``_ScanLayer``) and the
unrolled one (``layer_<i>/...``). Flax ``Dense`` kernels are ``[in,
out]``; ``nn.Linear`` weights are ``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch

# (flax path inside one layer, port name inside one layer, is a Dense kernel)
_LAYER_LEAVES = (
    (("input_norm", "scale"), "input_norm.weight", False),
    (("post_attn_norm", "scale"), "post_attn_norm.weight", False),
    (("attn", "q_proj", "kernel"), "attn.q_proj.weight", True),
    (("attn", "k_proj", "kernel"), "attn.k_proj.weight", True),
    (("attn", "v_proj", "kernel"), "attn.v_proj.weight", True),
    (("attn", "o_proj", "kernel"), "attn.o_proj.weight", True),
    (("mlp", "gate_proj", "kernel"), "mlp.gate_proj.weight", True),
    (("mlp", "up_proj", "kernel"), "mlp.up_proj.weight", True),
    (("mlp", "down_proj", "kernel"), "mlp.down_proj.weight", True),
)


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _tensor(arr: np.ndarray, dense_kernel: bool) -> torch.Tensor:
    return torch.from_numpy(np.array(arr.T if dense_kernel else arr, dtype=np.float32, order="C"))


def llama_params_from_jax(params: dict, config) -> dict:
    """The port's llama state dict (f32 tensors) from a JAX llama param
    tree. Load it with ``model.load_state_dict``, which casts to each
    parameter's dtype."""
    n_layers = config.num_hidden_layers
    if "layers" in params:
        block = params["layers"]["block"]

        def layer_leaf(i, path):
            return _get(block, path)[i]
    else:
        def layer_leaf(i, path):
            return _get(params[f"layer_{i}"], path)

    sd = {
        "embed_tokens.weight": _tensor(_get(params, ("embed_tokens", "embedding")), False),
        "final_norm.weight": _tensor(_get(params, ("final_norm", "scale")), False),
    }
    for i in range(n_layers):
        for path, name, dense in _LAYER_LEAVES:
            sd[f"layers.{i}.{name}"] = _tensor(layer_leaf(i, path), dense)
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _tensor(_get(params, ("lm_head", "kernel")), True)
    return sd
