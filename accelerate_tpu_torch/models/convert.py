"""Carry weights across from the JAX package's llama and BERT.

``llama_params_from_jax`` takes the flax param tree of
:func:`accelerate_tpu.models.llama.create_llama_model` as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, model.params)``) and returns the
state dict of the port's :class:`~.llama.LlamaModel`. Both layouts of the
JAX tree are read: the scanned one (``layers/block/...`` leaves with a
leading ``[L]`` axis, from ``nn.scan`` over ``_ScanLayer``) and the
unrolled one (``layer_<i>/...``). Flax ``Dense`` kernels are ``[in,
out]``; ``nn.Linear`` weights are ``[out, in]``. A tree quantized by the
JAX package's ``load_and_quantize_model`` carries ``qdata``/``qscale``
leaves in place of each projection's ``kernel``: they cross unchanged
(``QuantDense`` keeps the reference's layout), integer codes as integers.
``bert_params_from_jax`` does the same for
:func:`accelerate_tpu.models.bert.create_bert_model`'s tree (unrolled
``layer_<i>``; ``Embed`` tables cross as they are).
"""

from __future__ import annotations

import numpy as np
import torch

# (flax path inside one layer, port name inside one layer)
_LAYER_NORMS = (
    (("input_norm", "scale"), "input_norm.weight"),
    (("post_attn_norm", "scale"), "post_attn_norm.weight"),
)
_LAYER_PROJS = (
    (("attn", "q_proj"), "attn.q_proj"),
    (("attn", "k_proj"), "attn.k_proj"),
    (("attn", "v_proj"), "attn.v_proj"),
    (("attn", "o_proj"), "attn.o_proj"),
    (("mlp", "gate_proj"), "mlp.gate_proj"),
    (("mlp", "up_proj"), "mlp.up_proj"),
    (("mlp", "down_proj"), "mlp.down_proj"),
)


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _tensor(arr: np.ndarray, dense_kernel: bool) -> torch.Tensor:
    return torch.from_numpy(np.array(arr.T if dense_kernel else arr, dtype=np.float32, order="C"))


def _codes(arr: np.ndarray) -> torch.Tensor:
    """Quantized leaves keep their dtype (int8 / uint8 codes, f32 scales)."""
    return torch.from_numpy(np.array(arr, order="C"))


def llama_params_from_jax(params: dict, config) -> dict:
    """The port's llama state dict (f32 tensors; integer codes for a
    quantized tree) from a JAX llama param tree. Load it with
    ``model.load_state_dict``, which casts to each parameter's dtype."""
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
        for path, name in _LAYER_NORMS:
            sd[f"layers.{i}.{name}"] = _tensor(layer_leaf(i, path), False)
        for path, name in _LAYER_PROJS:
            if config.quant_method is None:
                sd[f"layers.{i}.{name}.weight"] = _tensor(layer_leaf(i, (*path, "kernel")), True)
            else:
                sd[f"layers.{i}.{name}.qdata"] = _codes(layer_leaf(i, (*path, "qdata")))
                sd[f"layers.{i}.{name}.qscale"] = _codes(layer_leaf(i, (*path, "qscale")))
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _tensor(_get(params, ("lm_head", "kernel")), True)
    return sd


def bert_params_from_jax(params: dict, config) -> dict:
    """The port's BERT state dict (f32 tensors) from a JAX BERT param tree
    (nested dicts of numpy arrays): Dense ``kernel [in, out]`` becomes
    ``weight [out, in]``, LayerNorm ``scale`` becomes ``weight``, ``Embed``
    tables cross as they are."""
    enc = params["encoder"]
    sd = {}

    def dense(port: str, tree: dict):
        sd[f"{port}.weight"] = _tensor(_get(tree, ("kernel",)), True)
        sd[f"{port}.bias"] = _tensor(_get(tree, ("bias",)), False)

    def norm(port: str, tree: dict):
        sd[f"{port}.weight"] = _tensor(_get(tree, ("scale",)), False)
        sd[f"{port}.bias"] = _tensor(_get(tree, ("bias",)), False)

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"encoder.embeddings.{name}.weight"] = _tensor(_get(enc, (f"embeddings/{name}", "embedding")), False)
    norm("encoder.embeddings.norm", enc["embeddings/norm"])
    for i in range(config.num_hidden_layers):
        layer, port = enc[f"layer_{i}"], f"encoder.layers.{i}"
        for proj in ("query", "key", "value", "out"):
            dense(f"{port}.attention.{proj}", layer["attention"][proj])
        dense(f"{port}.ffn.intermediate", layer["ffn/intermediate"])
        dense(f"{port}.ffn.output", layer["ffn/output"])
        norm(f"{port}.attention_norm", layer["attention_norm"])
        norm(f"{port}.ffn_norm", layer["ffn_norm"])
    dense("pooler", params["pooler"])
    dense("classifier", params["classifier"])
    return sd
