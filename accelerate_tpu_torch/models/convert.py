"""Carry weights across from the JAX package's llama and BERT.

``llama_params_from_jax`` takes the flax param tree of
:func:`accelerate_tpu.models.llama.create_llama_model` as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, model.params)``) and returns the
state dict of the port's :class:`~.llama.LlamaModel`. Both layouts of the
JAX tree are read: the scanned one (``layers/block/...`` leaves with a
leading ``[L]`` axis, from ``nn.scan`` over ``_ScanLayer``) and the
unrolled one (``layer_<i>/...``). Flax ``Dense`` kernels are ``[in,
out]``; ``nn.Linear`` weights are ``[out, in]``. The family knobs' leaves
cross too: the q/k/v biases (``qkv_bias``), ``q_norm``/``k_norm`` (per
head or flat), the sandwich and post norms, no ``input_norm`` under
``norm_after``, and no ``lm_head`` under a tied head. A tree quantized by the
JAX package's ``load_and_quantize_model`` carries ``qdata``/``qscale``
leaves in place of each projection's ``kernel``: they cross unchanged
(``QuantDense`` keeps the reference's layout), integer codes as integers.
A JAX model built under the delayed fp8 recipe carries its amax
histories in an ``fp8`` collection (``model.state``, scanned ``[L, H]``
leaves or unrolled ``[H]`` ones): pass it as ``state`` and they cross
into the ``FP8Dense`` buffers of the same names.
``bert_params_from_jax`` does the same for
:func:`accelerate_tpu.models.bert.create_bert_model`'s tree (unrolled
``layer_<i>``; ``Embed`` tables cross as they are), and
``resnet_params_from_jax`` for
:func:`accelerate_tpu.models.resnet.create_resnet_model`'s params and
BatchNorm statistics (``Conv`` kernels ``[kh, kw, in, out]`` become
``Conv2d`` weights ``[out, in, kh, kw]``).
"""

from __future__ import annotations

import numpy as np
import torch

# (flax path inside one layer, port name inside one layer)
_LAYER_NORMS = (
    (("input_norm", "scale"), "input_norm.weight"),
    (("post_attn_norm", "scale"), "post_attn_norm.weight"),
    (("pre_ffn_norm", "scale"), "pre_ffn_norm.weight"),
    (("post_ffn_norm", "scale"), "post_ffn_norm.weight"),
    (("attn", "q_norm", "scale"), "attn.q_norm.weight"),
    (("attn", "k_norm", "scale"), "attn.k_norm.weight"),
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


def _layer_norms(config) -> list:
    """The norms one layer of ``config`` holds, as ``_LAYER_NORMS`` entries."""
    names = {"post_attn_norm"}
    if not config.norm_after:
        names.add("input_norm")
    if config.norm_after or config.sandwich_norm:
        names.add("post_ffn_norm")
    if config.sandwich_norm and not config.norm_after:
        names.add("pre_ffn_norm")
    if config.qk_norm or config.qk_norm_flat:
        names |= {"q_norm", "k_norm"}
    return [(path, name) for path, name in _LAYER_NORMS if path[-2] in names]


def _layer_reader(tree: dict):
    """``leaf(i, path)`` of layer ``i`` in either JAX layout."""
    if "layers" in tree:
        block = tree["layers"]["block"]
        return lambda i, path: _get(block, path)[i]
    return lambda i, path: _get(tree[f"layer_{i}"], path)


def llama_params_from_jax(params: dict, config, state: dict = None) -> dict:
    """The port's llama state dict (f32 tensors; integer codes for a
    quantized tree) from a JAX llama param tree of any family's knobs,
    and, with ``state`` (the JAX model's ``model.state``), the fp8 amax
    histories. Load it with ``model.load_state_dict``, which casts to each
    parameter's dtype."""
    n_layers = config.num_hidden_layers
    layer_leaf = _layer_reader(params)

    sd = {
        "embed_tokens.weight": _tensor(_get(params, ("embed_tokens", "embedding")), False),
        "final_norm.weight": _tensor(_get(params, ("final_norm", "scale")), False),
    }
    norms = _layer_norms(config)
    for i in range(n_layers):
        for path, name in norms:
            sd[f"layers.{i}.{name}"] = _tensor(layer_leaf(i, path), False)
        if config.qkv_bias:
            for path, name in _LAYER_PROJS[:3]:
                sd[f"layers.{i}.{name}.bias"] = _tensor(layer_leaf(i, (*path, "bias")), False)
        for path, name in _LAYER_PROJS:
            if config.quant_method is None:
                sd[f"layers.{i}.{name}.weight"] = _tensor(layer_leaf(i, (*path, "kernel")), True)
            else:
                sd[f"layers.{i}.{name}.qdata"] = _codes(layer_leaf(i, (*path, "qdata")))
                sd[f"layers.{i}.{name}.qscale"] = _codes(layer_leaf(i, (*path, "qscale")))
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _tensor(_get(params, ("lm_head", "kernel")), True)
    fp8 = (state or {}).get("fp8")
    if fp8:
        hist_leaf = _layer_reader(fp8)
        for i in range(n_layers):
            for path, name in _LAYER_PROJS:
                for hist in ("amax_history_x", "amax_history_k"):
                    sd[f"layers.{i}.{name}.{hist}"] = _tensor(hist_leaf(i, (*path, hist)), False)
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


def resnet_params_from_jax(params: dict, batch_stats: dict) -> dict:
    """The port's ResNet state dict (f32 tensors), parameters and running
    statistics, from a JAX ResNet's ``params`` and ``batch_stats`` (nested
    dicts of numpy arrays; ``batch_stats`` may be ``model.state`` itself,
    ``{"batch_stats": ...}``). The module paths are the same; a ``Conv``
    kernel (HWIO) becomes a ``Conv2d`` weight (OIHW), the ``Dense`` kernel
    ``[in, out]`` a ``Linear`` weight ``[out, in]``, a BatchNorm ``scale``
    its ``weight``; ``mean`` and ``var`` become the buffers of those names."""
    batch_stats = batch_stats.get("batch_stats", batch_stats)
    sd = {}

    def walk(tree: dict, prefix: str):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value)
            if key == "kernel" and arr.ndim == 4:
                sd[f"{prefix}weight"] = torch.from_numpy(np.array(arr.transpose(3, 2, 0, 1), np.float32, order="C"))
            elif key == "kernel":
                sd[f"{prefix}weight"] = _tensor(arr, True)
            else:
                sd[f"{prefix}{'weight' if key == 'scale' else key}"] = _tensor(arr, False)

    walk(params, "")
    walk(batch_stats, "")
    return sd
