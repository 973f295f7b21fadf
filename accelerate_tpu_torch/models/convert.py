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
``mixtral_params_from_jax`` carries a Mixtral or Qwen3-MoE tree
(unrolled ``layer_<i>``): attention and norms as the llama's, and the
``moe`` dict, whose keys are slashed names inside it (``router/kernel``
``[d, E]`` becomes ``moe.router.weight [E, d]``; ``experts/gate_proj``,
``experts/up_proj`` ``[E, d, ff]`` and ``experts/down_proj`` ``[E, ff, d]``
cross as they are). ``gpt2_params_from_jax`` and
``gptneox_params_from_jax`` carry the GPT decoders: biased Dense layers,
LayerNorm ``scale``/``bias``, the position table, a tied or untied head.
``bert_params_from_jax`` does the same for
:func:`accelerate_tpu.models.bert.create_bert_model`'s tree (unrolled
``layer_<i>``; ``Embed`` tables cross as they are), and
``resnet_params_from_jax`` for
:func:`accelerate_tpu.models.resnet.create_resnet_model`'s params and
BatchNorm statistics (``Conv`` kernels ``[kh, kw, in, out]`` become
``Conv2d`` weights ``[out, in, kh, kw]``). ``t5_params_from_jax`` and
``whisper_params_from_jax`` carry the encoder-decoder families: the
``enc_layer_<i>`` / ``dec_layer_<i>`` subtrees become ``enc_layers.<i>`` /
``dec_layers.<i>``; two flax names hold a literal ``/``:
``relative_bias/embedding`` (only in layer 0's ``attn`` and
``self_attn``: T5's bias table) becomes ``relative_bias`` and
``dec_pos/embedding`` (Whisper's decoder positions) ``dec_pos``; a 1-D
``Conv`` kernel ``[k, in, out]`` becomes a ``Conv1d`` weight ``[out, in,
k]``; a tied head is the ``shared`` / ``embed_tokens`` table, an untied
one ``lm_head``. ``vit_params_from_jax``, ``clip_params_from_jax``,
``unet_params_from_jax`` and ``vae_params_from_jax`` carry the vision and
diffusion families, whose port modules keep the flax names: a flax name
holding a ``/`` (``attention/query``, ``vision/block_0``,
``text/token_embed``) is indexed whole in the tree and read as a
submodule path in the port, and a parameter named ``.../embedding``
(``vision/pos_embed/embedding``) as the parameter itself; ``Conv``
kernels ``[kh, kw, in, out]`` become ``Conv2d`` weights ``[out, in, kh,
kw]``, and GroupNorm's ``scale`` and ``bias`` sit under ``.../gn``.
"""

from __future__ import annotations

import re

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


def mixtral_params_from_jax(params: dict, config) -> dict:
    """The port's Mixtral / Qwen3-MoE state dict (f32 tensors) from a JAX
    Mixtral param tree (nested dicts of numpy arrays)."""
    sd = {
        "embed_tokens.weight": _tensor(_get(params, ("embed_tokens", "embedding")), False),
        "final_norm.weight": _tensor(_get(params, ("final_norm", "scale")), False),
        "lm_head.weight": _tensor(_get(params, ("lm_head", "kernel")), True),
    }
    norms = [(path, name) for path, name in _LAYER_NORMS if path[-2] in ("input_norm", "post_attn_norm")
             or (config.qk_norm and path[-2] in ("q_norm", "k_norm"))]
    for i in range(config.num_hidden_layers):
        layer, port = params[f"layer_{i}"], f"layers.{i}"
        for path, name in norms:
            sd[f"{port}.{name}"] = _tensor(_get(layer, path), False)
        for path, name in _LAYER_PROJS[:4]:
            sd[f"{port}.{name}.weight"] = _tensor(_get(layer, (*path, "kernel")), True)
        moe = layer["moe"]
        sd[f"{port}.moe.router.weight"] = _tensor(_get(moe, ("router/kernel",)), True)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{port}.moe.experts.{proj}"] = _tensor(_get(moe, (f"experts/{proj}",)), False)
    return sd


def _gpt_params(params: dict, config, names: dict) -> dict:
    """The GPT decoders' common walk; ``names`` maps the port's module
    names to the JAX tree's (``embed``, ``ln1``, ``ln2``, ``final``,
    ``head``)."""
    sd = {f"{names['embed']}.weight": _tensor(_get(params, (names["embed"], "embedding")), False)}

    def dense(port: str, tree: dict):
        sd[f"{port}.weight"] = _tensor(_get(tree, ("kernel",)), True)
        sd[f"{port}.bias"] = _tensor(_get(tree, ("bias",)), False)

    def norm(port: str, tree: dict):
        sd[f"{port}.weight"] = _tensor(_get(tree, ("scale",)), False)
        sd[f"{port}.bias"] = _tensor(_get(tree, ("bias",)), False)

    for i in range(config.num_hidden_layers):
        layer, port = params[f"layer_{i}"], f"layers.{i}"
        norm(f"{port}.{names['ln1']}", layer[names["ln1"]])
        norm(f"{port}.{names['ln2']}", layer[names["ln2"]])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(f"{port}.attn.{proj}", layer["attn"][proj])
        for fc in ("fc_in", "fc_out"):
            dense(f"{port}.mlp.{fc}", layer["mlp"][fc])
    norm(names["final"], params[names["final"]])
    if names["head"] is not None:
        sd[f"{names['head']}.weight"] = _tensor(_get(params, (names["head"], "kernel")), True)
    return sd


def gpt2_params_from_jax(params: dict, config) -> dict:
    """The port's GPT-2 state dict (f32 tensors) from a JAX GPT-2 param tree
    (``wte``, ``wpe``, ``layer_<i>/{ln_1,attn,ln_2,mlp}``, ``ln_f`` and, when
    untied, ``lm_head``)."""
    head = None if config.tie_word_embeddings else "lm_head"
    sd = _gpt_params(params, config, {"embed": "wte", "ln1": "ln_1", "ln2": "ln_2", "final": "ln_f", "head": head})
    sd["wpe.weight"] = _tensor(_get(params, ("wpe", "embedding")), False)
    return sd


def gptneox_params_from_jax(params: dict, config) -> dict:
    """The port's GPT-NeoX state dict (f32 tensors) from a JAX GPT-NeoX param
    tree (``embed_in``, ``layer_<i>/{input_norm,attn,post_attn_norm,mlp}``,
    ``final_norm``, ``embed_out``)."""
    return _gpt_params(params, config, {"embed": "embed_in", "ln1": "input_norm", "ln2": "post_attn_norm",
                                        "final": "final_norm", "head": "embed_out"})


# flax leaf names that hold a "/" (a param named with a path), and what the port calls them
_SLASHED = {"relative_bias/embedding": "relative_bias", "dec_pos/embedding": "dec_pos"}


def _seq2seq_params(params: dict, layer_counts: tuple) -> dict:
    """The encoder-decoder families' walk: every leaf by its path, with the
    stacks' layer subtrees renamed, Dense and Conv kernels transposed,
    ``scale`` and ``embedding`` as ``weight``. ``layer_counts`` is the
    config's ``(encoder, decoder)`` depth, held against the tree's."""
    sd = {}

    def walk(tree: dict, prefix: str):
        for key, value in tree.items():
            if isinstance(value, dict):
                m = re.fullmatch(r"(enc|dec)_layer_(\d+)", key)
                walk(value, f"{prefix}{m[1]}_layers.{m[2]}." if m else f"{prefix}{key}.")
                continue
            arr = np.asarray(value)
            if key in _SLASHED:
                sd[f"{prefix}{_SLASHED[key]}"] = _tensor(arr, False)
            elif key == "kernel" and arr.ndim == 3:
                sd[f"{prefix}weight"] = torch.from_numpy(np.array(arr.transpose(2, 1, 0), np.float32, order="C"))
            elif key == "kernel":
                sd[f"{prefix}weight"] = _tensor(arr, True)
            else:
                sd[f"{prefix}{'bias' if key == 'bias' else 'weight'}"] = _tensor(arr, False)

    walk(params, "")
    found = tuple(sum(1 for k in params if k.startswith(f"{stack}_layer_")) for stack in ("enc", "dec"))
    if found != layer_counts:
        raise ValueError(f"the tree holds {found} (encoder, decoder) layers; the config says {layer_counts}")
    return sd


def t5_params_from_jax(params: dict, config) -> dict:
    """The port's T5 state dict (f32 tensors) from a JAX T5 param tree
    (``shared``, ``enc_layer_<i>/{ln_attn,attn,ln_ffn,ffn}``,
    ``dec_layer_<i>/{ln_self,self_attn,ln_cross,cross_attn,ln_ffn,ffn}``,
    the two final norms and, when untied, ``lm_head``)."""
    return _seq2seq_params(params, (config.num_layers, config.num_layers))


def whisper_params_from_jax(params: dict, config) -> dict:
    """The port's Whisper state dict (f32 tensors) from a JAX Whisper param
    tree (``conv1``, ``conv2``, ``enc_layer_<i>/{ln_self,self_attn,ln_ffn,
    fc1,fc2}``, ``embed_tokens``, ``dec_pos/embedding``, ``dec_layer_<i>``
    with ``cross_attn`` and ``ln_cross`` too, the two final norms)."""
    return _seq2seq_params(params, (config.encoder_layers, config.decoder_layers))


def _flax_named_params(params: dict) -> dict:
    """The vision and diffusion families' walk: every leaf by its flax path,
    ``/`` read as ``.``, Dense and Conv kernels transposed, ``scale`` and
    ``embedding`` as ``weight``."""
    sd = {}

    def walk(tree: dict, prefix: str):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key.replace('/', '.')}.")
                continue
            arr = np.asarray(value)
            if key == "kernel" and arr.ndim == 4:
                sd[f"{prefix}weight"] = torch.from_numpy(np.array(arr.transpose(3, 2, 0, 1), np.float32, order="C"))
            elif key == "kernel":
                sd[f"{prefix}weight"] = _tensor(arr, True)
            elif key in ("scale", "embedding"):
                sd[f"{prefix}weight"] = _tensor(arr, False)
            else:  # bias, or a parameter of its own (cls_token, vision/pos_embed/embedding, logit_scale)
                name = key[: -len("/embedding")] if key.endswith("/embedding") else key
                sd[f"{prefix}{name.replace('/', '.')}"] = _tensor(arr, False)

    walk(params, "")
    return sd


def vit_params_from_jax(params: dict) -> dict:
    """The port's ViT state dict (f32 tensors) from a JAX ViT param tree
    (``patch_embed``, ``cls_token``, ``pos_embed``, ``block_<i>/{norm1,
    attention/{query,key,value,out}, norm2, mlp/{up,down}}``,
    ``final_norm``, ``head``)."""
    return _flax_named_params(params)


def clip_params_from_jax(params: dict) -> dict:
    """The port's CLIP state dict (f32 tensors) from a JAX CLIP param tree
    (``vision/...`` and ``text/...`` towers, the two projections,
    ``logit_scale``)."""
    return _flax_named_params(params)


def unet_params_from_jax(params: dict) -> dict:
    """The port's UNet2D state dict (f32 tensors) from a JAX UNet2D param
    tree (``time_mlp_{1,2}``, ``label_embed``, ``conv_in``, ``down_*``,
    ``downsample_*``, ``mid_*``, ``up_*``, ``upsample_*``, ``norm_out/gn``,
    ``conv_out``)."""
    return _flax_named_params(params)


def vae_params_from_jax(params: dict) -> dict:
    """The port's VAE state dict (f32 tensors) from a JAX VAE param tree
    (``encoder/...`` and ``decoder/...``)."""
    return _flax_named_params(params)
