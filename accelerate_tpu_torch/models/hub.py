"""Import HuggingFace safetensors checkpoints into the model zoo.

A checkpoint is read with :mod:`..utils.safetensors_io` (no ``safetensors``
package; F32, F16 and BF16 tensors keep their dtype), its HF parameter
paths are renamed to the flax names of the JAX package's models, torch
``[out, in]`` linear weights are transposed to flax ``[in, out]`` kernels,
and, for a scanned Llama, per-layer weights are stacked along a leading
layer dim: the same tree, leaf for leaf, as the JAX package's importer
builds. The merge then carries each leaf into the port's module (a flax
kernel becomes an ``nn.Linear`` / ``Conv`` weight again, a stacked leaf one
parameter a layer) under the JAX merge's rules: a leaf the model holds
replaces its seeded value, cast to the parameter's dtype; a shape mismatch
raises; a leaf the checkpoint lacks keeps its initialisation; and
``model.imported_weight_count`` counts imported leaves as the flax tree
counts them (a stacked ``[L, ...]`` leaf once).

Entry points: ``load_hf_<family>(checkpoint_path, config=None, *,
device=None, dtype=torch.float32)`` for the 18 families, which build the
model on ``device`` (``cuda`` unless ``"cpu"`` is asked for) in ``dtype``
as its ``create_*_model`` does, or the low-level ``convert_hf_*_state``
on an already-read ``{name: tensor}``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from ..utils.safetensors_io import load_file


def read_safetensors_state(path: str) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` on the CPU from a safetensors file, a directory
    holding a ``*.safetensors.index.json`` (only the shards its
    ``weight_map`` names are read), or a directory of ``*.safetensors``."""
    state: dict[str, torch.Tensor] = {}
    if os.path.isdir(path):
        index = [f for f in os.listdir(path) if f.endswith(".safetensors.index.json")]
        if index:
            with open(os.path.join(path, index[0])) as f:
                weight_map = json.load(f)["weight_map"]
            for shard in sorted(set(weight_map.values())):
                state.update(load_file(os.path.join(path, shard)))
        else:
            for f in sorted(os.listdir(path)):
                if f.endswith(".safetensors"):
                    state.update(load_file(os.path.join(path, f)))
    else:
        state = load_file(path)
    return state


def _strip_prefix(state: dict, prefixes: tuple[str, ...]) -> dict:
    out = {}
    for key, value in state.items():
        for prefix in prefixes:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[key] = value
    return out


def _set(tree: dict, path: str, value: torch.Tensor):
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


# --------------------------------------------------------------------- #
# BERT
# --------------------------------------------------------------------- #

_BERT_FIXED = {
    "embeddings.word_embeddings.weight": ("encoder/embeddings/word_embeddings/embedding", False),
    "embeddings.position_embeddings.weight": ("encoder/embeddings/position_embeddings/embedding", False),
    "embeddings.token_type_embeddings.weight": ("encoder/embeddings/token_type_embeddings/embedding", False),
    "embeddings.LayerNorm.weight": ("encoder/embeddings/norm/scale", False),
    "embeddings.LayerNorm.bias": ("encoder/embeddings/norm/bias", False),
    "pooler.dense.weight": ("pooler/kernel", True),
    "pooler.dense.bias": ("pooler/bias", False),
    "classifier.weight": ("classifier/kernel", True),
    "classifier.bias": ("classifier/bias", False),
}

_BERT_LAYER = {
    "attention.self.query.weight": ("attention/query/kernel", True),
    "attention.self.query.bias": ("attention/query/bias", False),
    "attention.self.key.weight": ("attention/key/kernel", True),
    "attention.self.key.bias": ("attention/key/bias", False),
    "attention.self.value.weight": ("attention/value/kernel", True),
    "attention.self.value.bias": ("attention/value/bias", False),
    "attention.output.dense.weight": ("attention/out/kernel", True),
    "attention.output.dense.bias": ("attention/out/bias", False),
    "attention.output.LayerNorm.weight": ("attention_norm/scale", False),
    "attention.output.LayerNorm.bias": ("attention_norm/bias", False),
    "intermediate.dense.weight": ("ffn/intermediate/kernel", True),
    "intermediate.dense.bias": ("ffn/intermediate/bias", False),
    "output.dense.weight": ("ffn/output/kernel", True),
    "output.dense.bias": ("ffn/output/bias", False),
    "output.LayerNorm.weight": ("ffn_norm/scale", False),
    "output.LayerNorm.bias": ("ffn_norm/bias", False),
}


def convert_hf_bert_state(state: dict[str, torch.Tensor]) -> dict:
    """HF ``bert-*`` (BertForSequenceClassification) -> the flax param tree."""
    state = _strip_prefix(state, ("bert.",))
    tree: dict = {}
    for hf_key, (ours, transpose) in _BERT_FIXED.items():
        if hf_key in state:
            value = state[hf_key]
            _set(tree, ours, value.T if transpose else value)
    layer_re = re.compile(r"encoder\.layer\.(\d+)\.(.+)")
    for key, value in state.items():
        m = layer_re.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        if rest in _BERT_LAYER:
            ours, transpose = _BERT_LAYER[rest]
            _set(tree, f"encoder/layer_{idx}/{ours}", value.T if transpose else value)
    return tree


def load_hf_bert(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """Build a BERT model and load HF weights into it."""
    from .bert import BertConfig, create_bert_model

    state = read_safetensors_state(checkpoint_path)
    tree = convert_hf_bert_state(state)
    model = create_bert_model(config or BertConfig.base(), device=device, dtype=dtype)
    return _merge_into(model, tree)


# --------------------------------------------------------------------- #
# Llama
# --------------------------------------------------------------------- #

_LLAMA_FIXED = {
    "model.embed_tokens.weight": ("embed_tokens/embedding", False),
    "model.norm.weight": ("final_norm/scale", False),
    "lm_head.weight": ("lm_head/kernel", True),
}

_LLAMA_LAYER = {
    "self_attn.q_proj.weight": ("attn/q_proj/kernel", True),
    "self_attn.k_proj.weight": ("attn/k_proj/kernel", True),
    "self_attn.v_proj.weight": ("attn/v_proj/kernel", True),
    # qkv biases (Qwen2); absent in llama/mistral checkpoints
    "self_attn.q_proj.bias": ("attn/q_proj/bias", False),
    "self_attn.k_proj.bias": ("attn/k_proj/bias", False),
    "self_attn.v_proj.bias": ("attn/v_proj/bias", False),
    "self_attn.o_proj.weight": ("attn/o_proj/kernel", True),
    "mlp.gate_proj.weight": ("mlp/gate_proj/kernel", True),
    "mlp.up_proj.weight": ("mlp/up_proj/kernel", True),
    "mlp.down_proj.weight": ("mlp/down_proj/kernel", True),
    "input_layernorm.weight": ("input_norm/scale", False),
    "post_attention_layernorm.weight": ("post_attn_norm/scale", False),
    # OLMo2 post-norm / Gemma2 sandwich layouts
    "post_feedforward_layernorm.weight": ("post_ffn_norm/scale", False),
    "pre_feedforward_layernorm.weight": ("pre_ffn_norm/scale", False),
    # q/k RMSNorm scales: Qwen3 [head_dim] (per-head), OLMo2 [H*head_dim]
    # (flat) — the loader's flat_qk_norm flag picks the re-pair grouping
    "self_attn.q_norm.weight": ("attn/q_norm/scale", False),
    "self_attn.k_norm.weight": ("attn/k_norm/scale", False),
}


def _rope_interleave_permute(kernel: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Re-pair a q/k projection kernel from HF's half-split (``rotate_half``)
    rope convention to this zoo's interleaved one.

    HF rotates dim pairs ``(j, j + D/2)``; :func:`.llama.rope` rotates
    ``(2j, 2j + 1)``. Importing HF weights without re-pairing silently
    rotates the wrong coordinate pairs and the attention logits drift.
    ``kernel`` is flax-layout ``[in, heads * head_dim]``."""
    if head_dim % 2 != 0:
        raise ValueError(
            f"rope re-pairing requires an even head_dim, got {head_dim} "
            f"(hidden_size / num_attention_heads in the HF config)"
        )
    in_dim, out_dim = kernel.shape
    heads = out_dim // head_dim
    k = kernel.reshape(in_dim, heads, head_dim)
    half = head_dim // 2
    perm = torch.empty(head_dim, dtype=torch.int64)
    perm[0::2] = torch.arange(half)  # new 2j   <- old j        (first half)
    perm[1::2] = torch.arange(half) + half  # new 2j+1 <- old j + D/2  (second half)
    return k[:, :, perm].reshape(in_dim, out_dim)


def convert_hf_llama_state(
    state: dict[str, torch.Tensor],
    scan_layers: bool,
    num_heads: int,
    num_kv_heads: int,
    require: tuple = (),
    norm_after: bool = False,
    flat_qk_norm: bool = False,
) -> dict:
    """HF ``*ForCausalLM`` Llama -> the flax param tree. With ``scan_layers``
    the per-layer weights are stacked along a leading layer dim
    (``layers/block/...``). q/k kernels, biases and norm scales are
    re-paired for the interleaved rope (:func:`_rope_interleave_permute`).
    ``require`` adds family-optional names (``attn/q_norm/scale`` etc.) to
    the every-layer completeness check, so a checkpoint missing what the
    config demands fails loudly instead of keeping random init."""
    tree: dict = {}
    for hf_key, (ours, transpose) in _LLAMA_FIXED.items():
        if hf_key in state:
            value = state[hf_key]
            _set(tree, ours, value.T if transpose else value)
    # lm_head may be tied to embeddings in some checkpoints
    if "lm_head" not in tree and "model.embed_tokens.weight" in state:
        _set(tree, "lm_head/kernel", state["model.embed_tokens.weight"].T)

    layer_re = re.compile(r"model\.layers\.(\d+)\.(.+)")
    per_layer: dict[int, dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        m = layer_re.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        if rest in _LLAMA_LAYER:
            ours, transpose = _LLAMA_LAYER[rest]
            converted = value.T if transpose else value
            if rest == "self_attn.q_proj.weight":
                converted = _rope_interleave_permute(converted, converted.shape[1] // num_heads)
            elif rest == "self_attn.k_proj.weight":
                converted = _rope_interleave_permute(converted, converted.shape[1] // num_kv_heads)
            elif rest == "self_attn.q_proj.bias":
                # biases rotate with their output channels: same re-pairing
                converted = _rope_interleave_permute(converted[None], len(converted) // num_heads)[0]
            elif rest == "self_attn.k_proj.bias":
                converted = _rope_interleave_permute(converted[None], len(converted) // num_kv_heads)[0]
            elif rest == "self_attn.q_norm.weight":
                # the scale multiplies per channel after the (re-paired)
                # projection: Qwen3's [head_dim] re-pairs as one head, OLMo2's
                # flat [H*head_dim] per head_dim group like a bias
                d = len(converted) // num_heads if flat_qk_norm else len(converted)
                converted = _rope_interleave_permute(converted[None], d)[0]
            elif rest == "self_attn.k_norm.weight":
                d = len(converted) // num_kv_heads if flat_qk_norm else len(converted)
                converted = _rope_interleave_permute(converted[None], d)[0]
            per_layer.setdefault(idx, {})[ours] = converted
    if not per_layer:
        return tree
    n_layers = max(per_layer) + 1
    # fail loudly on partial checkpoints (one shard of a sharded save): the
    # core weight families must be in every layer. Biases (Qwen2) and q/k
    # norm scales (Qwen3/OLMo2) are family-optional; the layer norms swap
    # with the convention (pre-norm: input + post_attn, OLMo2 post-norm:
    # post_attn + post_ffn, no input norms)
    required = {
        ours
        for ours, _ in _LLAMA_LAYER.values()
        if not ours.endswith(("/bias", "q_norm/scale", "k_norm/scale"))
        and ours not in ("input_norm/scale", "post_ffn_norm/scale", "pre_ffn_norm/scale")
    } | set(require)
    required |= {"post_ffn_norm/scale"} if norm_after else {"input_norm/scale"}
    for i in range(n_layers):
        missing = required - set(per_layer.get(i, {}))
        if missing:
            raise ValueError(
                f"layer {i} is missing {sorted(missing)} — partial checkpoint? "
                "pass the checkpoint directory (or its index), not a single shard"
            )
    # family-optional params must still be all-or-none across layers:
    # stacking from layer 0's names would drop one present only later
    union = set().union(*(per_layer[i].keys() for i in range(n_layers)))
    for name in union:
        holes = [i for i in range(n_layers) if name not in per_layer[i]]
        if holes:
            raise ValueError(
                f"param {name!r} present in some layers but missing from layers "
                f"{holes} — partial checkpoint? pass the full directory/index"
            )
    if scan_layers:
        for name in sorted(union):
            _set(tree, f"layers/block/{name}", _stack([per_layer[i][name] for i in range(n_layers)]))
    else:
        for i in range(n_layers):
            for name, value in per_layer[i].items():
                _set(tree, f"layer_{i}/{name}", value)
    return tree


def _stack(tensors: list) -> torch.Tensor:
    """``torch.stack`` in the tensors' own memory order: a kernel that is an
    HF ``[out, in]`` tensor seen transposed stacks by a plain copy, and the
    stacked kernel is a transposed view of it (the same values and shape)."""
    if tensors[0].dim() == 2 and tensors[0].mT.is_contiguous():
        return torch.stack([t.mT for t in tensors]).mT
    return torch.stack(tensors)


def _load_llama_family(state, config, create, device, dtype, **convert_kw):
    """The Llama families' loader: convert ``state`` with ``config``'s layout
    and heads, build with ``create``, merge."""
    tree = convert_hf_llama_state(
        state,
        scan_layers=config.scan_layers,
        num_heads=config.num_attention_heads,
        num_kv_heads=config.num_key_value_heads,
        **convert_kw,
    )
    return _merge_into(create(config, device=device, dtype=dtype), tree)


def load_hf_llama(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .llama import LlamaConfig, create_llama_model

    state = read_safetensors_state(checkpoint_path)
    return _load_llama_family(state, config or LlamaConfig.llama2_7b(), create_llama_model, device, dtype)


def split_phi3_fused_state(state: dict[str, torch.Tensor], num_heads: int, num_kv_heads: int) -> dict:
    """Rewrite Phi-3's fused tensors into the llama state-dict layout:
    ``qkv_proj`` -> q/k/v (row-split in torch [out, in] orientation, so the
    head width divides the fused out dim) and ``gate_up_proj`` -> gate/up
    (first half gate: HF's chunk(2) order). The result feeds
    :func:`convert_hf_llama_state` unchanged, rope re-pairing included."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith("self_attn.qkv_proj.weight"):
            prefix = key[: -len("qkv_proj.weight")]
            hd = value.shape[0] // (num_heads + 2 * num_kv_heads)
            q, k, v = torch.split(value, [num_heads * hd, num_kv_heads * hd,
                                          value.shape[0] - (num_heads + num_kv_heads) * hd])
            out[prefix + "q_proj.weight"] = q
            out[prefix + "k_proj.weight"] = k
            out[prefix + "v_proj.weight"] = v
        elif key.endswith("mlp.gate_up_proj.weight"):
            prefix = key[: -len("gate_up_proj.weight")]
            gate, up = torch.chunk(value, 2)
            out[prefix + "gate_proj.weight"] = gate
            out[prefix + "up_proj.weight"] = up
        else:
            out[key] = value
    return out


def load_hf_phi3(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Phi-3 checkpoints are llama-layout after splitting the fused
    qkv_proj / gate_up_proj tensors (the module keeps separate projections)."""
    from .phi3 import Phi3Config, create_phi3_model

    state = read_safetensors_state(checkpoint_path)
    config = config or Phi3Config.phi3_mini_4k()
    state = split_phi3_fused_state(state, config.num_attention_heads, config.num_key_value_heads)
    return _load_llama_family(state, config, create_phi3_model, device, dtype)


def load_hf_gemma(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Gemma checkpoints are llama-layout (the rope re-pairing derives
    head width from the projection shapes, covering the explicit head_dim);
    the LM head is always tied (importer fallback) and the (1+scale) norm
    offsets import verbatim."""
    from .gemma import GemmaConfig, create_gemma_model

    state = read_safetensors_state(checkpoint_path)
    return _load_llama_family(state, config or GemmaConfig.gemma_2b(), create_gemma_model, device, dtype)


def load_hf_gemma2(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Gemma2 checkpoints are llama-layout plus the sandwich-norm keys
    (pre/post feedforward layernorms); head always tied, (1+scale) norm
    offsets import verbatim."""
    from .gemma2 import Gemma2Config, create_gemma2_model

    config = config or Gemma2Config.gemma2_9b()
    require = ("pre_ffn_norm/scale", "post_ffn_norm/scale") if config.sandwich_norm else ()
    return _load_llama_family(read_safetensors_state(checkpoint_path), config, create_gemma2_model, device, dtype,
                              require=require)


def load_hf_gemma3(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Gemma3 text checkpoints: llama layout + sandwich-norm keys +
    per-head q/k norm scales ([head_dim], re-paired like Qwen3's)."""
    from .gemma3 import Gemma3Config, create_gemma3_model

    config = config or Gemma3Config.gemma3_1b()
    require = ()
    if config.sandwich_norm:
        require += ("pre_ffn_norm/scale", "post_ffn_norm/scale")
    if config.qk_norm:
        require += ("attn/q_norm/scale", "attn/k_norm/scale")
    return _load_llama_family(read_safetensors_state(checkpoint_path), config, create_gemma3_model, device, dtype,
                              require=require)


def load_hf_qwen2(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Qwen2/Qwen2.5 checkpoints are llama-layout plus q/k/v bias vectors
    (re-paired for the rope convention like their kernels); small variants
    tie lm_head to the embeddings (importer fallback)."""
    from .qwen2 import Qwen2Config, create_qwen2_model

    config = config or Qwen2Config.qwen2_7b()
    require = ("attn/q_proj/bias", "attn/k_proj/bias", "attn/v_proj/bias") if config.qkv_bias else ()
    return _load_llama_family(read_safetensors_state(checkpoint_path), config, create_qwen2_model, device, dtype,
                              require=require)


def load_hf_qwen3(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Qwen3 checkpoints are llama-layout with per-head q/k norm scales
    (re-paired for the interleaved rope) and no qkv biases; small variants
    tie lm_head to the embeddings (importer fallback)."""
    from .qwen3 import Qwen3Config, create_qwen3_model

    config = config or Qwen3Config.qwen3_8b()
    require = ("attn/q_norm/scale", "attn/k_norm/scale") if config.qk_norm else ()
    return _load_llama_family(read_safetensors_state(checkpoint_path), config, create_qwen3_model, device, dtype,
                              require=require)


def load_hf_olmo2(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF OLMo2 checkpoints are llama-layout with post-norm keys
    (post_attention/post_feedforward, no input norms) and flat q/k norm
    scales re-paired per head_dim group for the interleaved rope."""
    from .olmo2 import Olmo2Config, create_olmo2_model

    config = config or Olmo2Config.olmo2_7b()
    return _load_llama_family(
        read_safetensors_state(checkpoint_path), config, create_olmo2_model, device, dtype,
        require=("attn/q_norm/scale", "attn/k_norm/scale") if config.qk_norm_flat else (),
        norm_after=config.norm_after,
        flat_qk_norm=config.qk_norm_flat,
    )


def load_hf_mistral(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Mistral checkpoints use the llama state-dict layout verbatim; only
    the config differs (the band in ``MistralConfig.sliding_window``). The
    default config is Mistral-7B-v0.1; pass ``MistralConfig.mistral_7b_v3()``
    for v0.2/v0.3 weights (another theta, no window)."""
    from .mistral import MistralConfig, create_mistral_model

    state = read_safetensors_state(checkpoint_path)
    return _load_llama_family(state, config or MistralConfig.mistral_7b_v1(), create_mistral_model, device, dtype)


# --------------------------------------------------------------------- #
# GPT-2
# --------------------------------------------------------------------- #

_GPT2_LAYER = {
    "ln_1.weight": "ln_1/scale",
    "ln_1.bias": "ln_1/bias",
    "ln_2.weight": "ln_2/scale",
    "ln_2.bias": "ln_2/bias",
    "attn.c_proj.weight": "attn/o_proj/kernel",
    "attn.c_proj.bias": "attn/o_proj/bias",
    "mlp.c_fc.weight": "mlp/fc_in/kernel",
    "mlp.c_fc.bias": "mlp/fc_in/bias",
    "mlp.c_proj.weight": "mlp/fc_out/kernel",
    "mlp.c_proj.bias": "mlp/fc_out/bias",
}


def convert_hf_gpt2_state(state: dict[str, torch.Tensor]) -> dict:
    """HF ``gpt2`` -> the flax param tree. HF GPT-2's Conv1D weights are
    already ``[in, out]`` (no transpose), and its fused ``c_attn`` splits
    into q/k/v thirds."""
    state = _strip_prefix(state, ("transformer.",))
    tree: dict = {}
    if "wte.weight" in state:
        _set(tree, "wte/embedding", state["wte.weight"])
    if "wpe.weight" in state:
        _set(tree, "wpe/embedding", state["wpe.weight"])
    if "ln_f.weight" in state:
        _set(tree, "ln_f/scale", state["ln_f.weight"])
        _set(tree, "ln_f/bias", state["ln_f.bias"])
    # HF gpt2 ties the head to wte and ships no lm_head tensor: the tied
    # fallback for untied configs
    if "wte.weight" in state:
        _set(tree, "lm_head/kernel", state["wte.weight"].T)
    layer_re = re.compile(r"h\.(\d+)\.(.+)")
    for key, value in state.items():
        m = layer_re.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        if rest in _GPT2_LAYER:
            _set(tree, f"layer_{idx}/{_GPT2_LAYER[rest]}", value)
        elif rest == "attn.c_attn.weight":
            d = value.shape[0]
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                _set(tree, f"layer_{idx}/attn/{name}/kernel", value[:, j * d:(j + 1) * d])
        elif rest == "attn.c_attn.bias":
            d = value.shape[0] // 3
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                _set(tree, f"layer_{idx}/attn/{name}/bias", value[j * d:(j + 1) * d])
    return tree


def load_hf_gpt2(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .gpt2 import GPT2Config, create_gpt2_model

    state = read_safetensors_state(checkpoint_path)
    tree = convert_hf_gpt2_state(state)
    return _merge_into(create_gpt2_model(config or GPT2Config.small(), device=device, dtype=dtype), tree)


# --------------------------------------------------------------------- #
# T5
# --------------------------------------------------------------------- #

_T5_SELF = {
    "q.weight": ("q_proj/kernel", True),
    "k.weight": ("k_proj/kernel", True),
    "v.weight": ("v_proj/kernel", True),
    "o.weight": ("o_proj/kernel", True),
    "relative_attention_bias.weight": ("relative_bias/embedding", False),
}

_T5_FFN = {
    "DenseReluDense.wi.weight": ("ffn/wi/kernel", True),
    "DenseReluDense.wo.weight": ("ffn/wo/kernel", True),
}


def convert_hf_t5_state(state: dict[str, torch.Tensor]) -> dict:
    """HF ``t5-*`` -> the flax param tree (encoder.block.N.layer.{0,1} /
    decoder.block.N.layer.{0,1,2} flattened to the zoo's names)."""
    tree: dict = {}
    if "shared.weight" in state:
        _set(tree, "shared/embedding", state["shared.weight"])
    if "lm_head.weight" in state:
        _set(tree, "lm_head/kernel", state["lm_head.weight"].T)
    if "encoder.final_layer_norm.weight" in state:
        _set(tree, "enc_final_norm/scale", state["encoder.final_layer_norm.weight"])
    if "decoder.final_layer_norm.weight" in state:
        _set(tree, "dec_final_norm/scale", state["decoder.final_layer_norm.weight"])

    pat = re.compile(r"(encoder|decoder)\.block\.(\d+)\.layer\.(\d+)\.(.+)")
    for key, value in state.items():
        m = pat.match(key)
        if not m:
            continue
        stack, idx, sub, rest = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
        enc = stack == "encoder"
        prefix = f"{'enc' if enc else 'dec'}_layer_{idx}"
        if enc:
            # layer.0 = self-attn, layer.1 = ffn
            attn_name, norms = "attn", {0: "ln_attn", 1: "ln_ffn"}
        else:
            # layer.0 = self-attn, layer.1 = cross-attn, layer.2 = ffn
            attn_name = "self_attn" if sub == 0 else "cross_attn"
            norms = {0: "ln_self", 1: "ln_cross", 2: "ln_ffn"}
        if rest == "layer_norm.weight":
            _set(tree, f"{prefix}/{norms[sub]}/scale", value)
            continue
        for hf_prefix in ("SelfAttention.", "EncDecAttention."):
            if rest.startswith(hf_prefix):
                name, transpose = _T5_SELF[rest[len(hf_prefix):]]
                _set(tree, f"{prefix}/{attn_name}/{name}", value.T if transpose else value)
                break
        else:
            if rest in _T5_FFN:
                name, transpose = _T5_FFN[rest]
                _set(tree, f"{prefix}/{name}", value.T if transpose else value)
    return tree


def load_hf_t5(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .t5 import T5Config, create_t5_model

    state = read_safetensors_state(checkpoint_path)
    tree = convert_hf_t5_state(state)
    return _merge_into(create_t5_model(config or T5Config.small(), device=device, dtype=dtype), tree)


# --------------------------------------------------------------------- #
# ViT
# --------------------------------------------------------------------- #

_VIT_BLOCK = {
    "attention.attention.query.weight": ("attention/query/kernel", True),
    "attention.attention.query.bias": ("attention/query/bias", False),
    "attention.attention.key.weight": ("attention/key/kernel", True),
    "attention.attention.key.bias": ("attention/key/bias", False),
    "attention.attention.value.weight": ("attention/value/kernel", True),
    "attention.attention.value.bias": ("attention/value/bias", False),
    "attention.output.dense.weight": ("attention/out/kernel", True),
    "attention.output.dense.bias": ("attention/out/bias", False),
    "intermediate.dense.weight": ("mlp/up/kernel", True),
    "intermediate.dense.bias": ("mlp/up/bias", False),
    "output.dense.weight": ("mlp/down/kernel", True),
    "output.dense.bias": ("mlp/down/bias", False),
    "layernorm_before.weight": ("norm1/scale", False),
    "layernorm_before.bias": ("norm1/bias", False),
    "layernorm_after.weight": ("norm2/scale", False),
    "layernorm_after.bias": ("norm2/bias", False),
}


def convert_hf_vit_state(state: dict[str, torch.Tensor]) -> dict:
    """HF ``ViTForImageClassification`` -> the flax param tree. The patch
    conv transposes torch OIHW -> flax HWIO."""
    state = _strip_prefix(state, ("vit.",))
    tree: dict = {}
    if "embeddings.cls_token" in state:
        _set(tree, "cls_token", state["embeddings.cls_token"])
    if "embeddings.position_embeddings" in state:
        _set(tree, "pos_embed", state["embeddings.position_embeddings"])
    if "embeddings.patch_embeddings.projection.weight" in state:
        w = state["embeddings.patch_embeddings.projection.weight"]  # [d, 3, p, p]
        _set(tree, "patch_embed/kernel", w.permute(2, 3, 1, 0))
    if "embeddings.patch_embeddings.projection.bias" in state:
        _set(tree, "patch_embed/bias", state["embeddings.patch_embeddings.projection.bias"])
    if "layernorm.weight" in state:
        _set(tree, "final_norm/scale", state["layernorm.weight"])
    if "layernorm.bias" in state:
        _set(tree, "final_norm/bias", state["layernorm.bias"])
    if "classifier.weight" in state:
        _set(tree, "head/kernel", state["classifier.weight"].T)
    if "classifier.bias" in state:
        _set(tree, "head/bias", state["classifier.bias"])

    layer_re = re.compile(r"encoder\.layer\.(\d+)\.(.+)")
    for key, value in state.items():
        m = layer_re.match(key)
        if m and m.group(2) in _VIT_BLOCK:
            name, transpose = _VIT_BLOCK[m.group(2)]
            _set(tree, f"block_{int(m.group(1))}/{name}", value.T if transpose else value)
    return tree


def load_hf_vit(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .vit import ViTConfig, create_vit_model

    state = read_safetensors_state(checkpoint_path)
    tree = convert_hf_vit_state(state)
    return _merge_into(create_vit_model(config or ViTConfig.base(), device=device, dtype=dtype), tree)


# --------------------------------------------------------------------- #
# Mixtral
# --------------------------------------------------------------------- #

_MIXTRAL_ATTN = {
    "self_attn.q_proj.weight": "attn/q_proj/kernel",
    "self_attn.k_proj.weight": "attn/k_proj/kernel",
    "self_attn.v_proj.weight": "attn/v_proj/kernel",
    "self_attn.o_proj.weight": "attn/o_proj/kernel",
}


_MIXTRAL_EXPERT_NAMES = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}


def convert_hf_mixtral_state(
    state: dict[str, torch.Tensor],
    num_heads: int,
    num_kv_heads: int,
    *,
    router_key: str = "block_sparse_moe.gate.weight",
    expert_re: str = r"block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight",
    expert_names: Optional[dict] = None,
    qk_norm: bool = False,
) -> dict:
    """HF MoE ``*ForCausalLM`` -> the flax param tree: llama-style attention
    (q/k re-paired for the interleaved rope), per-expert kernels stacked
    into ``experts/{gate,up,down}_proj`` with a leading expert dim, the
    router transposed to ``router/kernel``. One skeleton serves Mixtral
    (the defaults) and Qwen3-MoE (``mlp.gate`` router, ``gate/up/down_proj``
    expert keys, ``qk_norm=True`` for the re-paired per-head norm scales).
    Every layer must carry the full attention/norm/router/expert family:
    a partial checkpoint fails loudly instead of keeping random init."""
    expert_names = expert_names if expert_names is not None else _MIXTRAL_EXPERT_NAMES
    tree: dict = {}
    if "model.embed_tokens.weight" in state:
        _set(tree, "embed_tokens/embedding", state["model.embed_tokens.weight"])
    if "model.norm.weight" in state:
        _set(tree, "final_norm/scale", state["model.norm.weight"])
    if "lm_head.weight" in state:
        _set(tree, "lm_head/kernel", state["lm_head.weight"].T)
    elif "model.embed_tokens.weight" in state:
        _set(tree, "lm_head/kernel", state["model.embed_tokens.weight"].T)

    layer_re = re.compile(r"model\.layers\.(\d+)\.(.+)")
    expert_pat = re.compile(expert_re)
    experts: dict[tuple, dict[int, torch.Tensor]] = {}
    seen: dict[int, set] = {}
    for key, value in state.items():
        m = layer_re.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        prefix = f"layer_{idx}"
        got = seen.setdefault(idx, set())
        if rest in _MIXTRAL_ATTN:
            kernel = value.T
            if rest == "self_attn.q_proj.weight":
                kernel = _rope_interleave_permute(kernel, kernel.shape[1] // num_heads)
            elif rest == "self_attn.k_proj.weight":
                kernel = _rope_interleave_permute(kernel, kernel.shape[1] // num_kv_heads)
            _set(tree, f"{prefix}/{_MIXTRAL_ATTN[rest]}", kernel)
            got.add(_MIXTRAL_ATTN[rest])
        elif qk_norm and rest in ("self_attn.q_norm.weight", "self_attn.k_norm.weight"):
            # [head_dim] per-head scales re-pair as one head (see qwen3.py)
            which = "q_norm" if "q_norm" in rest else "k_norm"
            _set(tree, f"{prefix}/attn/{which}/scale", _rope_interleave_permute(value[None], len(value))[0])
            got.add(f"attn/{which}/scale")
        elif rest == "input_layernorm.weight":
            _set(tree, f"{prefix}/input_norm/scale", value)
            got.add("input_norm/scale")
        elif rest == "post_attention_layernorm.weight":
            _set(tree, f"{prefix}/post_attn_norm/scale", value)
            got.add("post_attn_norm/scale")
        elif rest == router_key:
            _set(tree, f"{prefix}/moe/router/kernel", value.T)
            got.add("moe/router/kernel")
        else:
            em = expert_pat.fullmatch(rest)
            if em:
                # mixtral: w1 = gate (silu branch), w3 = up, w2 = down;
                # qwen3-moe names map through identically. torch [out, in]
                name = expert_names.get(em.group(2), em.group(2))
                experts.setdefault((idx, name), {})[int(em.group(1))] = value.T
    if not seen:
        return tree
    n_layers = max(seen) + 1
    required = set(_MIXTRAL_ATTN.values()) | {
        "input_norm/scale", "post_attn_norm/scale", "moe/router/kernel",
    }
    if qk_norm:
        required |= {"attn/q_norm/scale", "attn/k_norm/scale"}
    for i in range(n_layers):
        missing = required - seen.get(i, set())
        missing |= {
            f"moe/experts/{name}"
            for name in ("gate_proj", "up_proj", "down_proj")
            if (i, name) not in experts
        }
        if missing:
            raise ValueError(
                f"layer {i} is missing {sorted(missing)} — partial checkpoint? "
                "pass the checkpoint directory (or its index), not a single shard"
            )
    for (idx, name), per_expert in experts.items():
        n_exp = max(per_expert) + 1
        holes = [e for e in range(n_exp) if e not in per_expert]
        if holes:
            raise ValueError(f"layer {idx} {name}: experts {holes} missing — partial checkpoint?")
        _set(tree, f"layer_{idx}/moe/experts/{name}", _stack([per_expert[i] for i in range(n_exp)]))
    return tree


def load_hf_mixtral(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .mixtral import MixtralConfig, create_mixtral_model

    state = read_safetensors_state(checkpoint_path)
    config = config or MixtralConfig()
    tree = convert_hf_mixtral_state(
        state, num_heads=config.num_attention_heads, num_kv_heads=config.num_key_value_heads
    )
    return _merge_into(create_mixtral_model(config, device=device, dtype=dtype), tree)


def convert_hf_qwen3_moe_state(state: dict[str, torch.Tensor], num_heads: int, num_kv_heads: int) -> dict:
    """HF ``Qwen3MoeForCausalLM`` -> the flax param tree: the mixtral
    skeleton with Qwen3's key names (``mlp.gate`` router,
    ``gate/up/down_proj`` expert kernels) and the per-head q/k norm scales
    re-paired for the interleaved rope."""
    return convert_hf_mixtral_state(
        state,
        num_heads,
        num_kv_heads,
        router_key="mlp.gate.weight",
        expert_re=r"mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight",
        expert_names={},
        qk_norm=True,
    )


def load_hf_qwen3_moe(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    """HF Qwen3-MoE checkpoints through the mixtral-core model."""
    from .qwen3_moe import Qwen3MoeConfig, create_qwen3_moe_model

    state = read_safetensors_state(checkpoint_path)
    config = config or Qwen3MoeConfig.qwen3_30b_a3b()
    tree = convert_hf_qwen3_moe_state(
        state, num_heads=config.num_attention_heads, num_kv_heads=config.num_key_value_heads
    )
    return _merge_into(create_qwen3_moe_model(config, device=device, dtype=dtype), tree)


# --------------------------------------------------------------------- #
# GPT-NeoX
# --------------------------------------------------------------------- #

_NEOX_LAYER = {
    "input_layernorm.weight": ("input_norm/scale", False),
    "input_layernorm.bias": ("input_norm/bias", False),
    "post_attention_layernorm.weight": ("post_attn_norm/scale", False),
    "post_attention_layernorm.bias": ("post_attn_norm/bias", False),
    "attention.dense.weight": ("attn/o_proj/kernel", True),
    "attention.dense.bias": ("attn/o_proj/bias", False),
    "mlp.dense_h_to_4h.weight": ("mlp/fc_in/kernel", True),
    "mlp.dense_h_to_4h.bias": ("mlp/fc_in/bias", False),
    "mlp.dense_4h_to_h.weight": ("mlp/fc_out/kernel", True),
    "mlp.dense_4h_to_h.bias": ("mlp/fc_out/bias", False),
}


def _partial_rope_interleave_permute(kernel: torch.Tensor, head_dim: int, rotary_dims: int) -> torch.Tensor:
    """:func:`_rope_interleave_permute` restricted to the first
    ``rotary_dims`` of each head (GPT-NeoX ``rotary_pct``); the unrotated
    tail keeps its order."""
    if rotary_dims >= head_dim:
        return _rope_interleave_permute(kernel, head_dim)
    if rotary_dims % 2 != 0:
        raise ValueError(
            f"rope re-pairing requires an even rotary prefix, got rotary_dims={rotary_dims} "
            f"(int(head_dim * rotary_pct) in the HF GPT-NeoX config)"
        )
    in_dim, out_dim = kernel.shape
    heads = out_dim // head_dim
    k = kernel.reshape(in_dim, heads, head_dim)
    half = rotary_dims // 2
    perm = torch.arange(head_dim)
    perm[0:rotary_dims:2] = torch.arange(half)
    perm[1:rotary_dims:2] = torch.arange(half) + half
    return k[:, :, perm].reshape(in_dim, out_dim)


def convert_hf_gptneox_state(state: dict[str, torch.Tensor], num_heads: int, rotary_pct: float) -> dict:
    """HF ``GPTNeoXForCausalLM`` -> the flax param tree. The fused
    ``attention.query_key_value`` [3*hidden, hidden] is head-major
    ([heads, 3, head_dim] on the out dim) and splits into q/k/v; q/k are
    re-paired for the interleaved rope on the rotary prefix."""
    state = _strip_prefix(state, ("gpt_neox.",))
    tree: dict = {}
    if "embed_in.weight" in state:
        _set(tree, "embed_in/embedding", state["embed_in.weight"])
    if "embed_out.weight" in state:
        _set(tree, "embed_out/kernel", state["embed_out.weight"].T)
    if "final_layer_norm.weight" in state:
        _set(tree, "final_norm/scale", state["final_layer_norm.weight"])
    if "final_layer_norm.bias" in state:
        _set(tree, "final_norm/bias", state["final_layer_norm.bias"])

    layer_re = re.compile(r"layers\.(\d+)\.(.+)")
    for key, value in state.items():
        m = layer_re.match(key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        prefix = f"layer_{idx}"
        if rest in _NEOX_LAYER:
            name, transpose = _NEOX_LAYER[rest]
            _set(tree, f"{prefix}/{name}", value.T if transpose else value)
        elif rest == "attention.query_key_value.weight":
            hidden = value.shape[1]
            head_dim = hidden // num_heads
            rotary_dims = int(head_dim * rotary_pct)
            # [3H, hidden] out-dim layout is [heads, 3, head_dim]
            w = value.reshape(num_heads, 3, head_dim, hidden)
            for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                kernel = w[:, j].reshape(hidden, hidden).T  # -> [in, out]
                if proj in ("q_proj", "k_proj"):
                    kernel = _partial_rope_interleave_permute(kernel, head_dim, rotary_dims)
                _set(tree, f"{prefix}/attn/{proj}/kernel", kernel)
        elif rest == "attention.query_key_value.bias":
            hidden = value.shape[0] // 3
            head_dim = hidden // num_heads
            rotary_dims = int(head_dim * rotary_pct)
            b = value.reshape(num_heads, 3, head_dim)
            for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                bias = b[:, j].reshape(hidden)
                if proj in ("q_proj", "k_proj"):
                    bias = _partial_rope_interleave_permute(bias[None], head_dim, rotary_dims)[0]
                _set(tree, f"{prefix}/attn/{proj}/bias", bias)
    return tree


def load_hf_gptneox(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .gptneox import GPTNeoXConfig, create_gptneox_model

    state = read_safetensors_state(checkpoint_path)
    config = config or GPTNeoXConfig.neox_20b()
    tree = convert_hf_gptneox_state(state, num_heads=config.num_attention_heads, rotary_pct=config.rotary_pct)
    return _merge_into(create_gptneox_model(config, device=device, dtype=dtype), tree)


# --------------------------------------------------------------------- #
# The merge
# --------------------------------------------------------------------- #

# a flax kernel's axes in the port's weight ([in, out] Dense, [k, in, out]
# Conv1d, HWIO Conv2d), and back
_TO_PORT = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}
_SCANNED = "layers/block/"


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _port_param(key: str, params: dict, prefix: str = ""):
    """The port's parameter holding flax leaf ``key`` (a path under one
    layer when ``prefix`` names it), and whether it is a kernel, or None.
    The stacks' ``layer_<i>`` / ``enc_layer_<i>`` / ``dec_layer_<i>`` are
    the port's ``layers.<i>`` / ``enc_layers.<i>`` / ``dec_layers.<i>``; a
    ``kernel`` or ``scale`` is a module's ``weight``; an ``embedding`` is an
    ``nn.Embedding``'s ``weight`` or a parameter of that name
    (``relative_bias``, ``dec_pos``, CLIP's ``pos_embed``)."""
    parts = [re.sub(r"^(enc_|dec_)?layer_(\d+)$", r"\1layers.\2", p) for p in key.split("/")]
    base, leaf = prefix + ".".join(parts[:-1]), parts[-1]
    if leaf in ("kernel", "scale"):
        names = (f"{base}.weight",)
    elif leaf == "embedding":
        names = (f"{base}.weight", base)
    else:
        names = (f"{base}.{leaf}" if base else leaf,)
    for name in names:
        if name in params:
            return params[name], leaf == "kernel"
    return None


def _merge_into(model, tree: dict):
    """Copy the imported flax leaves into ``model``'s parameters (each cast
    to its parameter's dtype and device; shapes checked in the flax layout);
    a leaf the model does not hold is skipped, a parameter the tree lacks
    keeps its initialisation. The Llama module holds the scanned layout's
    leaves (``layers/block/...``, one parameter a layer) when its config
    scans, the unrolled ones (``layer_<i>/...``) otherwise, as the JAX
    model's tree does."""
    params = dict(model.module.named_parameters())
    llama = model.name == "llama"
    copies = []
    imported = 0
    for key, new in _flatten(tree).items():
        if llama and (re.match(r"layer_\d+/", key) if model.config.scan_layers else key.startswith(_SCANNED)):
            continue  # the other layout's leaf: the JAX model's tree has no such path
        if key.startswith(_SCANNED):
            targets = []
            while (found := _port_param(key[len(_SCANNED):], params, f"layers.{len(targets)}.")) is not None:
                targets.append(found)
            if not targets:
                continue
            lead = (len(targets),)
        else:
            found = _port_param(key, params)
            if found is None:
                continue
            targets, lead = [found], ()
        p, is_kernel = targets[0]
        axes = _TO_FLAX[p.dim()] if is_kernel else None
        old = lead + (tuple(p.shape[a] for a in axes) if axes else tuple(p.shape))
        if tuple(new.shape) != old:
            raise ValueError(f"shape mismatch importing {key}: {tuple(new.shape)} vs {old}")
        copies += [(p, new[i] if lead else new, axes) for i, (p, _) in enumerate(targets)]
        imported += 1
    with torch.no_grad():
        for p, value, axes in copies:
            # moved in its own memory order (a plain copy), transposed back and cast on the parameter's device
            value = value.to(p.device)
            p.copy_(value.permute(_TO_PORT[p.dim()]) if axes else value)
    model.imported_weight_count = imported
    return model


# --------------------------------------------------------------------- #
# Whisper
# --------------------------------------------------------------------- #

_WHISPER_ATTN = {
    "q_proj.weight": ("q_proj/kernel", True),
    "q_proj.bias": ("q_proj/bias", False),
    "k_proj.weight": ("k_proj/kernel", True),
    "v_proj.weight": ("v_proj/kernel", True),
    "v_proj.bias": ("v_proj/bias", False),
    "out_proj.weight": ("out_proj/kernel", True),
    "out_proj.bias": ("out_proj/bias", False),
}

_WHISPER_NORMS = {
    "self_attn_layer_norm": "ln_self",
    "encoder_attn_layer_norm": "ln_cross",
    "final_layer_norm": "ln_ffn",
}


def convert_hf_whisper_state(state: dict[str, torch.Tensor]) -> dict:
    """HF ``WhisperForConditionalGeneration`` -> the flax param tree. Torch
    Conv1d weights [out, in, k] transpose to flax [k, in, out]; the decoder
    output projection is tied to ``embed_tokens`` (proj_out has no weight
    of its own in the checkpoint)."""
    state = _strip_prefix(state, ("model.",))
    tree: dict = {}
    for conv in ("conv1", "conv2"):
        if f"encoder.{conv}.weight" in state:
            _set(tree, f"{conv}/kernel", state[f"encoder.{conv}.weight"].permute(2, 1, 0))
            _set(tree, f"{conv}/bias", state[f"encoder.{conv}.bias"])
    # encoder.embed_positions is the frozen sinusoid table: the model
    # computes it (models/whisper.py sinusoids), so it is not imported
    if "decoder.embed_positions.weight" in state:
        _set(tree, "dec_pos/embedding", state["decoder.embed_positions.weight"])
    if "decoder.embed_tokens.weight" in state:
        _set(tree, "embed_tokens/embedding", state["decoder.embed_tokens.weight"])
    for stack, out_name in (("encoder", "enc_final_norm"), ("decoder", "dec_final_norm")):
        if f"{stack}.layer_norm.weight" in state:
            _set(tree, f"{out_name}/scale", state[f"{stack}.layer_norm.weight"])
            _set(tree, f"{out_name}/bias", state[f"{stack}.layer_norm.bias"])

    pat = re.compile(r"(encoder|decoder)\.layers\.(\d+)\.(.+)")
    for key, value in state.items():
        m = pat.match(key)
        if not m:
            continue
        stack, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        prefix = f"{'enc' if stack == 'encoder' else 'dec'}_layer_{idx}"
        for hf_attn, our_attn in (("self_attn.", "self_attn"), ("encoder_attn.", "cross_attn")):
            if rest.startswith(hf_attn):
                name, transpose = _WHISPER_ATTN[rest[len(hf_attn):]]
                _set(tree, f"{prefix}/{our_attn}/{name}", value.T if transpose else value)
                break
        else:
            for hf_norm, our_norm in _WHISPER_NORMS.items():
                if rest.startswith(hf_norm + "."):
                    part = "scale" if rest.endswith("weight") else "bias"
                    _set(tree, f"{prefix}/{our_norm}/{part}", value)
                    break
            else:
                for fc in ("fc1", "fc2"):
                    if rest == f"{fc}.weight":
                        _set(tree, f"{prefix}/{fc}/kernel", value.T)
                    elif rest == f"{fc}.bias":
                        _set(tree, f"{prefix}/{fc}/bias", value)
    return tree


def load_hf_whisper(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .whisper import WhisperConfig, create_whisper_model

    state = read_safetensors_state(checkpoint_path)
    tree = convert_hf_whisper_state(state)
    return _merge_into(create_whisper_model(config or WhisperConfig(), device=device, dtype=dtype), tree)


# --------------------------------------------------------------------- #
# CLIP
# --------------------------------------------------------------------- #

_CLIP_BLOCK = {
    "self_attn.q_proj.weight": ("q_proj/kernel", True),
    "self_attn.q_proj.bias": ("q_proj/bias", False),
    "self_attn.k_proj.weight": ("k_proj/kernel", True),
    "self_attn.k_proj.bias": ("k_proj/bias", False),
    "self_attn.v_proj.weight": ("v_proj/kernel", True),
    "self_attn.v_proj.bias": ("v_proj/bias", False),
    "self_attn.out_proj.weight": ("out_proj/kernel", True),
    "self_attn.out_proj.bias": ("out_proj/bias", False),
    "layer_norm1.weight": ("ln1/scale", False),
    "layer_norm1.bias": ("ln1/bias", False),
    "layer_norm2.weight": ("ln2/scale", False),
    "layer_norm2.bias": ("ln2/bias", False),
    "mlp.fc1.weight": ("fc1/kernel", True),
    "mlp.fc1.bias": ("fc1/bias", False),
    "mlp.fc2.weight": ("fc2/kernel", True),
    "mlp.fc2.bias": ("fc2/bias", False),
}

_CLIP_FIXED = {
    "vision_model.embeddings.class_embedding": ("vision/class_embedding", False),
    "vision_model.embeddings.position_embedding.weight": ("vision/pos_embed/embedding", False),
    # yes, HF really spells it "pre_layrnorm"
    "vision_model.pre_layrnorm.weight": ("vision/pre_norm/scale", False),
    "vision_model.pre_layrnorm.bias": ("vision/pre_norm/bias", False),
    "vision_model.post_layernorm.weight": ("vision/post_norm/scale", False),
    "vision_model.post_layernorm.bias": ("vision/post_norm/bias", False),
    "text_model.embeddings.token_embedding.weight": ("text/token_embed/embedding", False),
    "text_model.embeddings.position_embedding.weight": ("text/pos_embed/embedding", False),
    "text_model.final_layer_norm.weight": ("text/final_norm/scale", False),
    "text_model.final_layer_norm.bias": ("text/final_norm/bias", False),
    "visual_projection.weight": ("visual_projection/kernel", True),
    "text_projection.weight": ("text_projection/kernel", True),
    "logit_scale": ("logit_scale", False),
}


def convert_hf_clip_state(state: dict[str, torch.Tensor]) -> dict:
    """HF ``CLIPModel`` -> the flax param tree. The conv patch embedding
    [d, 3, p, p] transposes to flax [p, p, 3, d]."""
    tree: dict = {}
    if "vision_model.embeddings.patch_embedding.weight" in state:
        _set(
            tree,
            "vision/patch_embed/kernel",
            state["vision_model.embeddings.patch_embedding.weight"].permute(2, 3, 1, 0),
        )
    for hf_key, (ours, transpose) in _CLIP_FIXED.items():
        if hf_key in state:
            _set(tree, ours, state[hf_key].T if transpose else state[hf_key])
    pat = re.compile(r"(vision|text)_model\.encoder\.layers\.(\d+)\.(.+)")
    for key, value in state.items():
        m = pat.match(key)
        if not m:
            continue
        tower, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        if rest in _CLIP_BLOCK:
            ours, transpose = _CLIP_BLOCK[rest]
            _set(tree, f"{tower}/block_{idx}/{ours}", value.T if transpose else value)
    return tree


def load_hf_clip(checkpoint_path: str, config=None, *, device=None, dtype: torch.dtype = torch.float32):
    from .clip import CLIPConfig, create_clip_model

    state = read_safetensors_state(checkpoint_path)
    tree = convert_hf_clip_state(state)
    return _merge_into(create_clip_model(config or CLIPConfig(), device=device, dtype=dtype), tree)
