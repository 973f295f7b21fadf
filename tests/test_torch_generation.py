"""The port's generate / per_token_latency (accelerate_tpu_torch.generation)
against the JAX package's on the same weights, float and weight-only
quantized, f32 on the CPU: greedy output token for token, the eos freeze,
the argument errors; sampled output by property (jax.random and
torch.Generator draw different numbers)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import accelerate_tpu.utils.quantization as jq
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import create_llama_model as jax_create_llama_model
from accelerate_tpu_torch import LlamaConfig, create_llama_model, generate, llama_params_from_jax, per_token_latency
from accelerate_tpu_torch.generation import _freeze_after_eos

torch.set_num_threads(2)

# None: the float model; else (method, group_size) quantized by the JAX package
MODELS = [None, ("int4", 64), ("int8", None), ("nf4", 16), ("w8a8", None)]
_CACHE: dict = {}


def _pair(quant):
    """A JAX tiny llama (quantized by the JAX package when ``quant`` is
    set) and the port's llama carrying its weights."""
    if quant not in _CACHE:
        jmodel = jax_create_llama_model(JaxLlamaConfig.tiny(hidden_size=128, intermediate_size=256), seed=2, seq_len=16)
        if quant is not None:
            method, g = quant
            jmodel = jq.load_and_quantize_model(
                jmodel, jq.QuantizationConfig(method=method, group_size=g, bits=8 if method in ("int8", "w8a8") else 4)
            )
        cfg = LlamaConfig(**dataclasses.asdict(jmodel.config))
        model = create_llama_model(cfg, device="cpu")
        model.load_state_dict(llama_params_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg))
        _CACHE[quant] = (jmodel, model)
    return _CACHE[quant]


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, 250, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("quant", MODELS, ids=lambda q: "float" if q is None else q[0])
def test_greedy_generate_matches_jax_token_for_token(quant):
    jmodel, model = _pair(quant)
    ids = _ids(3, 7)
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=9))
    got = generate(model, ids, max_new_tokens=9)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # the cached loop agrees with a no-cache greedy loop over the full forward
    seq = torch.tensor(ids).long()
    with torch.no_grad():
        for _ in range(9):
            seq = torch.cat([seq, model(seq)[:, -1].argmax(-1, keepdim=True)], dim=1)
    np.testing.assert_array_equal(got.numpy(), seq.numpy())


@pytest.mark.parametrize("quant", [None, ("int4", 64)], ids=["float", "int4"])
def test_eos_freeze_matches_jax(quant):
    """eos chosen from the free-running stream so that it fires mid-way in
    one row: that row emits eos from there on, in both packages."""
    jmodel, model = _pair(quant)
    ids = _ids(3, 6, seed=1)
    free = generate(model, ids, max_new_tokens=8).numpy()
    eos = int(free[1, 6 + 3])
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=8, eos_token_id=eos))
    got = generate(model, ids, max_new_tokens=8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[1, 6:] == eos))
    assert first <= 3 and np.all(got[1, 6 + first :] == eos)
    assert not np.array_equal(got, free) or first == 7


def test_freeze_after_eos_rule():
    nxt, done = torch.tensor([5, 9, 2]), torch.tensor([False, True, False])
    out, done2 = _freeze_after_eos(nxt, done, 2)
    assert out.tolist() == [5, 2, 2] and done2.tolist() == [False, True, True]
    out, done2 = _freeze_after_eos(nxt, done, None)
    assert out is nxt and done2 is done


def test_generate_argument_errors_match_jax():
    jmodel, model = _pair(None)
    ids = _ids(1, 5)
    for kw in (dict(max_new_tokens=-1), dict(max_new_tokens=model.config.max_position_embeddings)):
        with pytest.raises(ValueError):
            jax_generate(jmodel, ids, **kw)
        with pytest.raises(ValueError, match="max_new_tokens|exceeds"):
            generate(model, ids, **kw)
    out = generate(model, ids, max_new_tokens=0)
    np.testing.assert_array_equal(out.numpy(), ids)
    one = generate(model, torch.tensor(ids), max_new_tokens=1)
    assert one.shape == (1, 6)


def test_sampled_generate_is_reproducible_and_stays_in_top_k():
    _, model = _pair(("int4", 64))
    ids = _ids(2, 5, seed=3)
    kw = dict(max_new_tokens=7, temperature=0.8, top_k=4)
    a, b = generate(model, ids, seed=5, **kw), generate(model, ids, seed=5, **kw)
    assert torch.equal(a, b)
    others = [generate(model, ids, seed=s, **kw) for s in (6, 7, 8)]
    assert any(not torch.equal(a, o) for o in others)
    with torch.no_grad():
        logits = model(a[:, :-1])
    for row in range(2):
        for i in range(5, 12):
            assert int(a[row, i]) in torch.topk(logits[row, i - 1], 4).indices.tolist()
    # temperature with top_k=1 is greedy
    greedy = generate(model, ids, max_new_tokens=7)
    assert torch.equal(generate(model, ids, max_new_tokens=7, temperature=1.3, top_k=1, seed=1), greedy)


def test_per_token_latency_measures_and_clamps_to_the_cache():
    _, model = _pair(None)
    lat = per_token_latency(model, batch_size=2, prompt_len=8, n_tokens=2)
    assert isinstance(lat, float) and 0.0 < lat < 5.0
    # 16 x n_tokens steps would overrun the 128-row cache: the long run is clamped, not refused
    assert per_token_latency(model, batch_size=1, prompt_len=100, n_tokens=4) > 0.0
    with pytest.raises(ValueError, match="cache too small"):
        per_token_latency(model, prompt_len=model.config.max_position_embeddings - 1)
