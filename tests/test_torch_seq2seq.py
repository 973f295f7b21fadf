"""``generate_seq2seq`` and the encoder-decoder cache of the port
(generation.py, ops/kv_cache.py) against the JAX package's, for T5 and
Whisper at ``tiny()`` on the same weights (tests/torch_seq2seq_common.py):
greedy tokens equal to JAX's and to the full-rerun loop (the JAX
``tests/test_generation.py`` gold standard), the encoder run once a call,
garbage under the mask, the EOS freeze, the refusals, sampled decoding by
property (the generators of the two packages never agree), the f32 cross
cache projected once, ``cached_attention``'s ``bias_fn`` (the paged cache
refuses it) and the caches for the two configs. Inputs are made with
numpy from a seed; everything runs on the CPU."""

import numpy as np
import pytest
import torch

from accelerate_tpu.generation import generate_seq2seq as jax_generate_seq2seq
import accelerate_tpu_torch.models as pm
from accelerate_tpu_torch import generate_seq2seq
from accelerate_tpu_torch.ops.kv_cache import KVCache, Seq2SeqCache, cache_layers, cached_attention, kv_layout
from accelerate_tpu_torch.ops.paged_kv import PagedConfig, PagedKVCache
from torch_seq2seq_common import jax_model, padding_mask, port_model, source

torch.set_num_threads(2)

FAMILIES = ["t5", "whisper"]


def _start(family):
    return 0 if family == "t5" else 3


@pytest.mark.parametrize("eos", [None, "first"])
@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_equal_jax(family, eos):
    """Greedy ``generate_seq2seq`` token for token with the JAX package's,
    a padded T5 source with its mask; with ``eos`` the first generated
    token of row 0 (so that row freezes at once)."""
    jmodel, model = jax_model(family), port_model(family)
    src = source(family, seed=4)
    mask = padding_mask() if family == "t5" else None
    kw = dict(max_new_tokens=10, decoder_start_token_id=_start(family), attention_mask=mask)
    if eos:
        kw["eos_token_id"] = int(np.asarray(jax_generate_seq2seq(jmodel, src, **{**kw, "max_new_tokens": 1}))[0, 1])
    want = np.asarray(jax_generate_seq2seq(jmodel, src, **kw))
    got = generate_seq2seq(model, src, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos:
        assert (want[0, 1:] == kw["eos_token_id"]).all()


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_equal_the_full_rerun_loop(family):
    """The cached loop equals greedy decoding by full teacher-forced
    re-runs of the port's own forward (the encoder every time)."""
    model = port_model(family)
    src = torch.as_tensor(source(family, seed=5))
    dec = torch.full((2, 1), _start(family), dtype=torch.int32)
    with torch.no_grad():
        for _ in range(8):
            nxt = model(src, dec)[:, -1].argmax(-1).to(torch.int32)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
    got = generate_seq2seq(model, src, max_new_tokens=8, decoder_start_token_id=_start(family))
    np.testing.assert_array_equal(got.numpy(), dec.numpy())


@pytest.mark.parametrize("family", FAMILIES)
def test_encoder_runs_once_a_call(family, monkeypatch):
    """A counter on the encoder stack's first layer: one run for the
    prefill, none for the steps; the cross K/V projections run once a
    layer (counted where ``cached_cross_kv`` calls them), though every
    step reads the stored pair."""
    model = port_model(family)
    counts = {"enc": 0, "projected": 0, "read": 0}
    model.module.enc_layers[0].register_forward_pre_hook(lambda *a: counts.__setitem__("enc", counts["enc"] + 1))
    module = pm.t5 if family == "t5" else pm.whisper
    real = module.cached_cross_kv

    def counted(cache, layer, make_k, make_v, prime):
        counts["read"] += 1

        def make():
            counts["projected"] += 1
            return make_k()

        return real(cache, layer, make, make_v, prime)

    monkeypatch.setattr(module, "cached_cross_kv", counted)
    generate_seq2seq(model, source(family), max_new_tokens=9, decoder_start_token_id=_start(family))
    layers = len(model.module.dec_layers)
    assert counts == {"enc": 1, "projected": layers, "read": 9 * layers}


def test_garbage_under_the_mask_gives_the_same_tokens():
    model = port_model("t5")
    src, mask = source("t5", seed=6), padding_mask(lengths=(5, 7))
    want = generate_seq2seq(model, src, max_new_tokens=8, attention_mask=mask)
    garbage = np.where(mask, src, np.random.default_rng(1).integers(2, 256, size=src.shape)).astype(np.int32)
    assert (garbage != src).any()
    np.testing.assert_array_equal(generate_seq2seq(model, garbage, max_new_tokens=8, attention_mask=mask).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("family", FAMILIES)
def test_eos_freezes_a_finished_row(family):
    model = port_model(family)
    src = source(family, seed=7)
    free = generate_seq2seq(model, src, max_new_tokens=8, decoder_start_token_id=_start(family)).numpy()
    eos = int(free[1, 3])
    got = generate_seq2seq(model, src, max_new_tokens=8, decoder_start_token_id=_start(family),
                           eos_token_id=eos).numpy()
    for row in range(2):
        hit = np.nonzero(free[row, 1:] == eos)[0]
        first = int(hit[0]) + 1 if len(hit) else 9
        np.testing.assert_array_equal(got[row, :first + 1], free[row, :first + 1])
        assert (got[row, first:] == eos).all()


@pytest.mark.parametrize("family", FAMILIES)
def test_refusals_and_the_empty_decode(family):
    """The JAX package's ``ValueError``s; ``max_new_tokens == 0`` gives the
    start column."""
    model = port_model(family)
    src = source(family)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 0"):
        generate_seq2seq(model, src, max_new_tokens=-1)
    rows = model.config.max_decode_len  # tiny(): T5 128, Whisper 32
    with pytest.raises(ValueError, match=rf"max_decode_len={rows}\)"):
        generate_seq2seq(model, src, max_new_tokens=rows + 1)
    got = generate_seq2seq(model, src, max_new_tokens=0, decoder_start_token_id=_start(family))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.full((2, 1), _start(family)))
    assert generate_seq2seq(model, src, max_new_tokens=rows).shape == (2, rows + 1)  # the whole cache


@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_decoding_by_property(family):
    """The same seed gives the same tokens, another seed other tokens, and
    every sampled token lies within the ``top_k`` highest logits of the
    teacher-forced forward at its position."""
    model = port_model(family)
    src = source(family, seed=8)
    kw = dict(max_new_tokens=10, decoder_start_token_id=_start(family), temperature=1.5, top_k=5)
    a = generate_seq2seq(model, src, seed=3, **kw)
    np.testing.assert_array_equal(generate_seq2seq(model, src, seed=3, **kw).numpy(), a.numpy())
    assert not torch.equal(generate_seq2seq(model, src, seed=4, **kw), a)
    with torch.no_grad():
        logits = model(torch.as_tensor(src), a[:, :-1])
    kth = torch.topk(logits, 5, dim=-1).values[..., -1]
    chosen = logits.gather(-1, a[:, 1:, None].long())[..., 0]
    assert bool((chosen >= kth).all())


def test_token_ids_are_cast_and_features_pass_through():
    """int64 ids (and a list) decode as the int32 ones do; float64 features
    become f32 as ``jnp.asarray`` makes them, f32 and bf16 ones pass as they
    are (the encoder computes in their dtype)."""
    t5 = port_model("t5")
    ids = source("t5", seed=9)
    want = generate_seq2seq(t5, ids, max_new_tokens=4)
    for other in (ids.astype(np.int64), torch.as_tensor(ids).long(), ids.tolist()):
        np.testing.assert_array_equal(generate_seq2seq(t5, other, max_new_tokens=4).numpy(), want.numpy())
    whisper = port_model("whisper")
    feats = source("whisper", seed=9)
    want = generate_seq2seq(whisper, feats, max_new_tokens=4)
    np.testing.assert_array_equal(generate_seq2seq(whisper, feats.astype(np.float64), max_new_tokens=4).numpy(),
                                  want.numpy())
    seen = []
    whisper.module.enc_layers[0].register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    generate_seq2seq(whisper, torch.as_tensor(feats).bfloat16(), max_new_tokens=2)
    assert seen == [torch.bfloat16]


@pytest.mark.parametrize("family", FAMILIES)
def test_cross_cache_is_f32_projected_once_and_cast_at_each_use(family):
    """A bf16 model's cache: the decoder rows in bf16, the encoder output
    and every layer's cross K/V in f32 (the reference keeps them so), the
    stored values those of a bf16 projection widened."""
    model = port_model(family, dtype=torch.bfloat16)
    src = torch.as_tensor(source(family))
    start = torch.full((2, 1), _start(family), dtype=torch.int32)
    with torch.no_grad():
        _, cache = model(src, start, decode=True, cache=None)
    assert isinstance(cache, Seq2SeqCache) and cache.self_kv.key.dtype == torch.bfloat16
    assert cache.enc_out.dtype == torch.float32
    layers = len(model.module.dec_layers)
    assert len(cache.cross_key) == len(cache.cross_value) == layers
    for k in (*cache.cross_key, *cache.cross_value):
        assert k.dtype == torch.float32 and torch.equal(k, k.bfloat16().float())
    first = cache.cross_key[0]
    with torch.no_grad():
        _, cache = model(src, start, decode=True, cache=cache)
    assert cache.cross_key[0] is first and cache.self_kv.index == 2


def test_bias_fn_adds_to_the_scaled_scores_at_absolute_positions():
    """``bias_fn`` sees the queries' absolute positions and every key's, and
    its bias moves the output; no bias equals a zero bias; a ``[B]`` index
    (the serving engine's per-row frontiers) is refused."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 4, 8, generator=gen)
    k, v = torch.randn(2, 2, 3, 2, 8, generator=gen).unbind(0)
    seen = []

    def bias_fn(q_pos, key_pos):
        seen.append((q_pos.tolist(), len(key_pos)))
        return (key_pos[None, :] - q_pos[:, None]).float().mul(0.1)[None, None].expand(1, 4, -1, -1)

    def cache(index):
        c = KVCache(torch.zeros(1, 2, 10, 2, 8), torch.zeros(1, 2, 10, 2, 8), index)
        c.key[0, :, :5], c.value[0, :, :5] = torch.randn(2, 2, 5, 2, 8, generator=torch.Generator().manual_seed(1))
        return c

    shared = cached_attention(cache(5), 0, q, k, v, scale=1.0, bias_fn=bias_fn)
    assert seen == [([5, 6, 7], 10)]
    with pytest.raises(ValueError, match="shared int index"):
        cached_attention(cache(torch.tensor([5, 5])), 0, q, k, v, scale=1.0, bias_fn=bias_fn)
    plain = cached_attention(cache(5), 0, q, k, v)
    zero = cached_attention(cache(5), 0, q, k, v, bias_fn=lambda qp, kp: torch.zeros(1, 4, 3, 10))
    torch.testing.assert_close(zero, plain, atol=0, rtol=0)
    assert not torch.allclose(shared, cached_attention(cache(5), 0, q, k, v, scale=1.0), atol=1e-4)


def test_the_paged_cache_refuses_a_bias_fn():
    cfg = pm.LlamaConfig.tiny()
    paged = PagedKVCache.empty(cfg, PagedConfig(block_size=4, num_blocks=5), 1, torch.float32, "cpu")
    q = torch.zeros(1, 1, cfg.num_attention_heads, 16)
    k = v = torch.zeros(1, 1, cfg.num_key_value_heads, 16)
    with pytest.raises(NotImplementedError, match="bias_fn"):
        cached_attention(paged, 0, q, k, v, bias_fn=lambda qp, kp: None)


@pytest.mark.parametrize("family,want", [("t5", (2, 4, 16)), ("whisper", (2, 4, 8))])
def test_caches_take_the_encoder_decoder_configs(family, want):
    """T5 (``num_layers``, heads x ``head_dim``) and Whisper
    (``decoder_layers``, ``d_model / decoder_attention_heads``): the dense
    decoder cache holds the decoder stack."""
    cfg = pm.T5Config.tiny() if family == "t5" else pm.WhisperConfig.tiny()
    assert (cache_layers(cfg), *kv_layout(cfg)) == want
    cache = KVCache.empty(cfg, 3, 12, torch.float32, "cpu")
    assert cache.key.shape == (want[0], 3, 12, want[1], want[2])
    wide = pm.T5Config.tiny(head_dim=32)  # heads x head_dim need not be the width
    assert kv_layout(wide) == (4, 32)


@pytest.mark.parametrize("family", FAMILIES)
def test_entry_points_default_to_cuda(monkeypatch, family):
    create = pm.create_t5_model if family == "t5" else pm.create_whisper_model
    cfg = pm.T5Config.tiny() if family == "t5" else pm.WhisperConfig.tiny()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create(cfg)
    assert create(cfg, device="cpu").device.type == "cpu"
