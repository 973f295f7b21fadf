"""The dense KV cache's per-row frontiers (accelerate_tpu_torch.ops.kv_cache):
a ``[B]`` index writes and masks each row at its own frontier, bit for bit
what a batch-1 call at that row's frontier gives in f32, the band and the
softcap included; the int index path is unchanged; the row operations the
engine and beam search use (``row``, ``insert``, ``repeat_rows``,
``gather_rows``) move what they say. A ``cuda``-marked twin serves tiny
Gemma2 on the dense layout on the card against the CPU engine. Inputs are
made with numpy from a seed; no JAX here (the card tests run where the
JAX package cannot be imported)."""

import copy

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.models import Gemma2Config, create_gemma2_model
from accelerate_tpu_torch.ops.kv_cache import KVCache, cached_attention

torch.set_num_threads(2)

L, B, MAX_LEN, H, H_KV, D = 2, 3, 24, 4, 2, 8


def _cache(rng, per_row):
    """A cache whose rows already hold seeded K/V (stale rows included)."""
    cache = KVCache.empty(Gemma2Config.tiny(num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=H_KV,
                                            head_dim=D), B, MAX_LEN, torch.float32, "cpu", per_row=per_row)
    cache.key.copy_(torch.tensor(rng.standard_normal(cache.key.shape), dtype=torch.float32))
    cache.value.copy_(torch.tensor(rng.standard_normal(cache.value.shape), dtype=torch.float32))
    return cache


def _qkv(rng, s_new):
    return tuple(torch.tensor(rng.standard_normal((B, s_new, h, D)), dtype=torch.float32)
                 for h in (H, H_KV, H_KV))


@pytest.mark.parametrize("s_new", [1, 3])
@pytest.mark.parametrize("kw", [{}, {"sliding_window": 4}, {"logit_softcap": 2.0, "scale": 0.3}])
def test_per_row_frontiers_match_batch1_calls_bit_for_bit(s_new, kw):
    rng = np.random.default_rng(0)
    frontiers = torch.tensor([0, 7, 20])
    q, k, v = _qkv(rng, s_new)
    cache = _cache(np.random.default_rng(1), per_row=True)
    cache.index = frontiers.clone()
    rows = [copy.deepcopy(cache).row(i) for i in range(B)]  # each row's own batch-1 cache
    got = cached_attention(cache, 1, q, k, v, **kw)
    for i, row in enumerate(rows):
        row.index = int(frontiers[i])
        want = cached_attention(row, 1, q[i : i + 1], k[i : i + 1], v[i : i + 1], **kw)
        assert torch.equal(got[i : i + 1], want)
        assert torch.equal(cache.key[:, i : i + 1], row.key) and torch.equal(cache.value[:, i : i + 1], row.value)
    cache.advance(s_new)
    assert cache.index.tolist() == (frontiers + s_new).tolist()


def test_per_row_write_clamps_at_the_end_of_the_rows():
    """A frontier past ``max_len - S_new`` writes the last ``S_new`` rows
    (``dynamic_update_slice``'s clamp): a finished slot's overshoot stays
    inside its own rows."""
    rng = np.random.default_rng(2)
    cache = _cache(rng, per_row=True)
    cache.index = torch.tensor([MAX_LEN - 1, MAX_LEN + 5, 3])
    before = cache.key.clone()
    q, k, v = _qkv(rng, 2)
    out = cached_attention(cache, 0, q, k, v)
    assert torch.isfinite(out).all()
    for i, start in enumerate((MAX_LEN - 2, MAX_LEN - 2, 3)):
        assert torch.equal(cache.key[0, i, start : start + 2], k[i])
        keep = torch.ones(MAX_LEN, dtype=torch.bool)
        keep[start : start + 2] = False
        assert torch.equal(cache.key[0, i, keep], before[0, i, keep])


def test_int_index_path_unchanged():
    """The shared int frontier writes at ``index`` and masks as it did: the
    same outputs as a ``[B]`` index of equal entries, and the index stays
    an int."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 3)
    shared, per_row = _cache(np.random.default_rng(4), False), _cache(np.random.default_rng(4), True)
    shared.index, per_row.index = 5, torch.full((B,), 5)
    got = cached_attention(shared, 0, q, k, v, sliding_window=4)
    want = cached_attention(per_row, 0, q, k, v, sliding_window=4)
    assert torch.equal(got, want) and torch.equal(shared.key, per_row.key)
    shared.advance(3)
    assert shared.index == 8 and isinstance(shared.index, int)


def test_row_insert_repeat_and_gather():
    rng = np.random.default_rng(5)
    cache = _cache(rng, per_row=True)
    view = cache.row(1)
    view.key[:, 0, 0] = 7.0  # a view: writes land in the cache
    assert bool((cache.key[:, 1, 0] == 7.0).all()) and view.index == 0
    src = _cache(np.random.default_rng(6), per_row=False)
    row = KVCache(src.key[:, 2:3, :10].clone(), src.value[:, 2:3, :10].clone(), 10)
    kept = cache.key[:, 0, 10:].clone()
    cache.insert(row, 0)
    assert torch.equal(cache.key[:, 0, :10], row.key[:, 0]) and torch.equal(cache.key[:, 0, 10:], kept)
    assert int(cache.index[0]) == 10
    rep = src.repeat_rows(2)
    assert rep.key.shape[1] == 2 * B and torch.equal(rep.key[:, 2], src.key[:, 1]) and rep.index == src.index
    picked = rep.gather_rows(torch.tensor([5, 0]))
    assert torch.equal(picked.key[:, 0], src.key[:, 2]) and torch.equal(picked.value[:, 1], src.value[:, 0])
    per_row = cache.repeat_rows(2).gather_rows(torch.tensor([1, 4]))
    assert per_row.index.tolist() == [int(cache.index[0]), int(cache.index[2])]


@pytest.mark.cuda
def test_cuda_tiny_gemma2_served_dense_equals_the_cpu_engine():
    """Tiny Gemma2 (softcaps, an 8-key band on alternating layers) served
    on the dense layout on the card, plain and with itself as draft: the
    greedy tokens equal the CPU engine's on the same weights (a request's
    comparison may end only at a top-2 logit gap under 1e-4 of the CPU's
    full forward, f32 rounding), and the self-draft accepts at least 9 in
    10 of its proposals (the draft's one-token forward and the verify
    forward may round a near tie apart on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py --only dense runs the dense layout on the H100)")
    from accelerate_tpu_torch import ServingEngine
    from accelerate_tpu_torch.modeling import Model

    cfg = Gemma2Config.tiny()
    cpu = create_gemma2_model(cfg, seed=5, device="cpu")
    card = Model(copy.deepcopy(cpu.module).to("cuda"), cfg, name=cpu.name)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 250, size=n).astype(np.int32) for n in (5, 14, 30)]
    kw = dict(num_slots=2, prompt_buckets=(16, 32), tick_block=4)
    n_new = 13  # the prefill's token + 3 iterations of gamma + 1: no iteration is cut
    want = ServingEngine(cpu, device="cpu", **kw).generate_many(prompts, n_new)
    spec = ServingEngine(card, draft_model=card, gamma=3, **kw)
    for engine in (ServingEngine(card, **kw), spec):
        with torch.no_grad():
            for got, w in zip(engine.generate_many(prompts, n_new), want):
                diff = np.nonzero(got != w)[0]
                if len(diff):
                    row = cpu(torch.as_tensor(w[None, : diff[0]]).long())[0, -1]
                    top2 = torch.topk(row, 2).values
                    assert float(top2[0] - top2[1]) < 1e-4
    # the same model proposes and verifies: a rejection only at an f32 near tie
    assert spec.spec_stats["accepted"] >= 0.9 * 3 * spec.spec_stats["steps"] > 0
