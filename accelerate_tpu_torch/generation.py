"""Autoregressive generation over the dense KV cache, and token sampling.

Counterpart of ``accelerate_tpu.generation``: :func:`generate` (prefill
in one forward over the whole prompt, then one token a step),
:func:`generate_seq2seq` (the encoder-decoder families: the encoder once,
then one decoder token a step), :func:`beam_search`,
:func:`per_token_latency` and the sampler the serving engine shares. The
JAX package scans the steps inside one jitted program; here the loop is
eager Python over the module's cached forward, and the cache is written
in place.

Sampling is greedy at temperature 0, else temperature sampling,
optionally truncated to the ``top_k`` highest logits. Randomness comes
from an explicit ``torch.Generator`` (the JAX package's key chain has no
bitwise counterpart here, so sampled streams match in distribution, not
token for token).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def _make_sampler(temperature: float, top_k: Optional[int]):
    """``sample(logits [N, V], generator) -> int64 [N]``."""

    def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        logits = logits.float()
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[..., 0]

    return sample


def _device_ids(input_ids, device) -> torch.Tensor:
    """Token ids (a tensor or anything numpy takes) as int32 on ``device``."""
    if isinstance(input_ids, torch.Tensor):
        return input_ids.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(input_ids, np.int32), device=device)


def _freeze_after_eos(nxt: torch.Tensor, done: torch.Tensor, eos_token_id: Optional[int]):
    """EOS semantics: finished rows keep emitting EOS."""
    if eos_token_id is None:
        return nxt, done
    nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
    return nxt, done | (nxt == eos_token_id)


@torch.no_grad()
def generate(
    model,
    input_ids,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    seed: int = 0,
    eos_token_id: Optional[int] = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``input_ids`` [B, S]
    on the model's device.

    ``temperature=0`` is greedy; otherwise softmax sampling at the given
    temperature, optionally truncated to the ``top_k`` highest logits, from
    a ``torch.Generator`` seeded with ``seed``. Returns int32
    ``[B, S + max_new_tokens]``. When ``eos_token_id`` is given, positions
    after a sequence's EOS are filled with EOS (the loop still runs to
    ``max_new_tokens``, as the reference's does)."""
    device = model.device
    input_ids = _device_ids(input_ids, device)
    b, prompt_len = input_ids.shape

    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return input_ids
    max_pos = getattr(getattr(model, "config", None), "max_position_embeddings", None)
    if max_pos is not None and prompt_len + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's cache size (max_position_embeddings={max_pos})"
        )

    sample = _make_sampler(temperature, top_k)
    gen = torch.Generator(device=device).manual_seed(seed) if temperature > 0.0 else None
    # prefill: one forward over the prompt primes the cache and gives the first next-token logits
    positions = torch.arange(prompt_len, device=device).expand(b, prompt_len)
    logits, cache = model(input_ids, positions=positions, decode=True, cache=None)
    tok = sample(logits[:, -1], gen)
    done = torch.zeros(b, dtype=torch.bool, device=device) if eos_token_id is None else tok == eos_token_id
    new_tokens = [tok]
    for pos in range(prompt_len, prompt_len + max_new_tokens - 1):
        positions = torch.full((b, 1), pos, device=device)
        logits, cache = model(tok[:, None], positions=positions, decode=True, cache=cache)
        tok, done = _freeze_after_eos(sample(logits[:, -1], gen), done, eos_token_id)
        new_tokens.append(tok)
    return torch.cat([input_ids, torch.stack(new_tokens, dim=1).to(torch.int32)], dim=1)


@torch.no_grad()
def generate_seq2seq(
    model,
    input_ids,
    max_new_tokens: int = 32,
    decoder_start_token_id: int = 0,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    seed: int = 0,
    eos_token_id: Optional[int] = None,
    attention_mask=None,
) -> torch.Tensor:
    """Encoder-decoder generation on the model's device (the T5 and
    Whisper contract: ``model(src, decoder_ids, attention_mask=...,
    decode=True, cache=...) -> (logits, cache)``).

    The prefill runs the encoder over ``input_ids`` (token ids, cast to
    int32, or float features such as log-mels, passed as they are) with
    ``attention_mask`` (all ones by default) and the first decoder step on
    ``decoder_start_token_id``; every later step feeds the last token with
    the cache, so the encoder runs exactly once. Sampling as in
    :func:`generate`, from a ``torch.Generator`` seeded with ``seed``;
    after a row's ``eos_token_id`` it keeps emitting EOS. Returns int32
    ``[B, 1 + max_new_tokens]`` starting with the start token. The
    decoder cache holds ``max_decode_len`` rows and the loop writes
    exactly ``max_new_tokens`` of them, so more is refused."""
    device = model.device
    if isinstance(input_ids, torch.Tensor):
        src = input_ids.to(device)
    else:
        src = torch.as_tensor(np.asarray(input_ids), device=device)
        if src.dtype == torch.float64:
            src = src.float()  # the JAX package's float arrays are f32
    if not src.is_floating_point():
        src = src.to(torch.int32)
    b, src_len = src.shape[:2]
    if attention_mask is None:
        attention_mask = torch.ones((b, src_len), dtype=torch.bool, device=device)
    elif isinstance(attention_mask, torch.Tensor):
        attention_mask = attention_mask.to(device=device, dtype=torch.bool)
    else:
        attention_mask = torch.as_tensor(np.asarray(attention_mask, bool), device=device)

    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    start = torch.full((b, 1), decoder_start_token_id, dtype=torch.int32, device=device)
    if max_new_tokens == 0:
        return start
    max_dec = getattr(getattr(model, "config", None), "max_decode_len", None)
    if max_dec is not None and max_new_tokens > max_dec:
        raise ValueError(
            f"max_new_tokens ({max_new_tokens}) exceeds the decoder cache (max_decode_len={max_dec})"
        )

    sample = _make_sampler(temperature, top_k)
    gen = torch.Generator(device=device).manual_seed(seed) if temperature > 0.0 else None
    logits, cache = model(src, start, attention_mask=attention_mask, decode=True, cache=None)
    tok = sample(logits[:, -1], gen)
    done = torch.zeros(b, dtype=torch.bool, device=device) if eos_token_id is None else tok == eos_token_id
    new_tokens = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = model(src, tok[:, None], decode=True, cache=cache)
        tok, done = _freeze_after_eos(sample(logits[:, -1], gen), done, eos_token_id)
        new_tokens.append(tok)
    return torch.cat([start, torch.stack(new_tokens, dim=1).to(torch.int32)], dim=1)


@torch.no_grad()
def beam_search(
    model,
    input_ids,
    max_new_tokens: int = 32,
    num_beams: int = 4,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
    return_scores: bool = False,
):
    """Beam-search decode of ``input_ids`` [B, S] on the model's device.

    Prefill, then repeat the KV cache to ``num_beams`` rows a batch
    element; each step (a) scores every (beam, token) continuation, (b)
    keeps the top ``num_beams`` a batch element, and (c) gathers the cache
    rows along the chosen beams. The rows share one frontier, so the
    cache keeps its int index. EOS beams are frozen (score fixed, forced
    EOS continuation); the returned sequence of each batch element
    maximises ``score / len(new_tokens) ** length_penalty``. Returns int32
    [B, S + max_new_tokens] (and the [B] f32 normalised scores when
    ``return_scores``)."""
    device = model.device
    input_ids = _device_ids(input_ids, device)
    b, prompt_len = input_ids.shape
    k = num_beams
    if k < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    max_pos = getattr(getattr(model, "config", None), "max_position_embeddings", None)
    if max_pos is not None and prompt_len + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's cache size (max_position_embeddings={max_pos})"
        )

    neg = -1e9
    positions = torch.arange(prompt_len, device=device).expand(b, prompt_len)
    logits, cache = model(input_ids, positions=positions, decode=True, cache=None)
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [B, V]
    vocab = logp0.shape[-1]
    scores, tok = torch.topk(logp0, k, dim=-1)  # distinct first tokens seed the beams
    cache = cache.repeat_rows(k)  # [.., B*K, ..]
    done = tok == eos_token_id if eos_token_id is not None else torch.zeros_like(tok, dtype=torch.bool)
    lengths = torch.ones((b, k), dtype=torch.int32, device=device)
    tokens = torch.zeros((b, k, max_new_tokens), dtype=torch.int64, device=device)
    tokens[:, :, 0] = tok
    rows_base = (torch.arange(b, device=device) * k)[:, None]
    for t in range(1, max_new_tokens):
        # the last token was emitted at step t - 1 and sits at position prompt_len + t - 1
        positions = torch.full((b * k, 1), prompt_len + t - 1, device=device)
        logits, cache = model(tok.reshape(b * k, 1), positions=positions, decode=True, cache=cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, k, vocab)
        # live beams extend by any token; done beams only "extend" by EOS at an unchanged score
        cand = scores[:, :, None] + logp
        if eos_token_id is not None:
            frozen = torch.full((b, k, vocab), neg, device=device)
            frozen[:, :, eos_token_id] = 0.0
            cand = torch.where(done[:, :, None], frozen + scores[:, :, None], cand)
        scores, idx = torch.topk(cand.reshape(b, k * vocab), k, dim=-1)  # [B, K]
        beam_idx = idx // vocab  # the source beam
        tok = idx % vocab
        cache = cache.gather_rows((rows_base + beam_idx).reshape(-1))
        done = done.gather(1, beam_idx)
        lengths = lengths.gather(1, beam_idx)
        tokens = tokens.gather(1, beam_idx[:, :, None].expand(b, k, max_new_tokens))
        lengths = lengths + (~done).to(torch.int32)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
        tokens[:, :, t] = tok

    norm = scores / lengths.float() ** length_penalty
    best = torch.argmax(norm, dim=1)  # [B]
    best_tokens = tokens[torch.arange(b, device=device), best].to(torch.int32)
    out = torch.cat([input_ids, best_tokens], dim=1)
    if not return_scores:
        return out
    return out, norm.gather(1, best[:, None])[:, 0]


def per_token_latency(model, batch_size: int = 1, prompt_len: int = 32, n_tokens: int = 16) -> float:
    """Steady-state decode latency a token, in seconds.

    Method (the reference's): time one long decode (``16 * n_tokens``
    steps) and one short one (``n_tokens``), take the difference and
    divide by the step difference. Both runs carry the same prefill, so
    the difference isolates decode steps. Each timed run ends in a read of
    its last token, and on the card in ``torch.cuda.synchronize()``."""
    ids = np.ones((batch_size, prompt_len), np.int32)
    n_long, n_short = 16 * n_tokens, n_tokens
    # clamp to the model's KV-cache budget (generate() rejects overruns)
    max_pos = getattr(getattr(model, "config", None), "max_position_embeddings", None)
    if max_pos is not None and prompt_len + n_long > max_pos:
        n_long = max_pos - prompt_len
        n_short = max(1, n_long // 16)
        if n_long <= n_short:
            raise ValueError(
                f"cache too small to measure: prompt {prompt_len} leaves {n_long} decode steps "
                f"(max_position_embeddings={max_pos})"
            )

    def sync(out):
        int(out[0, -1])
        if out.is_cuda:
            torch.cuda.synchronize(out.device)

    def timed(n):
        t0 = time.perf_counter()
        sync(generate(model, ids, max_new_tokens=n))
        return time.perf_counter() - t0

    for n in (n_long, n_short):  # warm each token count once (allocator, kernel libraries)
        sync(generate(model, ids, max_new_tokens=n))
    best = min(timed(n_long) - timed(n_short) for _ in range(2))
    if best <= 0:
        # noise swamped the signal: report the amortized whole-run cost
        # (an upper bound that includes the prefill)
        return timed(n_long) / n_long
    return best / (n_long - n_short)
