"""Autoregressive generation over the dense KV cache, and token sampling.

Counterpart of ``accelerate_tpu.generation``: :func:`generate` (prefill
in one forward over the whole prompt, then one token a step),
:func:`per_token_latency` and the sampler the serving engine shares.
The JAX package scans the steps inside one jitted program; here the loop
is eager Python over the module's cached forward, and the cache is
written in place.

Sampling is greedy at temperature 0, else temperature sampling,
optionally truncated to the ``top_k`` highest logits. Randomness comes
from an explicit ``torch.Generator`` (the JAX package's key chain has no
bitwise counterpart here, so sampled streams match in distribution, not
token for token). ``generate_seq2seq`` and ``beam_search`` are not ported
yet (ROADMAP.md).
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
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.to(device=device, dtype=torch.int32)
    else:
        input_ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=device)
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
