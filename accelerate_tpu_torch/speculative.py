"""Speculative decoding: draft-proposed tokens verified by the target in
one forward — fewer target passes per emitted token, token-exact output.

Counterpart of :mod:`accelerate_tpu.speculative`. Greedy acceptance: the
draft proposes ``gamma`` tokens autoregressively, the target scores all
of them in ONE forward, the longest prefix where the draft matched the
target's own argmax is accepted, and the target's argmax at the first
mismatch is emitted as the correction (or, when every draft matched, as
a bonus token). Every iteration emits ``accepted + 1`` tokens for one
target forward, and the output equals plain greedy decode of the target.

Where the JAX package writes the step for one row and ``vmap``s it over
the serving engine's slots, the port writes it batched: both caches
carry a ``[B]`` tensor of per-row frontiers (:mod:`.ops.kv_cache`), each
draft pass and the verify pass are one forward over every row, and each
row accepts its own run. Rejected positions leave stale rows in both
caches, but each row's frontier is reset to ``pos + n_emit``, and every
stale row is overwritten before the causal frontier reaches it.

A corollary the serving scheduler leans on: the emitted stream is the
target's argmax stream for ANY draft behaviour — a stale or garbage
draft cache can only lower the acceptance rate, never change a token.
"""

from __future__ import annotations

from typing import Optional

import torch

from .generation import _device_ids
from .ops.kv_cache import reset_cache_index


def build_spec_step(target, draft, gamma: int):
    """The draft-propose / target-verify core shared by
    :func:`speculative_generate` and the serving engine's speculative tick:

    ``spec_step(t_cache, d_cache, last_tok [B], pos [B]) -> (emit [B,
    gamma+1], lps [B, gamma+1], n_emit [B])``

    ``pos`` is each row's frontier (= valid entries in BOTH caches, whose
    indexes are ``[B]`` tensors; ``last_tok`` is emitted but not yet
    cached). ``emit[:, :n_emit]`` are the row's emitted tokens (the rest
    is 0), ``lps`` the target's f32 log-softmax of each. The caches are
    written in place and both frontiers set to ``pos + n_emit``."""
    g = gamma

    def spec_step(t_cache, d_cache, last_tok, pos):
        tok, drafts = last_tok, []
        for j in range(g):  # drafts[j] is the token for position pos + j + 1
            logits, _ = draft(tok[:, None], positions=(pos + j)[:, None], decode=True, cache=d_cache)
            tok = torch.argmax(logits[:, -1].float(), dim=-1)
            drafts.append(tok)
        # one extra draft pass caches the last draft's own row (needed when
        # every draft is accepted: the next frontier includes it)
        draft(tok[:, None], positions=(pos + g)[:, None], decode=True, cache=d_cache)
        drafts = torch.stack(drafts, dim=1)  # [B, g]

        # the target scores last_tok + ALL g drafts in ONE pass: row j is its
        # token for position pos + j + 1, so row g is the bonus token
        fed = torch.cat([last_tok[:, None], drafts], dim=1)  # [B, g + 1]
        positions = pos[:, None] + torch.arange(g + 1, device=pos.device)
        t_logits, _ = target(fed, positions=positions, decode=True, cache=t_cache)
        rows = t_logits.float()  # [B, g + 1, V]
        t_argmax = torch.argmax(rows, dim=-1)  # [B, g + 1]

        n_acc = torch.cumprod((drafts == t_argmax[:, :g]).long(), dim=1).sum(dim=1)  # leading matches
        emit = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        emit = torch.where(torch.arange(g + 1, device=pos.device) < n_acc[:, None], emit, 0)
        emit.scatter_(1, n_acc[:, None], t_argmax.gather(1, n_acc[:, None]))
        n_emit = n_acc + 1
        lps = torch.log_softmax(rows, dim=-1).gather(-1, emit[:, :, None])[:, :, 0]

        reset_cache_index(t_cache, pos + n_emit)
        reset_cache_index(d_cache, pos + n_emit)
        return emit, lps, n_emit

    return spec_step


@torch.no_grad()
def speculative_generate(
    target_model,
    draft_model,
    input_ids,
    max_new_tokens: int = 32,
    gamma: int = 4,
    eos_token_id: Optional[int] = None,
    return_stats: bool = False,
):
    """Greedy speculative decode of ``input_ids`` [1, S] (batch 1) on the
    target's device.

    ``draft_model`` must share the target's vocabulary (typically a
    smaller model of the same family) and live on the same device.
    Returns int32 [1, S + n] with n <= max_new_tokens (exactly
    max_new_tokens without EOS). With ``return_stats``: (tokens,
    {"target_forwards", "emitted", "tokens_per_target_forward",
    "accept_rate"}), counting only the tokens kept."""
    device = target_model.device
    input_ids = _device_ids(input_ids, device)
    if input_ids.ndim != 2 or input_ids.shape[0] != 1:
        raise ValueError(f"speculative_generate is batch-1 ([1, S]); got {tuple(input_ids.shape)}")
    prompt_len = input_ids.shape[1]
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    cap = min(target_model.config.max_position_embeddings, draft_model.config.max_position_embeddings)
    # +gamma headroom: the last iteration may write gamma speculative rows
    # past the budget before the host truncates
    if prompt_len + max_new_tokens + gamma > cap:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) + gamma "
            f"({gamma}) exceeds the smaller cache (max_position_embeddings={cap})"
        )

    positions = torch.arange(prompt_len, device=device)[None]
    t_logits, t_cache = target_model(input_ids, positions=positions, decode=True, cache=None)
    _, d_cache = draft_model(input_ids, positions=positions, decode=True, cache=None)
    frontier = torch.full((1,), prompt_len, dtype=torch.int64, device=device)
    reset_cache_index(t_cache, frontier)
    reset_cache_index(d_cache, frontier)
    first = int(torch.argmax(t_logits[0, -1].float()))
    spec_step = build_spec_step(target_model, draft_model, gamma)

    out = [first]
    target_forwards, n_steps, pos = 1, 0, prompt_len
    while len(out) < max_new_tokens and (eos_token_id is None or out[-1] != eos_token_id):
        last = torch.full((1,), out[-1], dtype=torch.int64, device=device)
        emit, _, n_emit = spec_step(t_cache, d_cache, last, torch.full_like(last, pos))
        target_forwards += 1
        n_steps += 1
        n = int(n_emit[0])
        toks = emit[0, :n].tolist()
        if eos_token_id is not None and eos_token_id in toks:
            out.extend(toks[: toks.index(eos_token_id) + 1])
            break
        out.extend(toks)
        pos += n

    out = out[:max_new_tokens]
    tokens = torch.cat([input_ids, torch.tensor([out], dtype=torch.int32, device=device)], dim=1)
    if not return_stats:
        return tokens
    # stats count only USABLE tokens (after the eos/budget cut): each step
    # contributes one correction; everything else it kept was accepted
    accepted_usable = max(0, len(out) - 1 - n_steps)
    stats = {
        "target_forwards": target_forwards,
        "emitted": len(out),
        "tokens_per_target_forward": len(out) / target_forwards,
        "accept_rate": accepted_usable / max(1, n_steps * gamma),
    }
    return tokens, stats
