"""Token sampling for the decode paths.

Counterpart of ``accelerate_tpu.generation._make_sampler``: greedy at
temperature 0, else temperature sampling, optionally truncated to the
``top_k`` highest logits. Randomness comes from an explicit
``torch.Generator`` (the JAX package's key chain has no bitwise
counterpart here, so sampled streams match in distribution, not token
for token).
"""

from __future__ import annotations

from typing import Optional

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
