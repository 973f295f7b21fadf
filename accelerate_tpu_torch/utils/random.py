"""Seeding.

Counterpart of :mod:`accelerate_tpu.utils.random`. The JAX package records
the seed and derives a key per step by folding (``key_for_step``); here
the same role falls to :func:`generator_for_step`, a ``torch.Generator``
seeded from the global seed and the step. The two give different numbers
from the same seed: tests that compare them feed both the same noise.
:func:`synchronize_rng_states` is the loader's hook for giving every
process process 0's RNG states; with the one process the port runs, only
a given ``torch.Generator`` is set (to its own state) and nothing else.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

import numpy as np
import torch

from .dataclasses import RNGType

_GLOBAL_SEED: Optional[int] = None


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> None:
    """Seed python, numpy and torch (every device) and record the seed for
    :func:`generator_for_step`. One process only, so ``device_specific``
    adds process index 0. ``deterministic`` asks torch for deterministic
    algorithms."""
    global _GLOBAL_SEED
    _GLOBAL_SEED = seed
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)


def generator_for_step(step: int, device=None) -> torch.Generator:
    """A generator on ``device`` seeded from the global seed (0 when none was
    set) and ``step``: the same seed and step give the same stream."""
    seed = 0 if _GLOBAL_SEED is None else _GLOBAL_SEED
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 1) % (2**63)
    return torch.Generator(device=device or "cpu").manual_seed(mixed)


def synchronize_rng_state(rng_type: Optional[RNGType] = None, generator: Optional[torch.Generator] = None) -> None:
    """Give this process process 0's state of one RNG. With one process the
    python, numpy and torch RNGs already hold it; ``generator`` takes
    process 0's state, which is its own."""
    if rng_type is not None:
        RNGType(rng_type)  # an unknown name raises
    if rng_type == RNGType.GENERATOR and generator is not None:
        generator.set_state(generator.get_state())


def synchronize_rng_states(rng_types: Iterable[str], generator: Optional[torch.Generator] = None) -> None:
    for rng_type in rng_types:
        synchronize_rng_state(RNGType(rng_type), generator=generator)
