"""ShapeBucketer: pad ragged dims to a learned bucket set.

Counterpart of :mod:`accelerate_tpu.aot.bucketing`, with the same
invariants. A :class:`ShapeBucketer` maps any observed size to a covering
bucket (powers of two to seed, refined online from the observed-size
histogram), so a stream of ragged shapes runs at most ``len(buckets)``
programs (input signatures, :mod:`.program_cache`) instead of one per
distinct size, and the recompile watchdog goes silent once the bucket set
is warm.

Invariants:

* ``bucket(n) >= n`` always: padding never truncates;
* the bucket returned is the **minimal** covering bucket in the current
  set;
* the set is **grow-only**: refinement may add a tighter bucket but never
  removes one, so a program already built for a bucket is never orphaned;
* every bucket is a multiple of ``multiple_of`` (the data-shard count for
  batch dims).

``pad_batch_tree`` is the companion: wrap-pad a host batch's leading dim
up to the bucket (the ``even_batches`` tail semantics, so the loader's
``remainder`` bookkeeping truncates the repeats). Its leaves may be torch
tensors or numpy arrays, nested in dicts, lists and tuples.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n - 1).bit_length())


def round_up_to(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n: the pad target for an
    alignment constraint (shard counts here)."""
    return -(-n // multiple) * multiple


_round_up = round_up_to  # the JAX package's private alias


class ShapeBucketer:
    """Learned covering-bucket set for one ragged dimension.

    ``seed_buckets`` start the set (rounded up to ``multiple_of``); sizes
    beyond the largest bucket grow the set by rounded powers of two up to
    ``max_size`` (when given, sizes above it raise: the caller's capacity
    bound, e.g. a serving engine's ``max_len``). Every ``refine_every``
    observations the histogram is consulted: if an existing bucket's mean
    pad waste exceeds ``waste_threshold``, the most frequent observed size
    under it is promoted to its own bucket (bounded by ``max_buckets``:
    each bucket is one program).
    """

    def __init__(
        self,
        seed_buckets=(),
        *,
        multiple_of: int = 1,
        max_buckets: int = 16,
        max_size: Optional[int] = None,
        refine_every: int = 64,
        waste_threshold: float = 0.25,
    ):
        if multiple_of < 1:
            raise ValueError(f"multiple_of must be >= 1, got {multiple_of}")
        if max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
        self.multiple_of = int(multiple_of)
        self.max_buckets = int(max_buckets)
        self.max_size = int(max_size) if max_size is not None else None
        self.refine_every = max(1, int(refine_every))
        self.waste_threshold = float(waste_threshold)
        self._buckets: set[int] = set()
        self.histogram: collections.Counter = collections.Counter()
        self._observations = 0
        for b in seed_buckets:
            self._add(int(b))

    def _add(self, b: int) -> int:
        b = _round_up(max(1, b), self.multiple_of)
        if self.max_size is not None:
            b = min(b, _round_up(self.max_size, self.multiple_of))
        self._buckets.add(b)
        return b

    @property
    def buckets(self) -> tuple:
        """Current bucket set, ascending (grow-only)."""
        return tuple(sorted(self._buckets))

    def lookup(self, n: int) -> Optional[int]:
        """Minimal covering bucket from the CURRENT set, or None: no
        learning, no growth (the chunked-prefill path uses this so long
        remainders do not mint unbounded buckets)."""
        covering = [b for b in self._buckets if b >= n]
        return min(covering) if covering else None

    def bucket(self, n: int) -> int:
        """Minimal covering bucket for ``n``, recording the observation and
        growing the set when nothing covers. Never returns < n."""
        n = int(n)
        if n < 1:
            raise ValueError(f"size must be >= 1, got {n}")
        if self.max_size is not None and n > self.max_size:
            raise ValueError(f"size {n} exceeds max_size {self.max_size}")
        self.histogram[n] += 1
        self._observations += 1
        got = self.lookup(n)
        if got is None:
            got = self._add(next_pow2(n))
            if got < n:  # the max_size clamp undershot the need
                got = self._add(n)
        if self._observations % self.refine_every == 0:
            self.refine()
            got = self.lookup(n) or got
        return got

    def refine(self) -> list:
        """One histogram-driven refinement pass; returns the buckets it
        added (possibly none). Grow-only and bounded by ``max_buckets``."""
        added = []
        buckets = self.buckets
        for b in buckets:
            if len(self._buckets) + len(added) >= self.max_buckets:
                break
            lower = max((x for x in buckets if x < b), default=0)
            sizes = {n: c for n, c in self.histogram.items() if lower < n <= b}
            total = sum(sizes.values())
            if not total:
                continue
            waste = sum((b - n) * c for n, c in sizes.items()) / (b * total)
            if waste <= self.waste_threshold:
                continue
            candidate = _round_up(max(sizes, key=lambda n: (sizes[n], n)), self.multiple_of)
            if candidate not in self._buckets and candidate < b:
                self._add(candidate)
                added.append(candidate)
        return added

    def stats(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "observations": self._observations,
            "distinct_sizes": len(self.histogram),
        }


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray)) and leaf.ndim >= 1


def pad_batch_tree(batch, target: int, current: Optional[int] = None):
    """Wrap-pad every tensor or array leaf's leading dim up to ``target``
    rows, repeating from the start (the ``even_batches`` tail semantics:
    padded rows are real samples, so a loss over them stays finite and
    ``remainder``-based truncation recovers exactness). A torch leaf stays
    a torch leaf on its device, a numpy leaf a numpy leaf. Other leaves,
    and leaves whose leading dim differs from the batch dim, pass through
    untouched; a batch is never truncated."""
    if current is None:
        sizes = [leaf.shape[0] for leaf in _tree_leaves(batch) if _is_array(leaf)]
        current = max(sizes) if sizes else 0
    if target <= current or current == 0:
        return batch

    def pad(leaf):
        if not _is_array(leaf) or leaf.shape[0] != current:
            return leaf
        parts, need = [leaf], target - leaf.shape[0]
        while need > 0:
            take = min(need, leaf.shape[0])
            parts.append(leaf[:take])
            need -= take
        return torch.cat(parts, dim=0) if isinstance(leaf, torch.Tensor) else np.concatenate(parts, axis=0)

    return _tree_map(pad, batch)


def _tree_leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _tree_map(fn, tree):
    """Map over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
