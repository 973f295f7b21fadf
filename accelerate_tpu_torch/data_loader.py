"""Data loading: batches of tensors, placed on the card ahead of use.

Counterpart of :mod:`accelerate_tpu.data_loader`, one process on one
card. The JAX package assembles global sharded arrays; here a batch is a
nesting of tensors on ``device`` (``accelerator.device``). What is kept
exactly, so the port yields the JAX loader's batches index for index:

* ``batch_size`` per data shard (one shard here, so it is the batch) and
  ``split_batches``;
* the seeded shuffle: :class:`SeedableRandomSampler`'s permutation is
  ``np.random.default_rng(seed + epoch)``'s, and the epoch advances only
  on a full pass;
* the fetch-ahead window: ``prefetch_size`` batches are collated and
  copied ahead of the one yielded (from pinned memory without waiting, on
  the card), so ``end_of_dataloader`` and ``remainder`` are set *before*
  the last batch is yielded;
* the tail: with ``even_batches`` a short last batch wraps round to a full
  one from the start of the pass, and ``remainder`` (its real rows) lets
  ``gather_for_metrics`` drop the repeats; without it the tail pads to the
  shard count, which for one shard leaves it as it is; ``drop_last`` drops
  it;
* ``skip_first_batches`` and ``state_dict`` / ``load_state_dict`` for a
  resume mid-epoch.

Multi-process sharding and dispatch across processes are ROADMAP.md Queue
1 item 8; the shape bucketer (``auto_bucketing``) is item 9.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.utils.data

from .state import AcceleratorState, GradientState
from .utils.dataclasses import DataLoaderConfiguration
from .utils.environment import resolve_device
from .utils.operations import send_to_device
from .utils.random import synchronize_rng_states


def default_collate(samples: list) -> Any:
    """Stack a list of samples (dicts, lists or tuples of arrays, tensors or
    numbers) into one batch of tensors; numpy dtypes are kept (int32 ids
    stay int32)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(samples)
    return torch.from_numpy(np.stack([np.asarray(s) for s in samples]))


class SeedableRandomSampler:
    """A permutation that is a function of ``seed + epoch`` only."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()

    def __len__(self):
        return self.data_source_len


class SequentialSampler:
    def __init__(self, data_source_len: int):
        self.data_source_len = data_source_len

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self):
        yield from range(self.data_source_len)

    def __len__(self):
        return self.data_source_len


class BaseDataLoader:
    """What every loader shares: registration with ``GradientState`` for the
    length of a pass, the end flag and ``remainder``, the fetch-ahead
    window, placement on ``device``, and the resume position."""

    def __init__(
        self,
        *,
        device: Optional[torch.device] = None,
        device_placement: bool = True,
        rng_types: Optional[list] = None,
        generator: Optional[torch.Generator] = None,
        prefetch_size: int = 2,
        non_blocking: bool = True,
    ):
        self.gradient_state = GradientState()
        self.device = device
        self.device_placement = device_placement
        self.rng_types = rng_types
        self.generator = generator
        self.prefetch_size = max(1, prefetch_size)
        self.non_blocking = non_blocking
        self.end_of_dataloader = False
        self.remainder = -1
        self.iteration = 0
        self.skip_batches = 0
        self.batches_yielded = 0
        self._is_accelerate_prepared = True

    def _place(self, batch):
        if not self.device_placement:
            return batch
        return send_to_device(batch, self.device, non_blocking=self.non_blocking)

    def begin(self):
        self.end_of_dataloader = False
        self.remainder = -1
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def _windowed(self, batches: Iterable):
        """Yield the placed batches of ``(host batch, real rows, padded rows)``
        triples ``prefetch_size`` behind the placement, setting the end flag
        and ``remainder`` before the last one goes out."""
        window: deque = deque()
        for host, n_real, padded in batches:
            window.append((self._place(host), n_real, padded))
            if len(window) > self.prefetch_size:
                self.batches_yielded += 1
                yield window.popleft()[0]
        while window:
            batch, n_real, padded = window.popleft()
            if not window:
                self.end_of_dataloader = True
                self.remainder = n_real if n_real != padded else -1
            self.batches_yielded += 1
            yield batch

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        if hasattr(self, "sampler") and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self, "dataset") and hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def state_dict(self) -> dict:
        """The position for a resume mid-epoch: the epoch, the batches
        delivered in it, the sampler's epoch and seed, and what one batch
        meant (the global batch size and the data-parallel degree, 1)."""
        sampler = getattr(self, "sampler", None)
        return {
            "iteration": self.iteration,
            "batches_yielded": self.batches_yielded,
            "sampler_epoch": getattr(sampler, "epoch", None),
            "sampler_seed": getattr(sampler, "seed", None),
            "global_batch_size": getattr(self, "total_batch_size", None),
            "data_parallel_degree": 1,
        }

    def load_state_dict(self, state: dict):
        """The next pass replays the saved epoch's order and skips the
        batches already delivered."""
        self.iteration = state.get("iteration", 0)
        self.batches_yielded = state.get("batches_yielded", 0)
        self.skip_batches = self.batches_yielded
        sampler = getattr(self, "sampler", None)
        if sampler is not None:
            if state.get("sampler_seed") is not None and hasattr(sampler, "seed"):
                sampler.seed = state["sampler_seed"]
            if state.get("sampler_epoch") is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(state["sampler_epoch"])


class DataLoaderShard(BaseDataLoader):
    """Map-style loader: index batches from the sampler, rows read and
    collated on the host, the batch placed on the device."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        collate_fn: Optional[Callable] = None,
        drop_last: bool = False,
        even_batches: bool = True,
        split_batches: bool = False,
        sampler=None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.even_batches = even_batches
        self.split_batches = split_batches
        if sampler is None:
            sampler = SeedableRandomSampler(len(dataset), seed=seed) if shuffle else SequentialSampler(len(dataset))
        self.sampler = sampler

    @property
    def total_batch_size(self) -> int:
        """The global batch: ``batch_size`` times the one data shard."""
        return self.batch_size

    @property
    def total_dataset_length(self) -> int:
        return len(self.dataset)

    def __len__(self):
        g = self.total_batch_size
        n = len(self.dataset) - self.skip_batches * g
        return max(0, n // g) if self.drop_last else max(0, math.ceil(n / g))

    def _index_batches(self):
        indices = list(self.sampler)
        g = self.total_batch_size
        for i in range(self.skip_batches * g, len(indices), g):
            chunk = indices[i : i + g]
            n_real = len(chunk)
            if n_real < g:
                if self.drop_last:
                    return
                # even_batches: wrap round to the full batch; otherwise pad to
                # the shard count (one), which leaves the tail as it is
                while self.even_batches and len(chunk) < g:
                    chunk += indices[: g - len(chunk)]
            yield chunk, n_real

    def __iter__(self):
        if self.rng_types is not None:
            synchronize_rng_states(self.rng_types, self.generator)
        self.begin()
        # batches_yielded continues from skip_batches, so a resumed pass counts
        # as an unbroken one does
        self.batches_yielded = self.skip_batches
        completed = False
        try:
            batches = (
                (self.collate_fn([self.dataset[i] for i in chunk]), n_real, len(chunk))
                for chunk, n_real in self._index_batches()
            )
            yield from self._windowed(batches)
            completed = True
        finally:
            self.skip_batches = 0
            if completed:
                # the epoch advances on a full pass only: after a break,
                # state_dict() still names the epoch batches_yielded counts in
                self.batches_yielded = 0
                self.iteration += 1
                if hasattr(self.sampler, "set_epoch"):
                    self.sampler.set_epoch(self.iteration)
            self.end()


class IterableDataLoaderShard(BaseDataLoader):
    """Iterable-dataset loader: samples streamed and chunked into batches."""

    def __init__(
        self,
        dataset: Iterable,
        batch_size: int = 1,
        collate_fn: Optional[Callable] = None,
        drop_last: bool = False,
        even_batches: bool = True,
        split_batches: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.even_batches = even_batches
        self.split_batches = split_batches

    @property
    def total_batch_size(self) -> int:
        return self.batch_size

    def _batched_samples(self):
        g = self.total_batch_size
        buf, first = [], []
        n_full = 0  # every full batch, skipped or yielded: the tail's ordinal
        for sample in self.dataset:
            buf.append(sample)
            if len(first) < g:
                first.append(sample)
            if len(buf) == g:
                n_full += 1
                if n_full > self.skip_batches:
                    yield self.collate_fn(buf), g, g
                buf = []
        if buf and n_full < self.skip_batches:
            return  # the resume position is past the tail: it was delivered before the save
        if buf and not self.drop_last:
            n_real = len(buf)
            target = g if self.even_batches else n_real  # the shard count (one) divides any tail
            for i in range(target - n_real):
                buf.append(first[i % len(first)])
            yield self.collate_fn(buf), n_real, target

    def __iter__(self):
        self.begin()
        self.batches_yielded = self.skip_batches
        completed = False
        try:
            yield from self._windowed(self._batched_samples())
            completed = True
        finally:
            self.skip_batches = 0
            if completed:
                self.batches_yielded = 0
            self.end()


class DataLoaderDispatcher(BaseDataLoader):
    """Dispatch mode: one reader (process 0) loads every batch and hands
    each process its rows. With one process that is the inner loader's
    batches, placed here."""

    def __init__(self, inner: BaseDataLoader):
        super().__init__(
            device=inner.device,
            device_placement=inner.device_placement,
            prefetch_size=inner.prefetch_size,
            non_blocking=inner.non_blocking,
        )
        self.inner = inner
        self.inner.device_placement = False  # the reader loads on the host; this loader places

    @property
    def total_batch_size(self) -> int:
        return self.inner.total_batch_size

    @property
    def total_dataset_length(self) -> int:
        return self.inner.total_dataset_length

    def __len__(self):
        return len(self.inner)  # TypeError for an iterable inner, as for torch

    def set_epoch(self, epoch: int):
        self.inner.set_epoch(epoch)

    def state_dict(self) -> dict:
        state = self.inner.state_dict()
        state["batches_yielded"] = self.batches_yielded
        return state

    def load_state_dict(self, state: dict):
        self.inner.load_state_dict(state)
        self.batches_yielded = state.get("batches_yielded", 0)

    def __iter__(self):
        self.begin()
        self.batches_yielded = self.inner.skip_batches
        try:
            for batch in self.inner:
                self.end_of_dataloader = self.inner.end_of_dataloader
                self.remainder = self.inner.remainder
                self.batches_yielded += 1
                yield self._place(batch)
            self.batches_yielded = 0
        finally:
            self.inner.skip_batches = 0
            self.end()


def _device_for_batches(device) -> torch.device:
    """``device``, else the Accelerator's, else the card (raising without
    one): a loader never settles for the CPU because no card was found."""
    if device is not None:
        return resolve_device(device)
    state = AcceleratorState._shared_state
    if state.get("_initialized"):
        return state["partial_state"].device
    return resolve_device(None)


def prepare_data_loader(
    dataloader,
    device=None,
    num_processes: Optional[int] = None,
    process_index: Optional[int] = None,
    split_batches: bool = False,
    put_on_device: bool = True,
    rng_types: Optional[list] = None,
    dispatch_batches: Optional[bool] = None,
    even_batches: bool = True,
    use_seedable_sampler: bool = True,
    seed: int = 0,
    data_loader_config: Optional[DataLoaderConfiguration] = None,
    batch_size: Optional[int] = None,
    shuffle: bool = False,
    collate_fn: Optional[Callable] = None,
    drop_last: bool = False,
):
    """A loader over ``dataloader``: an already prepared loader (returned as
    it is), a ``torch.utils.data.DataLoader`` (its dataset, batch size,
    collate function, ``drop_last`` and shuffling are taken over), an
    indexable dataset, or an iterable of samples. With ``put_on_device``
    batches land on ``device`` (default: the Accelerator's device, else
    the card). ``num_processes`` and ``process_index`` above one process
    raise: multi-process loading is ROADMAP.md Queue 1 item 8."""
    if (num_processes or 1) != 1 or (process_index or 0) != 0:
        raise NotImplementedError(
            f"prepare_data_loader(num_processes={num_processes}, process_index={process_index}): "
            "accelerate_tpu_torch loads for one process; multi-process loading is ROADMAP.md Queue 1 item 8"
        )
    prefetch_size, non_blocking = 2, True
    if data_loader_config is not None:
        split_batches = data_loader_config.split_batches
        dispatch_batches = data_loader_config.dispatch_batches
        even_batches = data_loader_config.even_batches
        use_seedable_sampler = data_loader_config.use_seedable_sampler
        prefetch_size = data_loader_config.prefetch_size
        non_blocking = data_loader_config.non_blocking

    if isinstance(dataloader, BaseDataLoader):
        return dataloader

    if isinstance(dataloader, torch.utils.data.DataLoader):
        torch_loader = dataloader
        batch_size = torch_loader.batch_size if batch_size is None else batch_size
        drop_last = torch_loader.drop_last
        shuffle = isinstance(torch_loader.sampler, torch.utils.data.RandomSampler)
        if torch_loader.collate_fn is not torch.utils.data.default_collate:
            collate_fn = torch_loader.collate_fn
        dataloader = torch_loader.dataset

    common = dict(
        batch_size=1 if batch_size is None else batch_size,
        collate_fn=collate_fn,
        drop_last=drop_last,
        even_batches=even_batches,
        split_batches=split_batches,
        device=_device_for_batches(device) if put_on_device else None,
        device_placement=put_on_device,
        prefetch_size=prefetch_size,
        non_blocking=non_blocking,
    )
    if hasattr(dataloader, "__len__") and hasattr(dataloader, "__getitem__"):
        sampler = None
        if shuffle and not use_seedable_sampler:
            sampler = SeedableRandomSampler(len(dataloader), seed=int(np.random.randint(0, 2**31)))
        loader = DataLoaderShard(
            dataloader, shuffle=shuffle, seed=seed, sampler=sampler, rng_types=rng_types, **common
        )
    else:
        loader = IterableDataLoaderShard(dataloader, **common)
    if dispatch_batches:
        loader = DataLoaderDispatcher(loader)
    return loader


def skip_first_batches(dataloader, num_batches: int = 0):
    """Skip the first ``num_batches`` batches of the loader's next pass (a
    resume mid-epoch); returns the loader."""
    if isinstance(dataloader, DataLoaderDispatcher):
        dataloader.inner.skip_batches = num_batches
        return dataloader
    if isinstance(dataloader, BaseDataLoader):
        dataloader.skip_batches = num_batches
        return dataloader
    raise TypeError("skip_first_batches expects a loader returned by prepare()/prepare_data_loader()")
