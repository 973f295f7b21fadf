"""Structure-preserving operations on nested batches, and the host-level
collectives.

Counterpart of :mod:`accelerate_tpu.utils.operations`, one process. A
batch is any nesting of dicts, lists and tuples (named tuples too) whose
leaves are tensors or numpy arrays; every operation keeps the nesting and
acts on the array leaves. The collectives (``gather``, ``gather_object``,
``broadcast``, ``broadcast_object_list``, ``scatter_object``, ``reduce``,
``pad_across_processes``) run across processes; with the one process the
port runs they return their input (``reduce`` then multiplies by
``scale``). Multi-process collectives are ROADMAP.md Queue 1 item 8.

With ``ACCELERATE_DEBUG_MODE=1`` every collective first compares the
structure each process passes and raises
:class:`DistributedOperationException` on a mismatch.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from collections.abc import Mapping
from typing import Any, Callable, Optional

import numpy as np
import torch


class DistributedOperationException(Exception):
    """Raised in debug mode when processes pass different structures to a
    collective."""


@dataclasses.dataclass(frozen=True)
class TensorInformation:
    """A leaf's shape and dtype, as :func:`get_data_structure` records it."""

    shape: tuple
    dtype: Any


def is_array_like(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _map(func: Callable, data):
    """``func`` over every leaf of ``data``, keeping dicts, lists and tuples."""
    if isinstance(data, Mapping):
        return type(data)({k: _map(func, v) for k, v in data.items()})
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # named tuple
        return type(data)(*(_map(func, v) for v in data))
    if isinstance(data, (list, tuple)):
        return type(data)(_map(func, v) for v in data)
    return func(data)


def _leaves(data):
    if isinstance(data, Mapping):
        for v in data.values():
            yield from _leaves(v)
    elif isinstance(data, (list, tuple)):
        for v in data:
            yield from _leaves(v)
    else:
        yield data


def recursively_apply(
    func: Callable,
    data: Any,
    *args,
    test_type: Callable = is_array_like,
    error_on_other_type: bool = False,
    **kwargs,
):
    """``func(leaf, *args, **kwargs)`` on every leaf of ``data`` that passes
    ``test_type``; other leaves pass through, or raise ``TypeError`` with
    ``error_on_other_type``."""

    def apply(leaf):
        if test_type(leaf):
            return func(leaf, *args, **kwargs)
        if error_on_other_type:
            raise TypeError(f"Unsupported type {type(leaf)} passed to {getattr(func, '__name__', func)}")
        return leaf

    return _map(apply, data)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def send_to_device(tensor: Any, device=None, non_blocking: bool = True, skip_keys=None):
    """Move every array leaf to ``device`` as a tensor (numpy leaves become
    tensors). A host tensor bound for a CUDA device is copied from pinned
    memory, without waiting when ``non_blocking``. ``skip_keys`` names
    top-level dict entries left where they are."""
    device = torch.device(device) if device is not None else None

    def put(leaf):
        leaf = _as_tensor(leaf)
        if device is None or leaf.device == device:
            return leaf
        if device.type == "cuda" and leaf.device.type == "cpu" and non_blocking:
            return leaf.pin_memory().to(device, non_blocking=True)
        return leaf.to(device, non_blocking=non_blocking)

    if skip_keys and isinstance(tensor, Mapping):
        return type(tensor)(
            {k: (v if k in skip_keys else send_to_device(v, device, non_blocking)) for k, v in tensor.items()}
        )
    return recursively_apply(put, tensor)


def get_data_structure(data):
    """The shape and dtype of every array leaf (:class:`TensorInformation`)."""
    return recursively_apply(lambda x: TensorInformation(tuple(x.shape), x.dtype), data)


def initialize_tensors(data_structure):
    """Zeros in the place of every :class:`TensorInformation` leaf."""

    def init(x):
        if isinstance(x.dtype, torch.dtype):
            return torch.zeros(x.shape, dtype=x.dtype)
        return np.zeros(x.shape, x.dtype)

    return recursively_apply(init, data_structure, test_type=lambda x: isinstance(x, TensorInformation))


def find_batch_size(data) -> Optional[int]:
    """The leading dimension of the first array leaf that has one."""
    for leaf in _leaves(data):
        if is_array_like(leaf) and len(leaf.shape) >= 1:
            return leaf.shape[0]
    return None


def slice_tensors(data, tensor_slice, process_index=None, num_processes=None):
    """``leaf[tensor_slice]`` for every array leaf."""
    return recursively_apply(lambda x: x[tensor_slice], data)


def concatenate(data: list, dim: int = 0):
    """Concatenate a list of batches of the same nesting, leaf by leaf."""
    first = data[0]
    if isinstance(first, (list, tuple)):
        return type(first)(concatenate([d[i] for d in data], dim=dim) for i in range(len(first)))
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first})
    if not is_array_like(first):
        raise TypeError(f"Can only concatenate arrays/dicts/lists, got {type(first)}")
    if any(isinstance(x, torch.Tensor) for x in data):
        return torch.cat([_as_tensor(x) for x in data], dim=dim)
    return np.concatenate([np.asarray(x) for x in data], axis=dim)


def convert_to_fp32(tensor):
    """Every floating leaf that is not f32 becomes f32."""

    def upcast(x):
        if isinstance(x, torch.Tensor):
            return x.float() if x.is_floating_point() and x.dtype != torch.float32 else x
        if np.issubdtype(x.dtype, np.floating) and x.dtype != np.float32:
            return np.asarray(x, dtype=np.float32)
        return x

    return recursively_apply(upcast, tensor)


class ConvertOutputsToFp32:
    """A callable that casts the floating outputs of ``model_forward`` to f32."""

    def __init__(self, model_forward):
        self.model_forward = model_forward
        functools.update_wrapper(self, model_forward)

    def __call__(self, *args, **kwargs):
        return convert_to_fp32(self.model_forward(*args, **kwargs))


def convert_outputs_to_fp32(model_forward):
    return ConvertOutputsToFp32(model_forward)


# ---------------------------------------------------------------------------
# Host-level collectives
# ---------------------------------------------------------------------------


def _num_processes() -> int:
    """Processes in the run: the port runs one (``PartialState``)."""
    return 1


def _verify_operation(func):
    """In debug mode (``ACCELERATE_DEBUG_MODE=1``) compare the structure
    every process passes before the collective runs."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if os.environ.get("ACCELERATE_DEBUG_MODE", "").lower() in ("1", "true", "yes"):
            data = args[0] if args else kwargs.get("tensor")
            skeletons = gather_object([repr(get_data_structure(data))])
            if len(set(skeletons)) != 1:
                report = "\n".join(f"  process {i}: {s}" for i, s in enumerate(skeletons))
                raise DistributedOperationException(
                    f"Mismatched inputs to `{func.__name__}` across processes:\n{report}"
                )
        return func(*args, **kwargs)

    return wrapper


@_verify_operation
def gather(tensor):
    """Every process's array leaves, concatenated along dim 0."""
    return recursively_apply(lambda x: x, tensor)


def gather_object(object_list: list):
    """Every process's list of python objects, as one list."""
    return list(object_list)


@_verify_operation
def broadcast(tensor, from_process: int = 0):
    """Process ``from_process``'s array leaves, on every process."""
    return tensor


def broadcast_object_list(object_list: list, from_process: int = 0):
    """Process ``from_process``'s objects, written into ``object_list`` in
    place on every process; returns the list."""
    return object_list


def scatter_object(objects, from_process: int = 0):
    """``objects[p]`` to process ``p``: this process's item."""
    if objects is None or len(objects) != _num_processes():
        raise ValueError(f"scatter_object needs a list of {_num_processes()} payloads on the source process")
    return objects[0]


@_verify_operation
def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The sum (``reduction="sum"``) or mean (``"mean"``) of every process's
    array leaves, times ``scale``."""
    return recursively_apply(lambda x: x * scale, tensor)


@_verify_operation
def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Pad every leaf along ``dim`` to the largest size any process has,
    with ``pad_index``: with one process, the leaves' own sizes."""
    return recursively_apply(lambda x: x, tensor)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Pad every leaf along ``dim`` to a multiple of ``num_processes`` with
    its own first rows (repeated when the leaf has fewer rows than the pad)."""

    def pad(x):
        extra = -x.shape[dim] % num_processes
        if extra == 0:
            return x
        rows = np.arange(extra) % x.shape[dim]
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.index_select(dim, torch.as_tensor(rows, device=x.device))], dim=dim)
        return np.concatenate([x, np.take(x, rows, axis=dim)], axis=dim)

    return recursively_apply(pad, tensor)
