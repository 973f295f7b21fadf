"""Releasing device memory: the part of :mod:`accelerate_tpu.utils.memory`
that ``Accelerator.free_memory`` needs. The batch-size finder and the
memory estimates wait for ROADMAP.md Queue 1 item 8."""

from __future__ import annotations

import gc

import torch


def clear_device_cache(garbage_collection: bool = False) -> None:
    """Hand the caching allocator's free blocks back to the card (a no-op
    without one); ``garbage_collection`` runs a collector pass first, for
    tensors held only by reference cycles."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references to ``objects`` (a list of them counts as the
    objects), collect and clear the device cache. Returns one ``None`` per
    object, for the caller to rebind: ``a, b = release_memory(a, b)``."""
    if len(objects) == 1 and isinstance(objects[0], list):
        objects = objects[0]
    objects = [None] * len(objects)
    clear_device_cache(garbage_collection=True)
    return objects
