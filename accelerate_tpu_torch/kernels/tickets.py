"""Ticket counters for kernels that join their splits inside one launch.

K4 (``csrc/paged_attention.cu``) and K5 (``csrc/int4_matmul.cu``) cut a
call's work into splits that run as separate blocks. Each block takes a
ticket from an int32 counter of its output tile when its partial result is
published; the block that takes the last ticket joins the partials in split
order and puts the counter back to 0. So the counters are zeroed once, when
the buffer is made, and every launch leaves them at 0.

A buffer is kept for each (device, stream): launches on one stream run one
after another and can share counters; two streams never do. A buffer only
grows, by replacing it with a larger zeroed one; the old one returns to the
caching allocator behind the launches already queued on that stream.
"""

from __future__ import annotations

import torch

_MIN_COUNTERS = 1024
_BUFFERS: dict = {}


def tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """At least ``count`` zeroed int32 counters for launches on ``stream``
    (a raw ``cudaStream_t`` handle) of ``device``."""
    key = (device.index, stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, _MIN_COUNTERS), dtype=torch.int32, device=device)
        _BUFFERS[key] = buf
    return buf
