"""Per-card constants of the kernel analyzer: shared memory a block can use.

Counterpart of :data:`accelerate_tpu.analysis.costmodel.VMEM_KB_TABLE` and
``device_generation``/``vmem_bytes``. A Pallas block must fit a core's
VMEM; a CUDA block must fit the shared memory one block may ask for. The
TPU rows do not carry over. With a card attached the capacity is the
card's own, ``torch.cuda.get_device_properties(i).shared_memory_per_block_optin``.
A trace without a card is judged against the H100's row: a block may use
227 KB (232,448 bytes) of the SM's 256 KB, above 48 KB only as dynamic
shared memory after ``cudaFuncSetAttribute(...,
cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` (NVIDIA's Hopper
tuning guide).
"""

from __future__ import annotations

from typing import Optional

#: shared memory one block may ask for, in bytes, by card
SMEM_BYTES_TABLE: dict = {"h100": 232_448}

#: the row a trace without a card is judged against
DEFAULT_GENERATION = "h100"


def device_generation(device_index: int = 0) -> Optional[str]:
    """``"h100"`` for an attached H100, the card's own name in lower case
    for another card, None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_properties(device_index).name.lower()
    return next((gen for gen in SMEM_BYTES_TABLE if gen in name), name)


def smem_bytes(generation: Optional[str] = None, device_index: int = 0) -> int:
    """Shared memory a block may ask for. ``generation=None``: the attached
    card's per-block opt-in maximum, the H100 row without a card; a named
    generation: its row of :data:`SMEM_BYTES_TABLE`."""
    if generation is None:
        import torch

        if torch.cuda.is_available():
            return int(torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin)
        generation = DEFAULT_GENERATION
    if generation not in SMEM_BYTES_TABLE:
        raise ValueError(f"no shared-memory row for {generation!r}; the table has {sorted(SMEM_BYTES_TABLE)}")
    return int(SMEM_BYTES_TABLE[generation])
