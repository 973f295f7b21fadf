"""Per-card constants (shared memory a block can use, peak FLOP/s,
device memory, the KV handoff's transport rate) and the serving fleet's
pricing of KV handoffs and failovers.

Counterpart of :data:`accelerate_tpu.analysis.costmodel.VMEM_KB_TABLE`,
``PEAK_FLOPS_TABLE``, ``HBM_GB_TABLE`` and ``device_generation`` /
``vmem_bytes`` / ``peak_flops``. A Pallas block must fit a core's
VMEM; a CUDA block must fit the shared memory one block may ask for. The
TPU rows do not carry over. With a card attached the capacity is the
card's own, ``torch.cuda.get_device_properties(i).shared_memory_per_block_optin``.
A trace without a card is judged against the H100's row: a block may use
227 KB (232,448 bytes) of the SM's 256 KB, above 48 KB only as dynamic
shared memory after ``cudaFuncSetAttribute(...,
cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` (NVIDIA's Hopper
tuning guide).

:func:`price_kv_handoff`, :func:`prefill_compute_us` and
:func:`price_failover` keep the JAX package's formulas. Their transport
rate is the port's own: a fleet's replicas share one card, and a
handoff's payload leaves the device as host tensors and comes back, so a
handoff is priced at the device-to-host plus host-to-device round trip
(:data:`HANDOFF_BW_TABLE`). The bytes never depend on the table:
predicted bytes equal the bytes a router moves, exactly.
"""

from __future__ import annotations

from typing import Optional

#: shared memory one block may ask for, in bytes, by card
SMEM_BYTES_TABLE: dict = {"h100": 232_448}

#: dense peak FLOP/s by card and compute type, no sparsity: the H100 SXM
#: datasheet's 989.4 TFLOP/s bf16 tensor-core and 1,978.9 TOPS int8. The
#: shared denominator of MFU (:mod:`..telemetry.mfu`).
PEAK_FLOPS_TABLE: dict = {"h100": {"bf16": 989.4e12, "int8": 1978.9e12}}

#: device memory by card, GB (the H100 SXM's 80)
HBM_GB_TABLE: dict = {"h100": 80.0}

#: the row a trace without a card is judged against
DEFAULT_GENERATION = "h100"

#: the KV handoff's rate by card, bytes/s: a payload's bytes over
#: the time of its device-to-host copy plus its host-to-device copy, both
#: through pageable host memory. H100 (NVIDIA H100 80GB HBM3, 700.00 W):
#: ``scripts/torch_handoff_rate.py`` at 1,280 TinyLlama rows, 28,835,928
#: bytes in 9.48 ms out and 4.74 ms back (1.68-2.43e9 over 64-2,048 rows)
HANDOFF_BW_TABLE: dict = {"h100": 2.028e9}


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


def peak_flops(generation: str, dtype: str = "bf16") -> float:
    """Peak FLOP/s of one card of ``generation``; a card without a row
    falls back to the H100's, and a type without a column to bf16."""
    row = PEAK_FLOPS_TABLE.get(generation, PEAK_FLOPS_TABLE[DEFAULT_GENERATION])
    return row.get(dtype, row["bf16"])


def price_kv_handoff(
    bytes_per_token: int,
    tokens: int,
    *,
    fixed_bytes: int = 0,
    generation: str = DEFAULT_GENERATION,
) -> dict:
    """Price one prefill -> decode KV handoff BEFORE it happens: ``tokens``
    rows of every layer's K/V (``bytes_per_token`` each) plus
    ``fixed_bytes`` of per-layer write indices, at the card's host round
    trip rate (a card without a row is priced at the H100's). Returns
    ``{"bytes", "time_us"}``; a router's accounting of the bytes it moved
    must equal ``bytes`` exactly."""
    total = int(bytes_per_token) * int(tokens) + int(fixed_bytes)
    bw = HANDOFF_BW_TABLE.get(generation, HANDOFF_BW_TABLE[DEFAULT_GENERATION])
    return {"bytes": int(total), "time_us": total / bw * 1e6}


def prefill_compute_us(
    param_count: int, tokens: int, *, generation: str = DEFAULT_GENERATION, dtype: str = "bf16"
) -> float:
    """Lower bound of (re)prefilling ``tokens`` through a
    ``param_count``-parameter decoder: ``2 P T`` FLOPs over the card's
    peak (:data:`PEAK_FLOPS_TABLE`). The router's alternative to a
    handoff: if shipping the rows beats even the best-case local prefill,
    shipping wins."""
    return 2.0 * int(param_count) * int(tokens) / peak_flops(generation, dtype) * 1e6


def price_failover(
    bytes_per_token: int,
    prompt_tokens: int,
    generated_tokens: int,
    param_count: int,
    *,
    fixed_bytes: int = 0,
    generation: str = DEFAULT_GENERATION,
    dtype: str = "bf16",
    kv_exportable: bool = True,
) -> dict:
    """Price both legs of moving one in-flight request off a failing
    replica BEFORE anything moves: ship its KV frontier (``prompt +
    generated - 1`` rows: the last generated token is fed again, its row
    not yet written) or recompute the same rows on the survivor. Returns
    ``{"rows", "handoff"`` (a :func:`price_kv_handoff` dict)``,
    "recompute_us", "path"}`` with ``path`` the cheaper leg, forced to
    ``"recompute"`` when the failing replica cannot export
    (``kv_exportable=False``: poisoned numerics, or a paged or speculative
    layout). When the handoff leg runs, the moved bytes equal
    ``handoff["bytes"]`` exactly."""
    rows = max(1, int(prompt_tokens) + max(0, int(generated_tokens) - 1))
    pred = price_kv_handoff(bytes_per_token, rows, fixed_bytes=fixed_bytes, generation=generation)
    alt = prefill_compute_us(param_count, rows, generation=generation, dtype=dtype)
    path = "recompute" if not kv_exportable or pred["time_us"] > alt else "handoff"
    return {"rows": rows, "handoff": pred, "recompute_us": alt, "path": path}
