"""The two contract-bearing reference kernels: wrappers and plain versions.

Counterpart of :mod:`accelerate_tpu.kernels.reference`. Two deliberately
minimal kernels, each registered with a
:class:`~accelerate_tpu_torch.kernels.contracts.KernelCostSpec`:

* :func:`block_matmul_softmax`: ``softmax(x @ w, axis=-1)`` in f32, the
  decode-step logits shape. Its declared FLOPs are the reference's
  (``2 B D N`` for the product plus ``14 B N`` for the softmax);
* :func:`block_accumulate`: ``acc += delta`` in place (the reference
  aliases its input to its output; the port writes into ``acc`` and
  returns it).

The declared HBM bytes are what the CUDA design moves
(``csrc/reference_kernels.cu``), and ``smem_bytes`` holds the shared
memory one block asks for, where the reference declares the TPU's
``vmem_peak_bytes``. Rows divide by :data:`BLOCK_ROWS`, as there. On a
CUDA tensor each wrapper launches its hand-written kernel or raises; on a
CPU tensor it computes its plain version; on a ``meta`` tensor under
``kernel_check`` it records its launch site (grid, tiles, index maps,
shared memory; :mod:`.launch`), which the analyzer holds to the contract:
both kernels are its clean twins.
"""

from __future__ import annotations

import torch

from .contracts import kernel_cost
from .launch import LaunchSite, TileSpec, record

#: rows of the tiled operand a block owns
BLOCK_ROWS = 8
# geometry of csrc/reference_kernels.cu. The launch sites below are the
# launches' only declaration: each wrapper passes its site's grid and
# threads to the kernel library, which refuses a declaration its kernel
# cannot run (the logits pass's 128 threads and 8 rows are compiled in).
_LOGIT_COLS = 128  # columns a block of the logits pass owns, one a thread
_NORM_COLS = 1024  # columns a block of the normalise pass owns
_D_CHUNK = 512  # contraction rows of x staged in shared memory at a time
_ACC_THREADS = 256  # threads a block of the accumulate kernel
_ACC_MAX_BLOCKS = 132 * 16  # its grid-stride cap: 16 blocks an SM

# Kernel launches since import (or since a caller reset them to 0).
launches_matmul_softmax = 0
launches_accumulate = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _itemsize(t) -> int:
    return torch.empty((), dtype=t.dtype).element_size()


def _softmax_flops(x, w) -> float:
    """``2 B D N`` (the product) + ``14 B N`` (max, subtract, exp counted
    as 10, sum, divide): the reference's count, term for term."""
    (b, d), n = x.shape, w.shape[1]
    return 2.0 * b * d * n + 14.0 * b * n


def _softmax_hbm_bytes(x, w) -> float:
    """``w`` once for every 8 rows; ``x`` once for every 128-column tile;
    the f32 logits written, read again and overwritten by the normalise
    pass; the tile maxima and sums written once and read by every
    normalise block of their row."""
    (b, d), n = x.shape, w.shape[1]
    tiles, norm_blocks = -(-n // _LOGIT_COLS), -(-n // _NORM_COLS)
    return float(
        (b // BLOCK_ROWS) * d * n * _itemsize(w)
        + tiles * b * d * _itemsize(x)
        + 3 * b * n * 4
        + 2 * b * tiles * 4 * (1 + norm_blocks)
    )


def _softmax_smem(x, w) -> float:
    """The logits block: a chunk of x as f32 plus the row reductions."""
    return float(_D_CHUNK * BLOCK_ROWS * 4 + BLOCK_ROWS * (_LOGIT_COLS // 32) * 4)


def block_matmul_softmax_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``softmax(x @ w, axis=-1)`` in plain torch: the product of the
    operands widened to f32 (exact for bf16 and fp16 values), the softmax
    as the kernel body writes it. Returns f32 ``[B, N]``."""
    logits = x.float() @ w.float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_site(x, w) -> LaunchSite:
    """The logits pass as ``csrc/reference_kernels.cu`` launches it: grid
    ``(ceil(N / 128), B / 8)``, 128 threads; block ``(t, r)`` reads rows
    ``8r..8r+7`` of x and column tile ``t`` of w into registers and writes
    that tile of the logits. Its shared memory is static scratch: the f32
    chunk of x it stages, 512 contraction rows at a time, and the row
    reductions (:func:`_softmax_smem`). The normalise pass, which rereads
    and rewrites the logits, is priced in the contract and not declared
    here."""
    (b, d), n = x.shape, w.shape[1]
    return LaunchSite(
        "block_matmul_softmax", (-(-n // _LOGIT_COLS), b // BLOCK_ROWS), _LOGIT_COLS,
        ins=(TileSpec("x", (BLOCK_ROWS, d), (b, d), x.dtype, lambda tile, rows: (rows, 0)),
             TileSpec("w", (d, _LOGIT_COLS), (d, n), w.dtype, lambda tile, rows: (0, tile))),
        outs=(TileSpec("out", (BLOCK_ROWS, _LOGIT_COLS), (b, n), torch.float32, lambda tile, rows: (rows, tile)),),
        smem_scratch=int(_softmax_smem(x, w)),
        plain=block_matmul_softmax_plain, operands=(x, w),
    )


def _check_rows(rows: int) -> None:
    if rows % BLOCK_ROWS:
        raise ValueError(f"rows {rows} not divisible by block_rows {BLOCK_ROWS}")


def _check_cuda(tensors: dict) -> None:
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"the reference kernels run on cuda or cpu tensors, got {first.device}")
    for name, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; want {first.dtype} on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be one of {list(_DTYPE_CODES)}, got {first.dtype}")


@kernel_cost(
    flops=_softmax_flops,
    hbm_bytes=_softmax_hbm_bytes,
    smem_bytes=_softmax_smem,
    interval=lambda ins: (0.0, 1.0),  # row softmax: every output in [0, 1]
    notes="fused block matmul + row softmax (decode logits step), two passes over 128-column tiles",
)
def block_matmul_softmax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``softmax(x [B, D] @ w [D, N], axis=-1)`` as f32 ``[B, N]``; ``B``
    must divide by 8. CPU tensors take the plain version; CUDA tensors
    launch the two passes built from ``csrc/reference_kernels.cu``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want x [B, D] and w [D, N]; got {tuple(x.shape)}, {tuple(w.shape)}")
    b, d = x.shape
    n = w.shape[1]
    _check_rows(b)
    if x.device.type == "cpu":
        return block_matmul_softmax_plain(x, w)
    site = _softmax_site(x, w)
    if x.device.type == "meta":
        record(site)
        return torch.empty((b, n), dtype=torch.float32, device="meta")
    _check_cuda({"x": x, "w": w})
    from .build import load

    lib = load("reference_kernels")
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    tiles, row_blocks = site.grid
    scratch = torch.empty((2, b, tiles), dtype=torch.float32, device=x.device)  # tile maxima, tile sums
    err = lib.block_matmul_softmax(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        _DTYPE_CODES[x.dtype], b, d, n, tiles, row_blocks, site.threads,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"block_matmul_softmax kernel launch failed: cudaError {err}")
    global launches_matmul_softmax
    launches_matmul_softmax += 1
    return out


def _acc_flops(acc, delta) -> float:
    b, n = acc.shape
    return float(b * n)  # one add per element


def _acc_hbm_bytes(acc, delta) -> float:
    b, n = acc.shape
    return float(3 * b * n * _itemsize(acc))  # read acc + delta, write acc


def _accumulate_site(acc, delta) -> LaunchSite:
    """The launch over the flattened operands: 256 threads a block, 16-byte
    vectors, ``min(ceil(vectors / 256), 2112)`` blocks striding over chunks
    of 256 vectors; block ``b`` walks chunks ``b, b + blocks, ...`` of acc
    and delta through registers and writes the same chunks of acc (aliased
    in place). The scalar tail, under 16 bytes, lies in the last chunk."""
    numel = acc.numel()
    vec = 16 // _itemsize(acc)
    chunk = _ACC_THREADS * vec
    blocks = min(max(1, -(-(numel // vec) // _ACC_THREADS)), _ACC_MAX_BLOCKS)
    chunks = -(-numel // chunk)

    def walk(block):
        return [(c,) for c in range(block, chunks, blocks)]

    def tile(name):
        return TileSpec(name, (chunk,), (numel,), acc.dtype, walk)

    return LaunchSite(
        "block_accumulate", (blocks,), _ACC_THREADS, ins=(tile("acc"), tile("delta")), outs=(tile("acc"),),
        aliases=((0, 0),), plain=block_accumulate_plain, operands=(acc, delta),
    )


def block_accumulate_plain(acc: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``acc += delta`` in place in plain torch; returns ``acc``."""
    return acc.add_(delta)


@kernel_cost(
    flops=_acc_flops,
    hbm_bytes=_acc_hbm_bytes,
    smem_bytes=lambda acc, delta: 0.0,  # registers only
    interval=lambda ins: (ins[0][0] + ins[1][0], ins[0][1] + ins[1][1]),
    notes="in-place accumulation (16-byte loads, grid-stride)",
)
def block_accumulate(acc: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``acc [B, N] += delta [B, N]`` in place (one dtype; ``B`` must
    divide by 8); returns ``acc``. CPU tensors take the plain version; CUDA
    tensors launch the kernel built from ``csrc/reference_kernels.cu``."""
    if acc.dim() != 2 or acc.shape != delta.shape:
        raise ValueError(f"want acc and delta of one shape [B, N]; got {tuple(acc.shape)}, {tuple(delta.shape)}")
    _check_rows(acc.shape[0])
    if acc.device.type == "cpu":
        return block_accumulate_plain(acc, delta)
    if acc.device.type == "meta":
        if acc.numel():
            record(_accumulate_site(acc, delta))
        return acc
    _check_cuda({"acc": acc, "delta": delta})
    if acc.data_ptr() % 16 or delta.data_ptr() % 16:
        raise ValueError("acc and delta must be 16-byte aligned (the kernel reads them 16 bytes at a time)")
    if acc.numel() == 0:
        return acc
    from .build import load

    lib = load("reference_kernels")
    site = _accumulate_site(acc, delta)
    err = lib.block_accumulate(
        acc.data_ptr(), delta.data_ptr(), _DTYPE_CODES[acc.dtype], acc.numel(), site.blocks, site.threads,
        torch.cuda.current_stream(acc.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"block_accumulate kernel launch failed: cudaError {err}")
    global launches_accumulate
    launches_accumulate += 1
    return acc
