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
from .launch import LaunchSite, TileSpec, count_launch, record
from .tickets import tickets

#: rows of the tiled operand a block owns
BLOCK_ROWS = 8
# geometry of csrc/reference_kernels.cu. The launch sites below are the
# launches' only declaration: each wrapper passes its site's grid and
# threads to the kernel library, which refuses a declaration its kernel
# cannot run (the logits pass's 128 threads, 128 columns and 8 rows are
# compiled in).
_LOGIT_COLS = 128  # columns a block of the logits pass owns
_LOGIT_THREADS = 128
_STAGES = 4  # stages of the logits pass's ring
_X_ROW_BYTES = 128  # bytes of an x row a stage holds: its depth is 128 / itemsize contraction rows
_RING_PAD = 16  # bytes after every ring row
_TILE_PITCH = _LOGIT_COLS + 4  # floats a row of the block's logits tile
_NORM_COLS = 1024  # columns a block of the normalise pass owns
_H100_SMS = 132
_TARGET_BLOCKS = _H100_SMS  # the logits grid splits the contraction until it has a block an SM
_MIN_SPLIT_CHUNKS = _STAGES  # a split streams at least a ring's worth of stages
_ACC_THREADS = 256  # threads a block of the accumulate kernel, a 16-byte vector each

# Kernel launches since import (or since a caller reset them to 0).
launches_matmul_softmax = 0
launches_accumulate = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _itemsize(t) -> int:
    return torch.empty((), dtype=t.dtype).element_size()


def _depth(itemsize: int) -> int:
    """Contraction rows of one ring stage (64 in 16 bits, 32 in f32)."""
    return _X_ROW_BYTES // itemsize


def _softmax_plan(x, w) -> tuple:
    """``(row_blocks, splits, tiles, split_rows)`` of the logits pass: 8-row
    blocks, 128-column tiles, and the contraction cut into ``splits`` runs
    of ``split_rows`` (whole stages; the last may be shorter), as many as
    bring the grid to a block for each of the H100's 132 SMs while every
    split keeps at least four stages. At the decode-logits shape the 250
    tiles take no split: more splits measured slower there on the H100
    (``scripts/torch_reference_variants.py``, PERF.md)."""
    (b, d), n = x.shape, w.shape[1]
    depth = _depth(_itemsize(w))
    tiles, row_blocks = -(-n // _LOGIT_COLS), b // BLOCK_ROWS
    chunks = -(-d // depth)
    want = max(1, min(chunks // _MIN_SPLIT_CHUNKS, -(-_TARGET_BLOCKS // (tiles * row_blocks))))
    per = -(-chunks // want)
    return row_blocks, -(-chunks // per), tiles, per * depth


def _softmax_flops(x, w) -> float:
    """``2 B D N`` (the product) + ``14 B N`` (max, subtract, exp counted
    as 10, sum, divide): the reference's count, term for term."""
    (b, d), n = x.shape, w.shape[1]
    return 2.0 * b * d * n + 14.0 * b * n


def _softmax_hbm_bytes(x, w) -> float:
    """``w`` once for every 8 rows; ``x`` once for every 128-column tile;
    with splits, each split's partial logits written and read back by the
    joining block; the f32 logits written, read again and overwritten by
    the normalise pass; the tile maxima and sums written once and read by
    every normalise block of their row."""
    (b, d), n = x.shape, w.shape[1]
    _, splits, tiles, _ = _softmax_plan(x, w)
    norm_blocks = -(-n // _NORM_COLS)
    partials = (2 * splits - 1) * b * n * 4 if splits > 1 else 0
    return float(
        (b // BLOCK_ROWS) * d * n * _itemsize(w)
        + tiles * b * d * _itemsize(x)
        + partials
        + 3 * b * n * 4
        + 2 * b * tiles * 4 * (1 + norm_blocks)
    )


def _softmax_smem(x, w) -> float:
    """The logits block's dynamic shared memory: four ring stages (``KD``
    rows of 128 columns of w and the 8 x ``KD`` block of x, each row padded
    by 16 bytes), the f32 logits tile [8][132], the row reductions [8][4],
    the join's flag (16 bytes)."""
    item = _itemsize(w)
    depth = _depth(item)
    stage = depth * (_LOGIT_COLS * item + _RING_PAD) + BLOCK_ROWS * (_X_ROW_BYTES + _RING_PAD)
    return float(_STAGES * stage + BLOCK_ROWS * _TILE_PITCH * 4 + BLOCK_ROWS * (_LOGIT_THREADS // 32) * 4 + 16)


def _softmax_copy_bytes(x, w) -> int:
    """Bytes one copy of the ring moves: the largest of 16, 8, 4 that
    divides a row of w and of x and both pointers, else 2 (16-bit rows of
    odd length); 16 at the decode-logits shape, 8 for w (300, 1500) in
    bf16."""
    item = _itemsize(w)
    (_, d), n = x.shape, w.shape[1]
    for vec in (16, 8, 4):
        if not (n * item % vec or d * item % vec or x.data_ptr() % vec or w.data_ptr() % vec):
            return vec
    return 2  # 16-bit rows of odd length


def block_matmul_softmax_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``softmax(x @ w, axis=-1)`` in plain torch: the product of the
    operands widened to f32 (exact for bf16 and fp16 values), the softmax
    as the kernel body writes it. Returns f32 ``[B, N]``."""
    logits = x.float() @ w.float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_site(x, w) -> LaunchSite:
    """The logits pass as ``csrc/reference_kernels.cu`` launches it: grid
    ``(B / 8, splits, ceil(N / 128))`` (:func:`_softmax_plan`), 128
    threads; block ``(r, s, t)`` streams rows ``8r..8r+7`` of x and column
    tile ``t`` of w over split ``s`` of the contraction through its ring.
    With one split it writes its logits tile; with more, every block writes
    its partial tile and the block that takes the tile's last ticket reads
    the other splits' and writes the logits tile: declared here as the last
    split (which split joins is settled on the card, one block a tile). Its
    shared memory is the dynamic scratch of :func:`_softmax_smem`; the
    normalise pass, which rereads and rewrites the logits, is priced in the
    contract and not declared here."""
    (b, d), n = x.shape, w.shape[1]
    row_blocks, splits, tiles, split_rows = _softmax_plan(x, w)
    last = splits - 1

    def joined(rows, split, tile):
        return [(rows, tile)] if split == last else []

    outs = [TileSpec("out", (BLOCK_ROWS, _LOGIT_COLS), (b, n), torch.float32, joined)]
    ins = [TileSpec("x", (BLOCK_ROWS, split_rows), (b, d), x.dtype, lambda rows, split, tile: (rows, split)),
           TileSpec("w", (split_rows, _LOGIT_COLS), (d, n), w.dtype, lambda rows, split, tile: (split, tile))]
    if splits > 1:
        part = ((1, BLOCK_ROWS, _LOGIT_COLS), (splits, b, n), torch.float32)
        outs.append(TileSpec("partials", *part, lambda rows, split, tile: (split, rows, tile)))
        ins.append(TileSpec("partials", *part, lambda rows, split, tile:
                            [(s, rows, tile) for s in range(last)] if split == last else []))
    return LaunchSite(
        "block_matmul_softmax", (row_blocks, splits, tiles), _LOGIT_THREADS, ins=tuple(ins), outs=tuple(outs),
        smem_scratch=int(_softmax_smem(x, w)), plain=block_matmul_softmax_plain, operands=(x, w),
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
    notes="fused block matmul + row softmax (decode logits step): w streamed through a cp.async ring, "
    "tensor-core products in 16 bits, splits joined by ticket, then a normalise pass",
)
def block_matmul_softmax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``softmax(x [B, D] @ w [D, N], axis=-1)`` as f32 ``[B, N]``; ``B``
    must divide by 8. CPU tensors take the plain version; CUDA tensors
    launch the two passes built from ``csrc/reference_kernels.cu``, whose
    ring copies ``_softmax_copy_bytes`` at a time: 16 bytes where the rows
    and pointers allow, fewer for ragged rows, never the plain version."""
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
    (row_blocks, splits, tiles), split_rows = site.grid, site.ins[1].tile[0]
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    # one buffer: the splits' partial logits (none with one split), then the tile maxima and sums
    parts = splits * b * n if splits > 1 else 0
    scratch = torch.empty(parts + 2 * b * tiles, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = tickets(x.device, stream, row_blocks * tiles).data_ptr() if splits > 1 else None
    err = lib.block_matmul_softmax(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr() if parts else None,
        scratch[parts:].data_ptr(), scratch[parts + b * tiles:].data_ptr(), counters, _DTYPE_CODES[x.dtype],
        b, d, n, row_blocks, splits, split_rows // _depth(_itemsize(w)), tiles, site.threads,
        _softmax_copy_bytes(x, w), stream,
    )
    if err != 0:
        raise RuntimeError(f"block_matmul_softmax kernel launch failed: cudaError {err}")
    count_launch(globals(), "launches_matmul_softmax")
    return out


def _acc_flops(acc, delta) -> float:
    b, n = acc.shape
    return float(b * n)  # one add per element


def _acc_hbm_bytes(acc, delta) -> float:
    b, n = acc.shape
    return float(3 * b * n * _itemsize(acc))  # read acc + delta, write acc


def _accumulate_site(acc, delta) -> LaunchSite:
    """The launch over the flattened operands: 256 threads a block, one
    16-byte vector a thread (a tile of ``256 x 16`` bytes), a block for
    each tile; block ``b`` reads tile ``b`` of acc and delta into registers
    and writes tile ``b`` of acc (aliased in place). The last tile may be
    partial; the scalar tail, under 16 bytes, lies in it."""
    numel = acc.numel()
    tile_elems = _ACC_THREADS * (16 // _itemsize(acc))
    blocks = -(-numel // tile_elems)

    def tile(name):
        return TileSpec(name, (tile_elems,), (numel,), acc.dtype, lambda block: (block,))

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
    notes="in-place accumulation (a 16-byte pair a thread, the whole call in one grid)",
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
    count_launch(globals(), "launches_accumulate")
    return acc
