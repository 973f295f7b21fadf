"""Read and write the safetensors format by hand.

The format (https://github.com/huggingface/safetensors): an 8-byte
little-endian header length N, N bytes of JSON mapping each tensor name
to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
data that follows) plus an optional ``"__metadata__"`` of strings (the
reader skips it; the writer writes none), then the tensors' raw
little-endian bytes. This module writes and reads it for
the dtypes the port holds, so ``save_model`` exports and checkpoints need
no ``safetensors`` package; a file either writes loads in the other.
The writer orders tensors by element size (largest first), so every
tensor starts at a multiple of its element size, and pads the header
with spaces to a multiple of 8 bytes, as the reference writer does.
"""

from __future__ import annotations

import json
import os
import struct
import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}


def save_file(tensors: dict, path) -> None:
    """Write ``{name: tensor}`` (CPU tensors) to ``path``."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code in this writer ({sorted(DTYPES)})")
        if t.device.type != "cpu":
            raise ValueError(f"{name}: save_file takes CPU tensors, got one on {t.device}")
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: dict = {}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].contiguous()
            if t.numel():
                f.write(memoryview(t.view(-1).view(torch.uint8).numpy()))


def load_file(path) -> dict:
    """``{name: tensor}`` on the CPU from a safetensors file. The tensors
    are views of one buffer holding the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    header.pop("__metadata__", None)
    out = {}
    for name, rec in header.items():
        if rec["dtype"] not in DTYPES:
            raise ValueError(f"{name}: safetensors dtype {rec['dtype']} is not read here ({sorted(DTYPES)})")
        dtype, shape = DTYPES[rec["dtype"]], rec["shape"]
        begin, end = rec["data_offsets"]
        count = 1
        for d in shape:
            count *= d
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: {name} has data_offsets {rec['data_offsets']} for shape {shape} "
                             f"{rec['dtype']} in {len(data)} data bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=begin)
        if begin % size:  # a writer that does not align: copy out to an aligned buffer
            flat = flat.clone()
        out[name] = flat.view(dtype).view(shape)
    return out
