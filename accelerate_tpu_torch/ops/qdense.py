"""Quantized dense layer: weight-only int8 / w8a8 / int4 / nf4 for decode.

Counterpart of :mod:`accelerate_tpu.ops.qdense`. A :class:`QuantDense`
holds the packed integer codes as its parameters, in the layout of
:func:`..utils.quantization.quantize` (and of the JAX package, so
quantized weights carry across unchanged): ``qdata [n_groups, g, out]``
int8, or ``[n_groups, g/2, out]`` uint8 for the packed 4-bit methods, and
``qscale [n_groups, 1, out]`` f32. Groups tile the contraction dim and
rows are contiguous in ``out``. The parameters are not trainable.

Four methods, as in the reference:

* ``w8a8``: the activations are quantized per row to int8 too and the
  product runs on integers (``torch._int_mm`` on the card);
* per-channel ``int8``: the codes multiply as they are and the f32 product
  is scaled, then rounded once;
* grouped ``int4`` with ``group_size % 64 == 0`` and ``features % 128 ==
  0`` on a CUDA tensor: the hand-written fused kernel
  (:func:`..ops.qmatmul.int4_matmul`), which reads only the packed bytes;
* everything else (grouped int8, nf4, int4 on the CPU or at other shapes):
  dequantize to the stream dtype, then ``x @ w``.

The kernel and the dequantize path round differently (the kernel rounds x
to bf16 and keeps the scale in f32; the dequantize path rounds the decoded
weight to the stream dtype), as the reference's two paths do. Only the
int4 product is a hand-written kernel; the others are plain torch
products, as they are plain XLA products in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.quantization import grouped_dequantize
from .qmatmul import int4_matmul, int4_supported

_METHODS = ("int8", "w8a8", "int4", "nf4")


def _int8_product(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact ``int8 [M, in] @ int8 [in, out] -> int32``. ``torch._int_mm``
    wants more than 16 rows, so a decode batch is padded with zero rows."""
    if xq.device.type != "cuda":
        return xq.to(torch.int32) @ w8.to(torch.int32)
    m = xq.shape[0]
    rows = max(32, -(-m // 8) * 8)
    if rows != m:
        xq = torch.cat([xq, xq.new_zeros(rows - m, xq.shape[1])])
    return torch._int_mm(xq.contiguous(), w8)[:m]


class QuantDense(nn.Module):
    """Drop-in for a bias-free ``nn.Linear`` with a weight-only quantized
    kernel. Fresh parameters are zeros (codes) and ones (scales): meaningful
    values come from quantizing a float checkpoint
    (``load_and_quantize_model``) or from a state dict. ``dtype``: compute
    dtype (default: the input's)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        method: str = "int8",
        group_size: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        use_bias: bool = False,
    ):
        super().__init__()
        if method not in _METHODS:
            raise ValueError(f"method must be int8|w8a8|int4|nf4, got {method!r}")
        g = group_size or in_features
        if in_features % g != 0:
            raise ValueError(f"input dim {in_features} not divisible by group_size {g}")
        n_groups = in_features // g
        packed = method in ("int4", "nf4")
        if packed and g % 2 != 0:
            raise ValueError(f"group size {g} must be even for 4-bit packing")
        if method == "w8a8" and n_groups > 1:
            raise ValueError("w8a8 requires per-channel scales (group_size=None)")
        self.in_features, self.features, self.method, self.group_size, self.dtype = (
            in_features, features, method, group_size, dtype,
        )
        rows = g // 2 if packed else g
        qdata = torch.zeros(n_groups, rows, features, dtype=torch.uint8 if packed else torch.int8)
        self.qdata = nn.Parameter(qdata, requires_grad=False)
        self.qscale = nn.Parameter(torch.ones(n_groups, 1, features, dtype=torch.float32), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32), requires_grad=False) if use_bias else None

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, features={self.features}, method={self.method}, group_size={self.group_size}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            raise ValueError(f"input dim {x.shape[-1]} != in_features {self.in_features}")
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features)
        n_groups = self.qdata.shape[0]
        if self.method == "w8a8":
            # per-row dynamic activation quantization feeds an integer product
            x32 = x2.float()
            sx = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
            xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
            y32 = _int8_product(xq, self.qdata.reshape(self.in_features, self.features))
            y = (y32.float() * sx * self.qscale.reshape(-1)).to(dtype)
        elif self.method == "int8" and n_groups == 1:
            # per-channel: the scale commutes with the contraction and applies
            # to the f32 product (the operands are exact in f32), one rounding
            y = x2.float() @ self.qdata.reshape(self.in_features, self.features).float()
            y = (y * self.qscale.reshape(-1)).to(dtype)
        elif int4_supported(x2, self.method, self.group_size, n_groups, self.features):
            # fused dequantize + matmul kernel: the packed nibbles are the only weight bytes read
            y = int4_matmul(x2.contiguous(), self.qdata, self.qscale, group_size=self.group_size)
        else:
            wg = grouped_dequantize(self.qdata, self.qscale, self.method)
            y = x2 @ wg.reshape(self.in_features, self.features).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y.reshape(*lead, self.features)
