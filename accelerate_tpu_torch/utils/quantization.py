"""Weight-only quantization (int8 / w8a8 / int4 / nf4).

Counterpart of :mod:`accelerate_tpu.utils.quantization`. A quantized
weight is a :class:`QTensor`: packed integer ``data`` plus one f32 scale
per (group, output channel). Scales reduce over the **contraction** dim
(axis -2 of an ``[..., in, out]`` kernel), so a per-channel int8 product
may apply the scales after the integer product.

* int8 / w8a8 / int4 are symmetric linear codes; nf4 is the QLoRA
  codebook (:data:`NF4_CODE`).
* 4-bit codes are packed two to a byte along axis -2: byte row ``r``
  holds code ``2r`` in its low nibble and code ``2r + 1`` in its high one.
* :func:`quantize` keeps the JAX package's arithmetic order (``x / scale
  * 7.0``, round half to even, clip; nf4 by ``searchsorted`` over the code
  midpoints, left side), so the same float weights give the same codes in
  both packages.

The JAX package guards its nf4 decode against a fault of the TPU runtime
(``_nf4_guard``, active on the TPU backend only). The port has no such
limit: nf4 tensors of any size decode.

The fp8 half (:func:`fp8_quantize`, :func:`fp8_dot`) is the per-tensor
dynamic scaling of the fp8 mixed precision mode; the products themselves
live in :mod:`..ops.fp8`.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch.func import functional_call

# QLoRA NF4 codebook (16 quantiles of N(0,1), normalised to [-1, 1]).
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)


@dataclass
class QuantizationConfig:
    """What to quantize and how (the reference's ``QuantizationConfig``:
    same fields, defaults and validation)."""

    bits: int = 8  # 8 or 4
    # "int8" (weight-only) | "w8a8" (int8 activations too, per-channel
    # scales only) | "int4" | "nf4"
    method: Optional[str] = None  # default by bits
    group_size: Optional[int] = None  # None = one scale per output channel
    compute_dtype: str = "bfloat16"
    # leaves whose path matches any pattern stay un-quantized
    skip_patterns: tuple = ("embed", "lm_head", "norm", "bias", "scale")
    min_size: int = 4096  # don't bother with tiny leaves

    def __post_init__(self):
        if self.bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {self.bits}")
        if self.method is None:
            self.method = "int8" if self.bits == 8 else "nf4"
        if self.method not in ("int8", "w8a8", "int4", "nf4"):
            raise ValueError(f"method must be int8|w8a8|int4|nf4, got {self.method!r}")
        if self.method not in ("int8", "w8a8") and self.bits != 4:
            self.bits = 4
        elif self.method in ("int8", "w8a8") and self.bits != 8:
            # int8 stores unpacked 8-bit codes; bits=4 would give no saving
            raise ValueError(
                f'method="{self.method}" requires bits=8; use method="int4"/"nf4" for 4-bit'
            )
        if self.method == "w8a8" and self.group_size is not None:
            # the scale must commute past the whole contraction
            raise ValueError('method="w8a8" requires group_size=None (per-channel scales)')


@dataclass
class QTensor:
    """A quantized array: packed integer ``data`` + broadcastable f32
    ``scale``, with the original shape and dtype."""

    data: torch.Tensor  # int8 codes; for 4-bit, two codes packed per uint8 byte along axis -2
    scale: torch.Tensor
    shape: tuple  # original shape
    dtype: Any  # original dtype
    method: str
    group_size: Optional[int]

    @property
    def nbytes(self) -> int:
        return int(self.data.numel() * self.data.element_size() + self.scale.numel() * self.scale.element_size())

    def dequantize(self, dtype=None) -> torch.Tensor:
        return dequantize(self, dtype)


def _grouped(x: torch.Tensor, group_size: Optional[int]):
    """Reshape ``[..., in, out]`` so axis -3 indexes groups of the
    contraction dim: ``[..., n_groups, g, out]``."""
    n_in = x.shape[-2]
    g = n_in if group_size is None else group_size
    if n_in % g != 0:
        raise ValueError(f"contraction dim {n_in} not divisible by group_size {g}")
    return x.reshape(*x.shape[:-2], n_in // g, g, x.shape[-1]), g


def quantize(x: torch.Tensor, config: QuantizationConfig) -> QTensor:
    """Quantize one tensor. 1D tensors are treated as ``[in, 1]``."""
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    if x.dim() < 2:
        x = x[:, None]
    xg, _ = _grouped(x.float(), config.group_size)
    absmax = xg.abs().amax(dim=-2, keepdim=True)
    scale = absmax.clamp_min(1e-12)

    if config.method in ("int8", "w8a8"):
        q = torch.clamp(torch.round(xg / scale * 127.0), -127, 127).to(torch.int8)
        scale = scale / 127.0
    elif config.method == "int4":
        q = torch.clamp(torch.round(xg / scale * 7.0), -7, 7).to(torch.int8)
        scale = scale / 7.0
        q = _pack4(q + 8)  # store as unsigned nibbles
    else:  # nf4: nearest code by a search over the midpoints between codes
        mids = torch.from_numpy((NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0).to(xg.device)
        idx = torch.searchsorted(mids, (xg / scale).contiguous())
        q = _pack4(idx)
    # a strided input (a transposed nn.Linear weight) would hand its strides on; the kernel wants rows contiguous in out
    return QTensor(q.contiguous(), scale.float().contiguous(), orig_shape, orig_dtype, config.method, config.group_size)


def grouped_dequantize(data: torch.Tensor, scale: torch.Tensor, method: str) -> torch.Tensor:
    """Decode grouped codes ``[..., n_groups, g(, packed), out]`` + scales
    to f32 ``[..., n_groups, g, out]``: the one copy of the per-method
    decode, used by :func:`dequantize` and by ``QuantDense``."""
    if method in ("int8", "w8a8"):
        return data.float() * scale
    if method == "int4":
        return (_unpack4(data).float() - 8.0) * scale
    if method == "nf4":
        code = torch.from_numpy(NF4_CODE).to(data.device)
        return code[_unpack4(data)] * scale
    raise ValueError(f"method must be int8|int4|nf4, got {method!r}")


def dequantize(qt: QTensor, dtype=None) -> torch.Tensor:
    dtype = dtype or qt.dtype
    xg = grouped_dequantize(qt.data, qt.scale, qt.method)
    x = xg.reshape(*xg.shape[:-3], xg.shape[-3] * xg.shape[-2], xg.shape[-1])
    return x.reshape(qt.shape).to(dtype)


def _pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack unsigned 4-bit codes pairwise along axis -2 (the group dim)."""
    if codes.shape[-2] % 2 != 0:
        raise ValueError(f"group size {codes.shape[-2]} must be even for 4-bit packing")
    lo, hi = codes[..., 0::2, :].to(torch.uint8), codes[..., 1::2, :].to(torch.uint8)
    return lo | (hi << 4)


def _unpack4(packed: torch.Tensor) -> torch.Tensor:
    """The codes of :func:`_pack4`, int64 (an index type) ``[..., 2 rows, out]``."""
    lo = (packed & 0x0F).long()
    hi = (packed >> 4).long()
    out = torch.stack([lo, hi], dim=-2)  # [..., n/2, 2, out]
    return out.reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def quantized_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ W`` with a quantized ``W`` (``[in, out]`` or stacked).

    Per-channel int8 multiplies the codes and scales the f32 product
    (operands rounded to bf16 as in the reference, which are exact in the
    f32 product here); grouped and 4-bit weights dequantize first."""
    if qt.method == "int8" and qt.group_size is None and len(qt.shape) == 2:
        y = x.to(torch.bfloat16).float() @ qt.data.reshape(qt.shape).float()
        return (y * qt.scale.reshape(1, -1)).to(x.dtype)
    return x @ dequantize(qt, x.dtype)


def _leaves_with_path(tree: Any, prefix: str = ""):
    """``(path, leaf)`` for every leaf of nested dicts, keys joined by "/"."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves_with_path(sub, f"{prefix}/{key}" if prefix else str(key))
    else:
        yield prefix, tree


def _map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def quantize_params(params: Any, config: Optional[QuantizationConfig] = None) -> Any:
    """Quantize every matching leaf of a parameter tree (nested dicts of
    tensors, or the flat ``Model.params`` dict): floating, >= 2-D, at least
    ``min_size`` elements, path not matched by ``skip_patterns``. Returns a
    tree of the same structure with :class:`QTensor` leaves mixed in."""
    config = config or QuantizationConfig()
    skip = [re.compile(p) for p in config.skip_patterns]

    def maybe_q(path, leaf):
        eligible = (
            isinstance(leaf, torch.Tensor)
            and leaf.dim() >= 2
            and leaf.numel() >= config.min_size
            and leaf.is_floating_point()
            and not any(p.search(path) for p in skip)
        )
        return quantize(leaf.detach(), config) if eligible else leaf

    return _map_with_path(maybe_q, params)


def dequantize_params(params: Any, dtype=None) -> Any:
    return _map_with_path(lambda _, l: dequantize(l, dtype) if isinstance(l, QTensor) else l, params)


def quantized_bytes(params: Any) -> int:
    total = 0
    for _, leaf in _leaves_with_path(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return int(total)


class _DequantizingModel:
    """A :class:`~..modeling.Model` stand-in whose parameters are a
    quantized tree: every call dequantizes the tree to the compute dtype
    and runs the module on it. The module itself holds no storage (its
    copy lives on the ``meta`` device)."""

    def __init__(self, module, qparams: dict, dtype: torch.dtype, config: Any, name: str):
        self.module, self.params, self._dtype = module, qparams, dtype
        self.config, self.name = config, name

    @property
    def device(self) -> torch.device:
        leaf = next(l for _, l in _leaves_with_path(self.params))
        return (leaf.data if isinstance(leaf, QTensor) else leaf).device

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def apply_fn(self, params: dict, *args, **kwargs):
        return functional_call(self.module, dequantize_params(params, self._dtype), args, kwargs)

    def __call__(self, *args, **kwargs):
        return self.apply_fn(self.params, *args, **kwargs)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


def load_and_quantize_model(model, config: Optional[QuantizationConfig] = None):
    """Quantize a :class:`~..modeling.Model`'s weights in place of the
    float copies.

    A llama is rebuilt with :class:`~..ops.qdense.QuantDense` projections:
    the packed codes are the parameters, and int4 decode on the card reads
    only the packed bytes (``ops/qmatmul.py``). Any other model falls back
    to a wrapper that dequantizes the whole tree to ``compute_dtype`` on
    every call. The result lives on the device of ``model``."""
    config = config or QuantizationConfig()
    cfg_obj = getattr(model, "config", None)
    if cfg_obj is not None and hasattr(cfg_obj, "quant_method") and getattr(model, "module", None) is not None:
        from ..models.llama import quantize_llama_model

        return quantize_llama_model(model, config)
    qparams = quantize_params(model.params, config)
    skeleton = copy.deepcopy(model.module).to("meta")
    return _DequantizingModel(
        skeleton, qparams, getattr(torch, config.compute_dtype), cfg_obj, getattr(model, "name", None)
    )


# ---------------------------------------------------------------------------
# fp8 (per-tensor dynamic scaling)
# ---------------------------------------------------------------------------

FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def fp8_quantize(x: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn):
    """Scale ``x`` to the fp8 range: ``(codes, inv_scale)`` with ``x ~= codes
    * inv_scale``. The JAX package's arithmetic: ``amax = max(max|x|,
    1e-12)`` and ``scale = fmax / amax`` in f32, the codes ``x * scale`` in
    f32 rounded to nearest-even, ``inv_scale = 1 / scale`` in f32. (``|x|``
    and its max are exact in ``x``'s own dtype, so the max is taken there;
    the two scalar divisions are taken in f64 and rounded once to f32,
    which is the correctly rounded f32 quotient: torch's f32 division by a
    0-dim CPU tensor is not always.)"""
    fmax = FP8_E4M3_MAX if dtype == torch.float8_e4m3fn else FP8_E5M2_MAX
    amax = torch.clamp_min(x.detach().abs().amax().float(), 1e-12)
    scale = (fmax / amax.double()).float()
    return (x.detach().float() * scale).to(dtype), (1.0 / scale.double()).float()


def fp8_dot(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``a @ b`` (``b`` is ``[K, N]``) in fp8: e4m3 operands with dynamic
    per-tensor scales, f32 accumulation, differentiable (gradients in
    e5m2). Delegates to :func:`..ops.fp8.fp8_matmul`."""
    from ..ops.fp8 import fp8_matmul

    return fp8_matmul(a, b.t()).to(out_dtype)
