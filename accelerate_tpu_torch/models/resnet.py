"""ResNet v1.5, the CV example's model.

Counterpart of :mod:`accelerate_tpu.models.resnet`: the v1.5 bottleneck
(the stride on the 3x3, not on the first 1x1), the last BatchNorm of each
residual branch starting at zero scale, f32 logits. The input stays NHWC
``[B, H, W, 3]`` as the JAX contract has it; inside, the activations are
NCHW tensors in ``channels_last`` memory (the same bytes), which cuDNN
convolves without a transpose. No Pallas kernel runs in the JAX model:
its convolutions are XLA's, so here they are ``F.conv2d``.

Three places where flax and torch differ, each matched here:

* ``padding="SAME"``: flax pads ``max((out - 1) * stride + k - in, 0)``
  with the smaller half first, so a 3x3 stride-2 window on an even input
  pads (0, 1), not torch's (1, 1). The strided 3x3 convolutions and the
  stem's max pool (padded with -inf) pad explicitly before a ``padding=0``
  call (:func:`same_pads`).
* BatchNorm: the batch statistics are accumulated in f32 whatever the
  compute dtype, the variance is the biased one, and a running statistic
  keeps ``momentum`` (0.9) of its old value. ``nn.BatchNorm2d`` updates
  its running variance with the unbiased one (its ``momentum`` 0.1 is
  flax's 0.9) and mutates its buffers; so the layer calls torch's fused
  batch norm without running statistics (it normalises with the biased
  batch variance, in f32, and its backward runs through the statistics)
  and updates the running ones itself.
* The state is functional: :meth:`ResNet.forward` takes the running
  statistics and, in training, returns the new ones beside the logits,
  never writing a buffer. ``build_train_step(has_state=True)`` copies
  them into the model's buffers (:attr:`~..modeling.Model.state`) after
  the backward, so a block recomputed under ``remat``
  (``torch.utils.checkpoint``) updates the state once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..modeling import Model, nest
from ..utils.environment import resolve_device


@dataclasses.dataclass
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_filters: int = 64
    num_classes: int = 1000
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    remat: bool = False

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(**kw)

    @classmethod
    def resnet18(cls, **kw) -> "ResNetConfig":
        kw.setdefault("stage_sizes", (2, 2, 2, 2))
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        """Two stages of one block each, for tests."""
        kw.setdefault("stage_sizes", (1, 1))
        kw.setdefault("num_filters", 8)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``nn.Conv(padding="SAME", use_bias=False)`` on an NCHW ``x``."""
    k = w.shape[-1]
    (top, bottom), (left, right) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``."""
    (top, bottom), (left, right) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor: ``weight``
    (flax's ``scale``) and ``bias`` are parameters, ``mean`` and ``var`` the
    running statistics (buffers, read and returned, never written here)."""

    def __init__(self, channels: int, momentum: float, epsilon: float, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.epsilon, self.zero_scale = momentum, epsilon, zero_scale
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, stats: dict, train: bool):
        dtype = torch.promote_types(x.dtype, torch.float32)  # 16-bit x: f32 scale and shift (flax's promotion)
        weight, bias = self.weight.to(dtype), self.bias.to(dtype)
        if not train:
            return F.batch_norm(x, stats["mean"], stats["var"], weight, bias, False, 0.0, self.epsilon), stats
        if x.device.type == "cpu":
            # the CPU's channels_last kernel sums in an order that leaves the gradients of ResNet's
            # cancellation-prone biases ~25x further from f64 than its NCHW kernel, which the card's agrees with
            x = x.contiguous()
        # the batch's mean and 1 / sqrt(var + epsilon) come back beside y
        y, mean, invstd = torch.native_batch_norm(x, weight, bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            var = (invstd.pow(-2) - self.epsilon).clamp_min(0.0)
            m = self.momentum
            new = {"mean": m * stats["mean"] + (1.0 - m) * mean, "var": m * stats["var"] + (1.0 - m) * var}
        return y, new


class BottleneckBlock(nn.Module):
    """v1.5 bottleneck: 1x1 reduce, 3x3 carrying the stride, 1x1 expand; a
    projection on the shortcut where the shape changes."""

    def __init__(self, in_channels: int, filters: int, strides: int, config: ResNetConfig):
        super().__init__()
        self.strides = strides

        def bn(c, zero_scale=False):
            return BatchNorm(c, config.bn_momentum, config.bn_epsilon, zero_scale)

        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = bn(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = bn(filters * 4, zero_scale=True)  # the residual branch starts as the identity
        if in_channels != filters * 4 or strides != 1:
            self.conv_proj = nn.Conv2d(in_channels, filters * 4, 1, bias=False)
            self.bn_proj = bn(filters * 4)

    def forward(self, x: torch.Tensor, stats: dict, train: bool):
        new = {}
        y = _conv(x, self.conv1.weight, 1)
        y, new["bn1"] = self.bn1(y, stats["bn1"], train)
        y = _conv(F.relu(y), self.conv2.weight, self.strides)
        y, new["bn2"] = self.bn2(y, stats["bn2"], train)
        y = _conv(F.relu(y), self.conv3.weight, 1)
        y, new["bn3"] = self.bn3(y, stats["bn3"], train)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = _conv(x, self.conv_proj.weight, self.strides)
            residual, new["bn_proj"] = self.bn_proj(residual, stats["bn_proj"], train)
        return F.relu(residual + y), new


class ResNet(nn.Module):
    """``forward(images [B, H, W, 3], state=None, train=False)`` -> f32
    logits ``[B, num_classes]``; in training ``(logits, new_state)``.
    ``state`` is ``{"batch_stats": ...}`` (None: the module's own
    buffers). The images are cast to the parameters' dtype, so under a
    16-bit compute policy the convolutions run in 16 bits; the head runs
    in f32."""

    state_collection = "batch_stats"

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = config
        self.conv_init = nn.Conv2d(3, config.num_filters, 7, bias=False)
        self.bn_init = BatchNorm(config.num_filters, config.bn_momentum, config.bn_epsilon)
        channels = config.num_filters
        self.block_names = []
        for i, n_blocks in enumerate(config.stage_sizes):
            for j in range(n_blocks):
                name = f"stage{i}_block{j}"
                filters = config.num_filters * 2**i
                self.add_module(name, BottleneckBlock(channels, filters, 2 if j == 0 and i > 0 else 1, config))
                self.block_names.append(name)
                channels = filters * 4
        self.head = nn.Linear(channels, config.num_classes)

    def forward(self, images: torch.Tensor, state: Optional[dict] = None, train: bool = False):
        stats = (state if state is not None else {"batch_stats": nest(dict(self.named_buffers()))})["batch_stats"]
        new = {}
        x = images.to(self.conv_init.weight.dtype).permute(0, 3, 1, 2)  # NHWC bytes, NCHW view: channels_last
        x = F.conv2d(x, self.conv_init.weight, stride=2, padding=3)
        x, new["bn_init"] = self.bn_init(x, stats["bn_init"], train)
        x = _max_pool(F.relu(x))
        remat = self.config.remat and train and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if remat:
                x, new[name] = checkpoint(block, x, stats[name], train, use_reentrant=False)
            else:
                x, new[name] = block(x, stats[name], train)
        pooled = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)  # global average pool
        logits = F.linear(pooled.float(), self.head.weight.float(), self.head.bias.float())
        return (logits, {"batch_stats": new}) if train else logits


def create_resnet_model(
    config: Optional[ResNetConfig] = None,
    seed: int = 0,
    image_size: int = 224,
    batch_size: int = 2,
    device=None,
) -> Model:
    """ResNet with seeded random weights on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for): convolution and head weights draw ``N(0,
    1/fan_in)`` from a ``torch.Generator`` seeded with ``seed`` (flax's
    LeCun-normal variance), biases start at zero, BatchNorm scales at one
    (``bn3``'s at zero), running means at zero and variances at one.
    ``image_size`` and ``batch_size`` are the JAX signature's (its init
    traces a dummy batch); here they shape nothing. ``model.state`` holds
    the BatchNorm running statistics; train with
    ``build_train_step(loss_fn, has_state=True)``."""
    config = config or ResNetConfig.resnet50()
    dev = resolve_device(device)
    with torch.device("meta"):
        module = ResNet(config)
    module.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(0.0 if m.zero_scale else 1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    module.requires_grad_(False)
    module.eval()
    return Model(module, config, name="resnet")


def resnet_classification_loss(params: dict, state: dict, batch: dict, apply_fn=None):
    """The ``has_state`` loss: ``(mean cross entropy in f32, new_state)``,
    over the rows ``batch["loss_mask"]`` keeps where it is given. ``batch``
    is ``{"images": [B, H, W, 3], "labels": [B]}``; bind ``apply_fn`` with
    ``lambda p, s, b: resnet_classification_loss(p, s, b, model.apply_fn)``."""
    logits, new_state = apply_fn(params, batch["images"], state, train=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, batch["labels"].long()[:, None], dim=-1)[:, 0]
    if "loss_mask" in batch:
        mask = batch["loss_mask"].float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0), new_state
    return nll.mean(), new_state
