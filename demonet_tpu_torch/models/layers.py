"""Shared conv building blocks (counterpart of demonet_tpu/models/layers.py).

PyTorch modules over NCHW tensors. Module and attribute names follow the
variable tree of the JAX package (`conv`, `bn`, `expand_conv`,
`depthwise`, `se/fc1`, `project`, `dw`, `pw`), so
`utils/weights.load_jax_variables` maps one onto the other by rule.

`BatchNorm` is nn.BatchNorm2d in eval mode (running statistics) and
follows the JAX package's rule in train mode. `eps` and `momentum` are
per module, momentum in torch's sense (the JAX package's decay is 1 -
momentum): 1e-3 and 0.03 everywhere on the SSDLite flagship, 1e-5 and 0.1
on MobileNetV2 and PeleeNet, 1e-3 and 0.01 in the MobileNetV3
classifier. The activations are written out as the JAX formulas, not
with F.hardsigmoid/F.hardswish, whose constants and rounding differ.

Compute dtype (the JAX modules' `dtype`, e.g. bfloat16): parameters and
BN statistics stay float32 whatever it is. `Conv2d` and `Linear` cast
their input, weight and bias to their `dtype` and give their output in
it, as the JAX modules' nn.Conv and nn.Dense promote their operands (the
bias added after the product, in that dtype, as there). `BatchNorm`
computes its statistics and the normalisation in at least float32 and
gives the result in its input's dtype, in train and eval mode alike.
Everything
between (activations, SE, pools, residual sums, concatenations) runs in
the dtype its input has, as in JAX. `set_compute_dtype(module, dtype)`
sets the dtype of every Conv2d and Linear under a module; float32, the
default, casts nothing, so a module computes in its parameters' dtype
(float64 after `.double()`). No autocast: its per-op lists differ from
the JAX model's choices and between the CPU and CUDA.

The JAX package's layouts of the same math (`ops/lane_pack.py`):
`S2DConv2d` (the stem conv on the space-to-depth layout, `ConvBNAct`'s
`s2d`), `PackedConv2d`, `PackedBatchNorm` and `PackedConvBNAct` (the
lane-packed layout, `InvertedResidualV3`'s `lane_pack_in` and
`lane_pack_run`). Each holds the parameters and buffers of the module it
stands for, under the same names and shapes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from demonet_tpu_torch.ops.lane_pack import (
    conv_1x1_packed,
    conv_dense_packed,
    conv_dw_packed,
    conv_s2d_stem,
    packed_batch_stats,
    repack,
)
from demonet_tpu_torch.parallel.dist import all_reduce_sum

Act = Optional[Callable[[torch.Tensor], torch.Tensor]]


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Round channel counts to a multiple of ``divisor`` (never down by >10%)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0.0).clamp(max=6.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def _torch_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric padding (k-1)//2 * d, as the JAX package pads explicitly."""
    return (kernel_size - 1) // 2 * dilation


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype` (the JAX nn.Conv's `dtype`): input
    and weight cast to it, the product in it, then the bias added in it."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                               None)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype)[:, None, None]

    def operands(self, x: torch.Tensor):
        """(x, weight) cast to `dtype` (float32 casts nothing)."""
        if self.dtype == torch.float32:
            return x, self.weight
        return x.to(self.dtype), self.weight.to(self.dtype)


class S2DConv2d(Conv2d):
    """A 3x3 stride-2 padding-1 conv without bias computed on the
    space-to-depth layout (`ops.lane_pack.conv_s2d_stem`): the same
    weight (O, C, 3, 3) as the Conv2d it stands for, rearranged at each
    call, so the state_dict and the gradient are the plain conv's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_s2d_stem(*self.operands(x))


class PackedConv2d(Conv2d):
    """A conv computed in the lane-packed layout at pack `pack`
    (`ops/lane_pack.py`), holding the weight (and bias) of the Conv2d it
    stands for, with its shape and name: a 1x1 conv, a 3x3 depthwise
    conv, or a dense 3x3 conv with same padding, at stride 1 or 2. Takes
    and gives packed maps; the bias is tiled over the packs."""

    def __init__(self, *args, pack: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.pack = pack

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self.operands(x)
        if w.shape[2:] == (1, 1):
            y = conv_1x1_packed(x, w, self.pack)
        elif self.groups == self.in_channels > 1:
            y = conv_dw_packed(x, w, self.pack, self.stride[0])
        else:
            y = conv_dense_packed(x, w, self.pack, self.stride[0])
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).repeat(self.pack)[:, None, None]


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (the JAX nn.Dense's `dtype`), as
    Conv2d."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every Conv2d and Linear under `module` computes in `dtype`; the
    rest follows its input (see the module docstring). Returns module."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.dtype = dtype
    return module


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The dtype the module's convs and linears compute in."""
    return next((m.dtype for m in module.modules()
                 if isinstance(m, (Conv2d, Linear))), torch.float32)


# Depth of `hold_running_stats` blocks: while above 0, train-mode BN
# normalises by batch statistics but leaves its running ones alone. A
# global and not a thread-local, because autograd may recompute a
# checkpointed forward on its own device thread.
_HOLD_STATS = [0]


@contextlib.contextmanager
def hold_running_stats() -> Iterator[None]:
    """Train-mode BatchNorm inside the block does not update its running
    statistics: the recompute of a rematerialised forward, so that each
    step updates them once, as the JAX package's `jax.checkpoint` does."""
    _HOLD_STATS[0] += 1
    try:
        yield
    finally:
        _HOLD_STATS[0] -= 1


# The process group whose ranks share train-mode BN statistics, set by
# `global_batch_stats` (None: each BN sees its own batch). A global, as
# `_HOLD_STATS`, so that a recompute on autograd's thread sees it too.
_STATS_GROUP = [None]


@contextlib.contextmanager
def global_batch_stats(group) -> Iterator[None]:
    """Train-mode BatchNorm inside the block takes its statistics over the
    global batch of a data-parallel step: the ranks' per-channel sums of
    x and x^2 and their counts go through one SUM all-reduce over `group`
    (forward and backward), as the JAX package's BatchNorm does over the
    whole batch of its SPMD step. Every rank must run the same modules in
    the same order inside it."""
    prev, _STATS_GROUP[0] = _STATS_GROUP[0], group
    try:
        yield
    finally:
        _STATS_GROUP[0] = prev


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with the JAX package's rule.

    A float32 (or float64) input in eval mode takes nn.BatchNorm2d's own
    forward. A low-precision input (bfloat16) is promoted to float32, as
    the JAX package's BatchNorm promotes it: the statistics (train mode)
    or the running ones (eval mode), the normalisation, scale and bias in
    float32, and the result cast back to the input's dtype. Train mode follows the
    BatchNorm of the JAX package's modules (fast variance) instead of
    torch's:

      * the batch variance is E[x^2] - E[x]^2 clamped at 0, the biased
        one, and it both normalises the batch and updates `running_var`
        (nn.BatchNorm2d updates it with the unbiased variance, n/(n-1)
        times larger);
      * a channel with one value (B = 1 on a 1x1 map) has variance 0, where
        nn.BatchNorm2d raises;
      * running = decay * running + (1 - decay) * batch, decay = 1 -
        momentum, in the JAX package's order of operations.

    The batch statistics are the per-channel sums of x and x^2 over the
    count of values, in at least float32; inside `global_batch_stats(group)`
    the sums and counts are those of every rank of the group. Inside
    `hold_running_stats()` the running statistics stay as they are.
    `num_batches_tracked` is kept for the state_dict's sake and not
    counted.
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and x.dtype == self.running_mean.dtype:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims, c = (0, 2, 3), xf.shape[1]
            # one vector [sum x, sum x^2, count], reduced whole across
            # ranks; the count as a tensor either way, so that one rank's
            # division is the same operation as a process's alone
            stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                               xf.new_full((1,), xf.numel() // c)])
            if _STATS_GROUP[0] is not None:
                stats = all_reduce_sum(stats, _STATS_GROUP[0])
            moments = stats[:2 * c] / stats[2 * c]
            mean = moments[:c]
            var = (moments[c:] - mean * mean).clamp(min=0.0)
            self._track(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = decay * running + (1 - decay) * batch, in the JAX
        package's order, unless inside `hold_running_stats()`."""
        if _HOLD_STATS[0]:
            return
        decay = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean.copy_(decay * self.running_mean
                                    + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var
                                   + (1.0 - decay) * var)


class PackedBatchNorm(BatchNorm):
    """BatchNorm of a lane-packed map (B, pack*C, H, Wp) with the
    variables of the unpacked BatchNorm(C) (the JAX package's
    _PackedBatchNorm): statistics per true channel in float32 (whatever
    x's dtype, float64 too, as there), var = E[x^2] - E[x]^2 unclamped,
    through `ops.lane_pack.packed_batch_stats` (over the group of
    `global_batch_stats`, where one is set); the normalisation folded
    into x * tile(mul) + tile(add) in x's dtype (bfloat16 under
    bfloat16); the running statistics moved as BatchNorm's (`_track`)."""

    def __init__(self, num_features: int, pack: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.pack = pack

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = packed_batch_stats(x.float(), self.pack,
                                           self.num_features, _STATS_GROUP[0])
            self._track(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        add = self.bias - mean * mul
        return (x * mul.repeat(self.pack).to(x.dtype)[:, None, None]
                + add.repeat(self.pack).to(x.dtype)[:, None, None])


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation.

    ``act`` None means linear. ``groups`` equal to the channel count gives
    a depthwise conv. ``s2d`` computes a 3x3 stride-2 conv on the
    space-to-depth layout (`S2DConv2d`: the same math and weight).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: Act = relu6, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.01, s2d: bool = False):
        super().__init__()
        if s2d and (kernel_size, stride, groups, dilation) != (3, 2, 1, 1):
            raise ValueError("s2d is a 3x3 stride-2 conv's layout")
        self.conv = (S2DConv2d if s2d else Conv2d)(
            in_channels, features, kernel_size, stride=stride,
            padding=_torch_padding(kernel_size, dilation), dilation=dilation,
            groups=groups, bias=False)
        self.bn = BatchNorm(features, eps=bn_eps, momentum=bn_momentum)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class PackedConvBNAct(nn.Module):
    """ConvBNAct computed in the lane-packed layout at pack `pack` (the
    JAX package's PackedConvBNAct): a 1x1 conv, or a 3x3 depthwise conv
    at `stride`, then PackedBatchNorm and the activation, on packed maps.
    Its state_dict keys and shapes are ConvBNAct's."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 stride: int = 1, depthwise: bool = False, act: Act = None,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.01,
                 pack: int = 1):
        super().__init__()
        if depthwise != (kernel_size == 3) or (
                depthwise and features != in_channels):
            raise ValueError("a packed ConvBNAct is a 1x1 conv or a 3x3 "
                             "depthwise conv")
        self.conv = PackedConv2d(
            in_channels, features, kernel_size, stride=stride,
            padding=_torch_padding(kernel_size),
            groups=in_channels if depthwise else 1, bias=False, pack=pack)
        self.bn = PackedBatchNorm(features, pack, eps=bn_eps,
                                  momentum=bn_momentum)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class SqueezeExcitation(nn.Module):
    """SE block: mean -> fc1 -> relu -> fc2 -> hard-sigmoid gate."""

    def __init__(self, in_channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = Conv2d(in_channels, squeeze_channels, 1)
        self.fc2 = Conv2d(squeeze_channels, in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * hard_sigmoid(s)


class InvertedResidualV3(nn.Module):
    """MobileNetV3 inverted residual with optional SE and hard-swish.

    ``expand()`` and ``remainder()`` split the block at the SSDLite C4 tap:
    the expand 1x1 of the first block of the last stage.
    """

    def __init__(self, in_channels: int, expanded_channels: int,
                 out_channels: int, kernel_size: int, stride: int,
                 dilation: int = 1, use_se: bool = False,
                 use_hs: bool = False, bn_momentum: float = 0.01,
                 lane_pack_in: int = 1, lane_pack_run: int = 1):
        super().__init__()
        act = hard_swish if use_hs else torch.relu
        bn = dict(bn_momentum=bn_momentum)
        self.use_res_connect = stride == 1 and in_channels == out_channels
        self.in_channels = in_channels
        self.lane_pack_in, self.lane_pack_run = lane_pack_in, lane_pack_run
        if lane_pack_in > 1 or lane_pack_run > 1:
            if kernel_size != 3 or use_se or dilation != 1:
                raise ValueError("lane packing: 3x3 blocks with no SE and "
                                 "no dilation only")
            packed = dict(bn, pack=lane_pack_run)
            self.expand_conv = (PackedConvBNAct(
                in_channels, expanded_channels, 1, act=act, **packed)
                if expanded_channels != in_channels else None)
            self.depthwise = PackedConvBNAct(
                expanded_channels, expanded_channels, 3, stride=stride,
                depthwise=True, act=act, **packed)
            self.se = None
            self.project = PackedConvBNAct(expanded_channels, out_channels,
                                           1, **packed)
            return
        if expanded_channels != in_channels:
            self.expand_conv = ConvBNAct(in_channels, expanded_channels, 1,
                                         act=act, **bn)
        else:
            self.expand_conv = None
        self.depthwise = ConvBNAct(
            expanded_channels, expanded_channels, kernel_size,
            stride=1 if dilation > 1 else stride, groups=expanded_channels,
            dilation=dilation, act=act, **bn)
        self.se = (SqueezeExcitation(
            expanded_channels, make_divisible(expanded_channels // 4, 8))
            if use_se else None)
        self.project = ConvBNAct(expanded_channels, out_channels, 1, act=None,
                                 **bn)

    def expand(self, x: torch.Tensor) -> torch.Tensor:
        """The expand 1x1 only: the SSDLite C4 tap point."""
        if self.lane_pack_run > 1:
            raise ValueError("the C4 tap block is never lane-packed")
        return x if self.expand_conv is None else self.expand_conv(x)

    def remainder(self, x: torch.Tensor) -> torch.Tensor:
        """Depthwise + SE + project (everything after the expand conv)."""
        y = self.depthwise(x)
        if self.se is not None:
            y = self.se(y)
        return self.project(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.lane_pack_in > 1 or self.lane_pack_run > 1:
            x = repack(x, self.lane_pack_in, self.lane_pack_run,
                       self.in_channels)
            y = x if self.expand_conv is None else self.expand_conv(x)
            y = self.remainder(y)
        else:
            y = self.remainder(self.expand(x))
        return x + y if self.use_res_connect else y


class InvertedResidualV2(nn.Module):
    """MobileNetV2 inverted residual: expand 1x1 (absent at expand ratio
    1), 3x3 depthwise, linear project 1x1, as `layers.0`, `layers.1`, ...
    (the JAX package's `layers_<i>`)."""

    def __init__(self, in_channels: int, features: int, stride: int,
                 expand_ratio: float, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
        self.use_res_connect = stride == 1 and in_channels == features
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(in_channels, hidden, 1, **bn))
        layers.append(ConvBNAct(hidden, hidden, 3, stride=stride,
                                groups=hidden, **bn))
        layers.append(ConvBNAct(hidden, features, 1, act=None, **bn))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layers(x)
        return x + y if self.use_res_connect else y


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX package's nn.Dropout: in training, keep each entry with
    probability 1 - rate and scale it by 1 / (1 - rate), drawing the mask
    from `generator` (on x's device); outside training, x as it is. A
    training call with rate > 0 and no generator raises, as the JAX
    package's does without a 'dropout' key."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(the JAX package's 'dropout' rng)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class SeparableConv(nn.Module):
    """3x3 depthwise + BN + ReLU6, then a 1x1 conv with bias: the SSDLite
    prediction block."""

    def __init__(self, in_channels: int, features: int,
                 bn_momentum: float = 0.03, bn_eps: float = 1e-3):
        super().__init__()
        self.dw = ConvBNAct(in_channels, in_channels, 3, groups=in_channels,
                            act=relu6, bn_eps=bn_eps, bn_momentum=bn_momentum)
        self.pw = Conv2d(in_channels, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))
