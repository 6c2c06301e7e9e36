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
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

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
            if not _HOLD_STATS[0]:
                decay = 1.0 - self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(decay * self.running_mean
                                            + (1.0 - decay) * mean)
                    self.running_var.copy_(decay * self.running_var
                                           + (1.0 - decay) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation.

    ``act`` None means linear. ``groups`` equal to the channel count gives
    a depthwise conv.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: Act = relu6, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.01):
        super().__init__()
        self.conv = Conv2d(
            in_channels, features, kernel_size, stride=stride,
            padding=_torch_padding(kernel_size, dilation), dilation=dilation,
            groups=groups, bias=False)
        self.bn = BatchNorm(features, eps=bn_eps, momentum=bn_momentum)
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
                 use_hs: bool = False, bn_momentum: float = 0.01):
        super().__init__()
        act = hard_swish if use_hs else torch.relu
        bn = dict(bn_momentum=bn_momentum)
        self.use_res_connect = stride == 1 and in_channels == out_channels
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
        return x if self.expand_conv is None else self.expand_conv(x)

    def remainder(self, x: torch.Tensor) -> torch.Tensor:
        """Depthwise + SE + project (everything after the expand conv)."""
        y = self.depthwise(x)
        if self.se is not None:
            y = self.se(y)
        return self.project(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
