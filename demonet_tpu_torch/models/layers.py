"""Shared conv building blocks (counterpart of demonet_tpu/models/layers.py).

PyTorch modules over NCHW tensors. Module and attribute names follow the
variable tree of the JAX package (`conv`, `bn`, `expand_conv`,
`depthwise`, `se/fc1`, `project`, `dw`, `pw`), so
`utils/weights.load_jax_variables` maps one onto the other by rule.

BatchNorm runs in eval mode with running statistics; `eps` is per module
(1e-3 everywhere on the SSDLite path). The activations are written out
as the JAX formulas, not with F.hardsigmoid/F.hardswish, whose constants
and rounding differ.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

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


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation.

    ``act`` None means linear. ``groups`` equal to the channel count gives
    a depthwise conv.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: Act = relu6, bn_eps: float = 1e-3):
        super().__init__()
        self.conv = nn.Conv2d(
            in_channels, features, kernel_size, stride=stride,
            padding=_torch_padding(kernel_size, dilation), dilation=dilation,
            groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=bn_eps)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class SqueezeExcitation(nn.Module):
    """SE block: mean -> fc1 -> relu -> fc2 -> hard-sigmoid gate."""

    def __init__(self, in_channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(in_channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, in_channels, 1)

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
                 use_hs: bool = False):
        super().__init__()
        act = hard_swish if use_hs else torch.relu
        self.use_res_connect = stride == 1 and in_channels == out_channels
        if expanded_channels != in_channels:
            self.expand_conv = ConvBNAct(in_channels, expanded_channels, 1,
                                         act=act)
        else:
            self.expand_conv = None
        self.depthwise = ConvBNAct(
            expanded_channels, expanded_channels, kernel_size,
            stride=1 if dilation > 1 else stride, groups=expanded_channels,
            dilation=dilation, act=act)
        self.se = (SqueezeExcitation(
            expanded_channels, make_divisible(expanded_channels // 4, 8))
            if use_se else None)
        self.project = ConvBNAct(expanded_channels, out_channels, 1, act=None)

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


class SeparableConv(nn.Module):
    """3x3 depthwise + BN + ReLU6, then a 1x1 conv with bias: the SSDLite
    prediction block."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.dw = ConvBNAct(in_channels, in_channels, 3, groups=in_channels,
                            act=relu6)
        self.pw = nn.Conv2d(in_channels, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))
