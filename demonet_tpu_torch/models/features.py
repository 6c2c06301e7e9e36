"""Multi-scale feature extractors feeding the SSDLite heads (counterpart
of demonet_tpu/models/features.py).

  * `SSDLiteMobileNetExtractor`: MobileNetV3 trunk with the C4 split plus
    4 SSDLite extra blocks 512/256/256/128 (the flagship);
  * `MobileNetV2ExtraBlocks`: the legacy extractor of
    ssd_lite_mobilenet_v2, MobileNetV2 taps at blocks 13 and 18 plus 4
    fractional-expand inverted residuals 512/256/256/64.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from demonet_tpu_torch.models.layers import ConvBNAct, make_divisible, relu6
from demonet_tpu_torch.models.mobilenetv2 import MobileNetV2Features
from demonet_tpu_torch.models.mobilenetv3 import (
    MobileNetV3Features,
    mobilenet_v3_conf,
)


class _SSDLiteExtraBlock(nn.Module):
    """1x1 project-to-half + 3x3 s2 depthwise + 1x1 expand, all ReLU6."""

    def __init__(self, in_channels: int, features: int, bn_momentum: float):
        super().__init__()
        mid = features // 2
        bn = dict(act=relu6, bn_momentum=bn_momentum)
        self.proj = ConvBNAct(in_channels, mid, 1, **bn)
        self.dw = ConvBNAct(mid, mid, 3, stride=2, groups=mid, **bn)
        self.expand = ConvBNAct(mid, features, 1, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(self.dw(self.proj(x)))


class SSDLiteMobileNetExtractor(nn.Module):
    """MobileNetV3-Large trunk (C4 split; the reduced tail by default) + 4
    SSDLite extra blocks -> 6 maps. At 320x320 with the reduced tail they
    are 672x20^2, 480x10^2, 512x5^2, 256x3^2, 256x2^2, 128x1^2 (NCHW;
    960x10^2 second with the full tail). The JAX package's width_mult,
    min_depth and small-trunk options have no builder that sets them.
    Every BN has eps 1e-3 and torch momentum 0.03, SSDLite's detection BN
    (the JAX package's decay 0.97, demonet_tpu/models/features.py:73).
    `lane_pack`, `lane_pack_max_lanes` and `stem_s2d` go to the trunk.
    """

    def __init__(self, bn_momentum: float = 0.03, reduced_tail: bool = True,
                 lane_pack: bool = False, lane_pack_max_lanes: int = 128,
                 stem_s2d: bool = False):
        super().__init__()
        rows, _ = mobilenet_v3_conf("mobilenet_v3_large",
                                    reduced_tail=reduced_tail)
        self.trunk = MobileNetV3Features(
            rows, bn_momentum=bn_momentum, lane_pack=lane_pack,
            lane_pack_max_lanes=lane_pack_max_lanes, stem_s2d=stem_s2d)
        depths = [512, 256, 256, 128]
        self.out_channels = [rows[self.trunk.c4_block_index].expanded_channels,
                             6 * rows[-1].out_channels, *depths]
        self.extras = nn.ModuleList(
            _SSDLiteExtraBlock(i, d, bn_momentum)
            for i, d in zip(self.out_channels[1:-1], depths))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = self.trunk(x, c4_split=True)
        x = outputs[-1]
        for block in self.extras:
            x = block(x)
            outputs.append(x)
        return outputs


class _ExtraInvertedResidual(nn.Module):
    """The legacy extra block: an inverted residual with a fractional
    expand ratio (pw, dw stride 2, pw_linear), BN eps 1e-5, torch momentum
    0.1."""

    def __init__(self, in_channels: int, features: int, expand_ratio: float,
                 stride: int = 2):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        bn = dict(bn_eps=1e-5, bn_momentum=0.1)
        self.use_res_connect = stride == 1 and in_channels == features
        self.pw = ConvBNAct(in_channels, hidden, 1, act=relu6, **bn)
        self.dw = ConvBNAct(hidden, hidden, 3, stride=stride, groups=hidden,
                            act=relu6, **bn)
        self.pw_linear = ConvBNAct(hidden, features, 1, act=None, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw_linear(self.dw(self.pw(x)))
        return x + y if self.use_res_connect else y


class MobileNetV2ExtraBlocks(nn.Module):
    """MobileNetV2 + extra blocks: 6 maps, at 320x320 96x20^2 (block 13),
    1280x10^2 (the last conv), 512x5^2, 256x3^2, 256x2^2, 64x1^2 (NCHW).
    `stem_s2d` goes to the trunk."""

    hidden_dims = (512, 256, 256, 64)
    expand_ratios = (0.2, 0.25, 0.5, 0.25)

    def __init__(self, width_mult: float = 1.0, stem_s2d: bool = False):
        super().__init__()
        self.trunk = MobileNetV2Features(width_mult=width_mult,
                                         stem_s2d=stem_s2d)
        self.out_channels = [make_divisible(96 * width_mult, 8),
                             self.trunk.last_channel, *self.hidden_dims]
        self.extras = nn.ModuleList(
            _ExtraInvertedResidual(i, c, r) for i, c, r in zip(
                self.out_channels[1:-1], self.hidden_dims,
                self.expand_ratios))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = self.trunk(x, taps=(13, 18))
        x = outputs[-1]
        for block in self.extras:
            x = block(x)
            outputs.append(x)
        return outputs
