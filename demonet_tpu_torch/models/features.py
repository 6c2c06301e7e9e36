"""Multi-scale feature extractor feeding the SSDLite head (counterpart of
demonet_tpu/models/features.py).

`SSDLiteMobileNetExtractor`: MobileNetV3 trunk with the C4 split plus 4
SSDLite extra blocks 512/256/256/128. The MobileNetV2 extractor of the
legacy model waits for a later slice.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from demonet_tpu_torch.models.layers import ConvBNAct, relu6
from demonet_tpu_torch.models.mobilenetv3 import (
    MobileNetV3Features,
    mobilenet_v3_conf,
)


def _through(module: nn.Module, hw: Tuple[int, int]) -> Tuple[int, int]:
    """Spatial size after every conv of `module`, taken in registration
    order, which is the order they run in on this path (the SE convs are
    1x1 on a pooled map and leave the size as it is)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            hw = tuple(
                (n + 2 * m.padding[i] - m.dilation[i] * (m.kernel_size[i] - 1)
                 - 1) // m.stride[i] + 1
                for i, n in enumerate(hw))
    return hw


class _SSDLiteExtraBlock(nn.Module):
    """1x1 project-to-half + 3x3 s2 depthwise + 1x1 expand, all ReLU6."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        mid = features // 2
        self.proj = ConvBNAct(in_channels, mid, 1, act=relu6)
        self.dw = ConvBNAct(mid, mid, 3, stride=2, groups=mid, act=relu6)
        self.expand = ConvBNAct(mid, features, 1, act=relu6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(self.dw(self.proj(x)))


class SSDLiteMobileNetExtractor(nn.Module):
    """MobileNetV3-Large trunk (reduced tail, C4 split) + 4 SSDLite extra
    blocks -> 6 maps. At 320x320 they are 672x20^2, 480x10^2, 512x5^2,
    256x3^2, 256x2^2, 128x1^2 (NCHW). The JAX package's width_mult,
    min_depth and small-trunk options wait for the slices that use them.
    """

    def __init__(self):
        super().__init__()
        rows, _ = mobilenet_v3_conf("mobilenet_v3_large", reduced_tail=True)
        self.trunk = MobileNetV3Features(rows)
        depths = [512, 256, 256, 128]
        self.out_channels = [rows[self.trunk.c4_block_index].expanded_channels,
                             6 * rows[-1].out_channels, *depths]
        self.extras = nn.ModuleList(
            _SSDLiteExtraBlock(i, d)
            for i, d in zip(self.out_channels[1:-1], depths))

    def grid_sizes(self, size: Tuple[int, int]) -> List[Tuple[int, int]]:
        """(H, W) of each of the 6 maps for an input of `size`, by conv
        shape arithmetic (the JAX package traces shapes with eval_shape)."""
        trunk = self.trunk
        hw = _through(trunk.stem, tuple(size))
        grids = []
        for i, block in enumerate(trunk.blocks):
            if i == trunk.c4_block_index:
                grids.append(hw)  # the tap follows a 1x1 expand
            hw = _through(block, hw)
        grids.append(_through(trunk.last_conv, hw))
        for block in self.extras:
            grids.append(_through(block, grids[-1]))
        return grids

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = self.trunk(x, c4_split=True)
        x = outputs[-1]
        for block in self.extras:
            x = block(x)
            outputs.append(x)
        return outputs
