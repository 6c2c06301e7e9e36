"""VGG16 trunk and SSD300/512 extras (counterpart of
demonet_tpu/models/vgg.py).

  * the VGG16 conv trunk (configuration "D"), with pool3 in ceil mode so
    a 300x300 input gives the 38x38 conv4_3 map;
  * the learned L2 rescale of conv4_3, scale initialised to 20;
  * pool5 3x3 stride 1 pad 1, the atrous fc6 (dilation 6) and the 1x1 fc7;
  * conv8_2 ... conv11_2, and conv12_2 (kernel 4, valid) for SSD512.

The module names are the JAX package's (`conv1_1` ... `fc7`,
`scale_weight`), so `utils/weights.load_jax_variables` fills them by rule.
`lane_pack` runs block 1 (64 channels at full resolution) in the
lane-packed layout at p = 2 (ops/lane_pack.py): conv1_1 and conv1_2 as
`layers.PackedConv2d` with the same weights and names, then
`packed_pool_2x2`, which lands unpacked at (B, 64, H/2, W/2); the same
math, as in the JAX package.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from demonet_tpu_torch.models.layers import Conv2d, PackedConv2d
from demonet_tpu_torch.ops.lane_pack import pack, packed_pool_2x2


def max_pool_torch(x: torch.Tensor, k: int, s: int, padding: int = 0,
                   ceil_mode: bool = False) -> torch.Tensor:
    """Max pool on NCHW with the JAX package's ceil mode (-inf padding of
    s - rem on the high side where rem = (dim + 2 * padding - k) % s is
    not 0). torch's ceil_mode gives the same windows and values wherever
    each window holds an input element (k >= s and padding < k, as in
    every use here); the JAX rule's extra all-padding windows, which
    torch drops, would hold -inf."""
    return F.max_pool2d(x, k, s, padding, ceil_mode=ceil_mode)


def _conv(in_channels: int, features: int, kernel: int = 3, stride: int = 1,
          padding: int = 1, dilation: int = 1) -> Conv2d:
    return Conv2d(in_channels, features, kernel, stride=stride,
                     padding=padding, dilation=dilation)


def l2_rescale(x: torch.Tensor, scale_weight: torch.Tensor) -> torch.Tensor:
    """The learned L2 rescale of conv4_3 over the channels of NCHW x, in the
    JAX order and in x's dtype (the sum of squares too, in bfloat16 with a
    bf16 model): scale * x / max(norm, 1e-12), the float32 scale cast to
    x's dtype first."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return (scale_weight[None, :, None, None].to(x.dtype) * x
            / norm.clamp(min=1e-12))


# (name, in, out, kernel, stride, padding) of the SSD extras after fc7
_EXTRAS = (("conv8_1", 1024, 256, 1, 1, 0), ("conv8_2", 256, 512, 3, 2, 1),
           ("conv9_1", 512, 128, 1, 1, 0), ("conv9_2", 128, 256, 3, 2, 1),
           ("conv10_1", 256, 128, 1, 1, 0), ("conv10_2", 128, 256, 3, 1, 0),
           ("conv11_1", 256, 128, 1, 1, 0), ("conv11_2", 128, 256, 3, 1, 0))
_HIGHRES = (("conv12_1", 256, 128, 1, 1, 0), ("conv12_2", 128, 256, 4, 1, 0))
# the VGG16 trunk through conv5_3: (block, convs, channels)
_TRUNK = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))


class VGG16SSDExtractor(nn.Module):
    """VGG16 trunk + SSD extras; forward returns the 6 (SSD300) or 7
    (SSD512, `highres`) maps: conv4_3 rescaled, fc7, conv8_2, conv9_2,
    conv10_2, conv11_2[, conv12_2], NCHW. No BN anywhere."""

    def __init__(self, highres: bool = False, lane_pack: bool = False):
        super().__init__()
        self.highres = highres
        self.lane_pack = lane_pack
        ch = 3
        for blk, n, out in _TRUNK:
            for i in range(1, n + 1):
                conv = (PackedConv2d(ch, out, 3, padding=1, pack=2)
                        if lane_pack and blk == 1 else _conv(ch, out))
                self.add_module(f"conv{blk}_{i}", conv)
                ch = out
        self.scale_weight = nn.Parameter(torch.full((512,), 20.0))
        self.fc6 = _conv(512, 1024, padding=6, dilation=6)
        self.fc7 = _conv(1024, 1024, kernel=1, padding=0)
        for name, ci, co, k, s, p in _EXTRAS + (_HIGHRES if highres else ()):
            self.add_module(name, _conv(ci, co, k, s, p))
        self.out_channels = [512, 1024, 512, 256, 256, 256] + (
            [256] if highres else [])

    def _stage(self, x: torch.Tensor, blk: int, n: int) -> torch.Tensor:
        for i in range(1, n + 1):
            x = torch.relu(getattr(self, f"conv{blk}_{i}")(x))
        return x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.lane_pack:
            x = packed_pool_2x2(self._stage(pack(x, 2), 1, 2), 64)
        else:
            x = max_pool_torch(self._stage(x, 1, 2), 2, 2)
        x = max_pool_torch(self._stage(x, 2, 2), 2, 2)
        x = max_pool_torch(self._stage(x, 3, 3), 2, 2, ceil_mode=True)
        x = self._stage(x, 4, 3)
        outputs = [l2_rescale(x, self.scale_weight)]
        x = self._stage(max_pool_torch(x, 2, 2), 5, 3)
        x = max_pool_torch(x, 3, 1, padding=1)
        x = torch.relu(self.fc7(torch.relu(self.fc6(x))))
        outputs.append(x)
        extras = _EXTRAS + (_HIGHRES if self.highres else ())
        for i in range(0, len(extras), 2):
            x = torch.relu(getattr(self, extras[i][0])(x))
            x = torch.relu(getattr(self, extras[i + 1][0])(x))
            outputs.append(x)
        return outputs

