"""MobileNetV2 (counterpart of demonet_tpu/models/mobilenetv2.py).

The (t, c, n, s) table, the width multiplier with make_divisible
rounding, ReLU6 everywhere; `MobileNetV2Features` with taps at the
indices of the torch `features` Sequential (0 = stem conv, 1..17 =
inverted residuals, 18 = the final 1x1 conv to 1280), which the legacy
SSDLite extractor taps at 13 and 18; and the `mobilenet_v2` classifier.
Every BN has eps 1e-5 and torch momentum 0.1 (the JAX package's decay
0.9). `stem_s2d` computes the stem conv on the space-to-depth layout
(layers.S2DConv2d): the same math with the same state_dict.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from demonet_tpu_torch.models.layers import (
    ConvBNAct,
    InvertedResidualV2,
    Linear,
    dropout,
    make_divisible,
    relu6,
)

# (expand_ratio t, channels c, repeats n, stride s)
_V2_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2Features(nn.Module):
    """The trunk: stem conv + 17 inverted residuals + last 1x1 conv, NCHW.
    forward(x, taps) returns the outputs at `taps` (features indices),
    or the final output alone when taps is None."""

    def __init__(self, width_mult: float = 1.0, round_nearest: int = 8,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 stem_s2d: bool = False):
        super().__init__()
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum)
        ch = make_divisible(32 * width_mult, round_nearest)
        self.last_channel = make_divisible(1280 * max(1.0, width_mult),
                                           round_nearest)
        self.stem = ConvBNAct(3, ch, 3, stride=2, act=relu6, s2d=stem_s2d,
                              **bn)
        blocks = []
        for t, c, n, s in _V2_SETTING:
            out_ch = make_divisible(c * width_mult, round_nearest)
            for i in range(n):
                blocks.append(InvertedResidualV2(ch, out_ch,
                                                 s if i == 0 else 1, t, **bn))
                ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        self.last_conv = ConvBNAct(ch, self.last_channel, 1, act=relu6, **bn)

    def forward(self, x: torch.Tensor,
                taps: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        last = len(self.blocks) + 1
        wanted = set(taps) if taps is not None else {last}
        out = []
        x = self.stem(x)
        if 0 in wanted:
            out.append(x)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i + 1 in wanted:
                out.append(x)
        x = self.last_conv(x)
        if last in wanted:
            out.append(x)
        return out


class MobileNetV2(nn.Module):
    """The classifier: features, global mean pool, dropout, linear.

    Takes NHWC images (B, H, W, 3), as the JAX module does. In train mode
    with dropout_rate > 0, forward needs a `generator` for the dropout
    mask (see layers.dropout)."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.features = MobileNetV2Features(width_mult=width_mult)
        self.dropout_rate = dropout_rate
        self.classifier = Linear(self.features.last_channel, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.features(x.permute(0, 3, 1, 2))[-1]
        x = dropout(feats.mean(dim=(2, 3)), self.dropout_rate, self.training,
                    generator)
        return self.classifier(x)
