"""MobileNetV3 feature trunk (counterpart of demonet_tpu/models/mobilenetv3.py).

The block tables and `MobileNetV3Features` with the C4 split that SSDLite
taps. The classifier (`MobileNetV3`) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
from torch import nn

from demonet_tpu_torch.models.layers import (
    ConvBNAct,
    InvertedResidualV3,
    hard_swish,
    make_divisible,
)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One inverted-residual row."""

    in_channels: int
    kernel: int
    expanded_channels: int
    out_channels: int
    use_se: bool
    use_hs: bool
    stride: int
    dilation: int = 1

    @staticmethod
    def adjust(channels: int, width_mult: float) -> int:
        return make_divisible(channels * width_mult, 8)


def _row(width_mult, inp, k, exp, out, se, act, s, d=1) -> BlockConfig:
    adj = lambda c: BlockConfig.adjust(c, width_mult)  # noqa: E731
    return BlockConfig(adj(inp), k, adj(exp), adj(out), se, act == "HS", s, d)


def mobilenet_v3_conf(
    arch: str,
    width_mult: float = 1.0,
    reduced_tail: bool = False,
    dilated: bool = False,
) -> Tuple[List[BlockConfig], int]:
    """Block tables. Returns (rows, last_channel)."""
    rd = 2 if reduced_tail else 1
    dil = 2 if dilated else 1
    w = width_mult
    if arch == "mobilenet_v3_large":
        rows = [
            _row(w, 16, 3, 16, 16, False, "RE", 1),
            _row(w, 16, 3, 64, 24, False, "RE", 2),  # C1
            _row(w, 24, 3, 72, 24, False, "RE", 1),
            _row(w, 24, 5, 72, 40, True, "RE", 2),  # C2
            _row(w, 40, 5, 120, 40, True, "RE", 1),
            _row(w, 40, 5, 120, 40, True, "RE", 1),
            _row(w, 40, 3, 240, 80, False, "HS", 2),  # C3
            _row(w, 80, 3, 200, 80, False, "HS", 1),
            _row(w, 80, 3, 184, 80, False, "HS", 1),
            _row(w, 80, 3, 184, 80, False, "HS", 1),
            _row(w, 80, 3, 480, 112, True, "HS", 1),
            _row(w, 112, 3, 672, 112, True, "HS", 1),
            _row(w, 112, 5, 672, 160 // rd, True, "HS", 2, dil),  # C4
            _row(w, 160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil),
            _row(w, 160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil),
        ]
        last_channel = BlockConfig.adjust(1280 // rd, w)
    elif arch == "mobilenet_v3_small":
        rows = [
            _row(w, 16, 3, 16, 16, True, "RE", 2),  # C1
            _row(w, 16, 3, 72, 24, False, "RE", 2),  # C2
            _row(w, 24, 3, 88, 24, False, "RE", 1),
            _row(w, 24, 5, 96, 40, True, "HS", 2),  # C3
            _row(w, 40, 5, 240, 40, True, "HS", 1),
            _row(w, 40, 5, 240, 40, True, "HS", 1),
            _row(w, 40, 5, 120, 48, True, "HS", 1),
            _row(w, 48, 5, 144, 48, True, "HS", 1),
            _row(w, 48, 5, 288, 96 // rd, True, "HS", 2, dil),  # C4
            _row(w, 96 // rd, 5, 576 // rd, 96 // rd, True, "HS", 1, dil),
            _row(w, 96 // rd, 5, 576 // rd, 96 // rd, True, "HS", 1, dil),
        ]
        last_channel = BlockConfig.adjust(1024 // rd, w)
    else:
        raise ValueError(f"Unsupported arch {arch!r}")
    return rows, last_channel


class MobileNetV3Features(nn.Module):
    """Trunk: stem conv + inverted residuals + final 6x 1x1 conv (NCHW).

    ``c4_split=True`` returns [C4, final] where C4 is taken after the expand
    1x1 of the last strided block. Otherwise returns [final]. BN momentum
    0.01 by default, as in the JAX package's trunk (decay 0.99); SSDLite
    passes 0.03.
    """

    def __init__(self, configs: Sequence[BlockConfig],
                 bn_momentum: float = 0.01):
        super().__init__()
        self.configs = tuple(configs)
        self.stem = ConvBNAct(3, self.configs[0].in_channels, 3, stride=2,
                              act=hard_swish, bn_momentum=bn_momentum)
        self.blocks = nn.ModuleList(
            InvertedResidualV3(
                cfg.in_channels, cfg.expanded_channels, cfg.out_channels,
                cfg.kernel, cfg.stride, cfg.dilation, cfg.use_se, cfg.use_hs,
                bn_momentum=bn_momentum)
            for cfg in self.configs)
        last = self.configs[-1].out_channels
        self.last_conv = ConvBNAct(last, 6 * last, 1, act=hard_swish,
                                   bn_momentum=bn_momentum)

    @property
    def c4_block_index(self) -> int:
        """Index (into self.blocks) of the last strided block: the C4 split."""
        return max(i for i, c in enumerate(self.configs) if c.stride > 1)

    def forward(self, x: torch.Tensor, c4_split: bool = False
                ) -> List[torch.Tensor]:
        out = []
        x = self.stem(x)
        c4 = self.c4_block_index if c4_split else -1
        for i, block in enumerate(self.blocks):
            if i == c4:
                x = block.expand(x)
                out.append(x)
                x = block.remainder(x)
            else:
                x = block(x)
        out.append(self.last_conv(x))
        return out
