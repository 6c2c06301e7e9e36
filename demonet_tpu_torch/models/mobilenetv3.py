"""MobileNetV3 large/small (counterpart of demonet_tpu/models/mobilenetv3.py).

The block tables, `MobileNetV3Features` with the C4 split that SSDLite
taps (and the JAX package's lane-packed prefix and space-to-depth stem),
and the `MobileNetV3` classifier (mean pool, `pre_classifier`,
hard-swish, dropout, `classifier`; BN eps 1e-3, torch momentum 0.01).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from demonet_tpu_torch.models.layers import (
    ConvBNAct,
    InvertedResidualV3,
    Linear,
    dropout,
    hard_swish,
    make_divisible,
)
from demonet_tpu_torch.ops.lane_pack import unpack


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


def pack_plan(configs: Sequence[BlockConfig], lane_pack: bool = True,
              max_lanes: int = 128) -> List[int]:
    """The pack factor each block runs at (1: unpacked). Only a PREFIX of
    eligible blocks (3x3, no SE, no dilation) packs, each at the largest
    of 8, 4, 2 that keeps its input and expanded channels times the pack
    within `max_lanes`; the first block that cannot pack ends it."""
    plan = []
    ended = not lane_pack
    for cfg in configs:
        p_run = 1
        if not ended and cfg.kernel == 3 and not cfg.use_se \
                and cfg.dilation == 1:
            p_run = next((p for p in (8, 4, 2)
                          if p * cfg.expanded_channels <= max_lanes
                          and p * cfg.in_channels <= max_lanes), 1)
        ended = ended or p_run == 1
        plan.append(p_run)
    return plan


class MobileNetV3Features(nn.Module):
    """Trunk: stem conv + inverted residuals + final 6x 1x1 conv (NCHW).

    ``c4_split=True`` returns [C4, final] where C4 is taken after the expand
    1x1 of the last strided block. Otherwise returns [final]. BN momentum
    0.01 by default, as in the JAX package's trunk (decay 0.99); SSDLite
    passes 0.03.

    ``lane_pack`` runs the prefix of blocks that `pack_plan` packs in the
    lane-packed layout (ops/lane_pack.py), each entered at the pack of the
    block before it and unpacked where the prefix ends; ``stem_s2d``
    computes the stem conv on the space-to-depth layout. Both are the same
    math with the same state_dict, as in the JAX package.
    """

    def __init__(self, configs: Sequence[BlockConfig],
                 bn_momentum: float = 0.01, lane_pack: bool = False,
                 lane_pack_max_lanes: int = 128, stem_s2d: bool = False):
        super().__init__()
        self.configs = tuple(configs)
        self.stem = ConvBNAct(3, self.configs[0].in_channels, 3, stride=2,
                              act=hard_swish, bn_momentum=bn_momentum,
                              s2d=stem_s2d)
        self.plan = pack_plan(self.configs, lane_pack, lane_pack_max_lanes)
        plan = self.plan
        self.blocks = nn.ModuleList(
            InvertedResidualV3(
                cfg.in_channels, cfg.expanded_channels, cfg.out_channels,
                cfg.kernel, cfg.stride, cfg.dilation, cfg.use_se, cfg.use_hs,
                bn_momentum=bn_momentum,
                lane_pack_in=plan[i - 1] if i and plan[i] > 1 else 1,
                lane_pack_run=plan[i])
            for i, cfg in enumerate(self.configs))
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
        plan = self.plan
        for i, block in enumerate(self.blocks):
            if i and plan[i - 1] > 1 and plan[i] == 1:
                # the packed prefix ended: back to the pixel layout
                x = unpack(x, plan[i - 1], self.configs[i].in_channels)
            if i == c4:
                x = block.expand(x)
                out.append(x)
                x = block.remainder(x)
            else:
                x = block(x)
        x = unpack(x, plan[-1], self.configs[-1].out_channels)
        out.append(self.last_conv(x))
        return out


class MobileNetV3(nn.Module):
    """The classifier: features, global mean pool, `pre_classifier`,
    hard-swish, dropout, `classifier`.

    Takes NHWC images (B, H, W, 3), as the JAX module does. In train mode
    with dropout_rate > 0, forward needs a `generator` for the dropout
    mask (see layers.dropout)."""

    def __init__(self, arch: str = "mobilenet_v3_large",
                 num_classes: int = 1000, width_mult: float = 1.0,
                 reduced_tail: bool = False, dilated: bool = False,
                 dropout_rate: float = 0.2):
        super().__init__()
        rows, last_channel = mobilenet_v3_conf(arch, width_mult,
                                               reduced_tail, dilated)
        self.features = MobileNetV3Features(rows, bn_momentum=0.01)
        self.dropout_rate = dropout_rate
        self.pre_classifier = Linear(6 * rows[-1].out_channels,
                                        last_channel)
        self.classifier = Linear(last_channel, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.features(x.permute(0, 3, 1, 2))[-1]
        x = hard_swish(self.pre_classifier(feats.mean(dim=(2, 3))))
        x = dropout(x, self.dropout_rate, self.training, generator)
        return self.classifier(x)
