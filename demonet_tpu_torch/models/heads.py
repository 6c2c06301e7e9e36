"""SSDLite prediction head (counterpart of demonet_tpu/models/heads.py).

Each level's conv produces NCHW (N, A*K, H, W). The JAX package's NHWC
(N, H, W, A*K) reshapes straight to the anchor order of
models/anchors.py (location-major, anchor-minor); here the permute to
(N, H, W, A*K) must come first, or the rows of anchors and predictions
silently stop lining up.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from demonet_tpu_torch.models.layers import SeparableConv


def _flatten_levels(outputs: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """[(N, A*K, H, W), ...] -> (N, sum HWA, K)."""
    flat = [o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, k) for o in outputs]
    return torch.cat(flat, dim=1)


class SSDLiteHead(nn.Module):
    """Depthwise-separable SSD head: one SeparableConv per level for each of
    classification (`cls`) and box regression (`reg`). BN momentum 0.03,
    as the JAX package's head (decay 0.97)."""

    def __init__(self, in_channels: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int, bn_momentum: float = 0.03):
        super().__init__()
        self.num_classes = num_classes
        self.cls = nn.ModuleList(
            SeparableConv(c, num_classes * a, bn_momentum)
            for c, a in zip(in_channels, num_anchors))
        self.reg = nn.ModuleList(
            SeparableConv(c, 4 * a, bn_momentum)
            for c, a in zip(in_channels, num_anchors))

    def forward(self, features: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        cls_out = [m(x) for m, x in zip(self.cls, features)]
        reg_out = [m(x) for m, x in zip(self.reg, features)]
        return {
            "cls_logits": _flatten_levels(cls_out, self.num_classes),
            "bbox_regression": _flatten_levels(reg_out, 4),
        }
