"""SSD prediction heads (counterpart of demonet_tpu/models/heads.py).

  * `SSDHead`: one plain 3x3 conv per level for each of classification
    and box regression (the VGG SSDs);
  * `Pelee1x1Head`: plain 1x1 convs (Pelee-SSD);
  * `SSDLiteHead`: depthwise-separable blocks; with `last_plain`, the
    last level is a plain 1x1 conv (the legacy ssd_lite_mobilenet_v2).

Each level's conv produces NCHW (N, A*K, H, W). The JAX package's NHWC
(N, H, W, A*K) reshapes straight to the anchor order of
models/anchors.py (location-major, anchor-minor); here the permute to
(N, H, W, A*K) must come first, or the rows of anchors and predictions
silently stop lining up.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from demonet_tpu_torch.models.layers import Conv2d, SeparableConv


def _flatten_levels(outputs: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """[(N, A*K, H, W), ...] -> (N, sum HWA, K)."""
    flat = [o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, k) for o in outputs]
    return torch.cat(flat, dim=1)


class _Head(nn.Module):
    """One module per level for classification (`cls`) and box regression
    (`reg`), from make(level, in_channels, out_channels)."""

    def __init__(self, in_channels: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int, make: Callable[[int, int, int], nn.Module]):
        super().__init__()
        self.num_classes = num_classes
        self.cls = nn.ModuleList(
            make(i, c, num_classes * a)
            for i, (c, a) in enumerate(zip(in_channels, num_anchors)))
        self.reg = nn.ModuleList(
            make(i, c, 4 * a)
            for i, (c, a) in enumerate(zip(in_channels, num_anchors)))

    def forward(self, features: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        cls_out = [m(x) for m, x in zip(self.cls, features)]
        reg_out = [m(x) for m, x in zip(self.reg, features)]
        return {
            "cls_logits": _flatten_levels(cls_out, self.num_classes),
            "bbox_regression": _flatten_levels(reg_out, 4),
        }


class SSDHead(_Head):
    """Plain 3x3 conv heads (padding 1, with bias)."""

    def __init__(self, in_channels: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int):
        super().__init__(in_channels, num_anchors, num_classes,
                         lambda i, c, o: Conv2d(c, o, 3, padding=1))


class Pelee1x1Head(_Head):
    """Plain 1x1 conv heads (with bias) on the ResBlock-refined maps."""

    def __init__(self, in_channels: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int):
        super().__init__(in_channels, num_anchors, num_classes,
                         lambda i, c, o: Conv2d(c, o, 1))


class SSDLiteHead(_Head):
    """Depthwise-separable SSD head: one SeparableConv per level. BN eps
    1e-3 and torch momentum 0.03 on the flagship (the JAX package's decay
    0.97); the legacy ssd_lite_mobilenet_v2 takes eps 1e-5, momentum 0.1
    and `last_plain`, a plain 1x1 conv with bias on the last level."""

    def __init__(self, in_channels: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int, bn_momentum: float = 0.03,
                 bn_eps: float = 1e-3, last_plain: bool = False):
        last = len(num_anchors) - 1

        def make(i, c, o):
            if last_plain and i == last:
                return Conv2d(c, o, 1)
            return SeparableConv(c, o, bn_momentum, bn_eps)

        super().__init__(in_channels, num_anchors, num_classes, make)
