"""Box geometry on torch tensors (counterpart of demonet_tpu/ops/boxes.py).

Boxes live in the last axis as (..., 4); every function takes arbitrary
leading batch dimensions. The arithmetic follows the JAX formulas term by
term, so IoU and clipping are bit-equal to the reference on the same
inputs; `decode_boxes` differs only where `exp` differs between the two
frameworks' math libraries (a few ulps).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# log(1000/16), the decode clamp (demonet_tpu/ops/boxes.py:26).
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)

DEFAULT_BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; shape (..., N)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU: (..., M, 4) x (..., N, 4) -> ((..., M, N), union).

    Degenerate boxes give IoU 0 through the guarded divide.
    """
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union.clamp(min=1e-9)
    return iou, union


def decode_boxes(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    weights: Tuple[float, float, float, float] = DEFAULT_BOX_CODER_WEIGHTS,
    bbox_xform_clip: float = BBOX_XFORM_CLIP,
) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to xyxy anchors -> xyxy boxes."""
    wx, wy, ww, wh = weights
    a = box_xyxy_to_cxcywh(anchors)
    dxy = deltas[..., :2] / deltas.new_tensor([wx, wy])
    dwh = deltas[..., 2:] / deltas.new_tensor([ww, wh])
    dwh = dwh.clamp(max=bbox_xform_clip)
    cxy = dxy * a[..., 2:] + a[..., :2]
    pwh = torch.exp(dwh) * a[..., 2:]
    return box_cxcywh_to_xyxy(torch.cat([cxy, pwh], dim=-1))


def clip_boxes_to_image(boxes: torch.Tensor, size: Tuple[int, int]
                        ) -> torch.Tensor:
    """Clip xyxy boxes to [0, w] x [0, h]. ``size`` is (height, width)."""
    h, w = size
    limits = boxes.new_tensor([w, h, w, h])
    return torch.minimum(boxes.clamp(min=0.0), limits)
