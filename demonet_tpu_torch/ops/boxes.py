"""Box geometry on torch tensors (counterpart of demonet_tpu/ops/boxes.py).

Boxes live in the last axis as (..., 4); every function takes arbitrary
leading batch dimensions. The arithmetic follows the JAX formulas term by
term, so IoU and clipping are bit-equal to the reference on the same
inputs; `decode_boxes` and `encode_boxes` differ only where `exp` and
`log` differ between the two frameworks' math libraries (a few ulps).
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


def encode_boxes(
    reference_boxes: torch.Tensor,
    anchors: torch.Tensor,
    weights: Tuple[float, float, float, float] = DEFAULT_BOX_CODER_WEIGHTS,
) -> torch.Tensor:
    """Encode xyxy gt boxes as (dx, dy, dw, dh) targets w.r.t. xyxy anchors.

    Both widths are guarded at 1e-8, as in the JAX package, so that padded
    (all-zero) gt rows stay finite and `loss * mask` never meets inf * 0.
    The weights multiply as Python scalars: no host-to-device copy.
    """
    wx, wy, ww, wh = weights
    a = box_xyxy_to_cxcywh(anchors)
    g = box_xyxy_to_cxcywh(reference_boxes)
    a_wh = a[..., 2:].clamp(min=1e-8)
    g_wh = g[..., 2:].clamp(min=1e-8)
    txy = (g[..., :2] - a[..., :2]) / a_wh
    twh = torch.log(g_wh / a_wh)
    return torch.stack([txy[..., 0] * wx, txy[..., 1] * wy,
                        twh[..., 0] * ww, twh[..., 1] * wh], dim=-1)


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


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                        ) -> torch.Tensor:
    """Pairwise GIoU (https://giou.stanford.edu/): (..., M, 4) x (..., N, 4)
    -> (..., M, N), with the enclosing box's area guarded at 1e-9."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / enclosing.clamp(min=1e-9)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float
                            ) -> torch.Tensor:
    """Boolean mask of the boxes whose sides are both >= min_size (a mask
    where torchvision's `remove_small_boxes` gives an index set)."""
    wh = boxes[..., 2:] - boxes[..., :2]
    return (wh[..., 0] >= min_size) & (wh[..., 1] >= min_size)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """xyxy bounding boxes of binary masks: (..., N, H, W) -> (..., N, 4)
    float32; an empty mask gives zeros. Pixels are taken as their integer
    coordinates, as in the JAX package (±1e8 stand for "no pixel")."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    m = masks.to(torch.float32)
    any_mask = masks.to(torch.bool).flatten(-2).any(-1)
    big = torch.tensor(1e8, dtype=torch.float32, device=masks.device)
    x_proj = m.amax(dim=-2)   # (..., N, W)
    y_proj = m.amax(dim=-1)   # (..., N, H)
    x_min = torch.where(x_proj > 0, xs, big).amin(-1)
    x_max = torch.where(x_proj > 0, xs, -big).amax(-1)
    y_min = torch.where(y_proj > 0, ys, big).amin(-1)
    y_max = torch.where(y_proj > 0, ys, -big).amax(-1)
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(any_mask[..., None], boxes, torch.zeros_like(boxes))
