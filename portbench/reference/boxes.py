"""Default boxes, the box coder and IoU.

`default_boxes` is SSD's prior generation (torchvision's
DefaultBoxGenerator): per level k, the boxes [s_k, s_k],
[sqrt(s_k s_{k+1})]^2 and [s_k sqrt(r), s_k / sqrt(r)] and its transpose
for each aspect ratio r, centred on the cells of the level's grid (or on
multiples of an explicit step), clipped to [0, 1], location-major and
anchor-minor, in pixel xyxy.

The decode is written term by term in one fixed order (a division by
each coder weight, the log-space clamp, exp), so that the same head
outputs give the same boxes bit for bit wherever it runs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

XFORM_CLIP = math.log(1000.0 / 16.0)


def _scales(n: int, min_ratio: float, max_ratio: float,
            scales: Optional[Sequence[float]]) -> List[float]:
    if scales is not None:
        return list(scales)
    out = [min_ratio + (max_ratio - min_ratio) * k / (n - 1.0)
           for k in range(n)]
    return out + [1.0]


def default_boxes(grids: Sequence[Tuple[int, int]], size: Tuple[int, int],
                  aspect_ratios: Sequence[Sequence[float]],
                  min_ratio: float = 0.15, max_ratio: float = 0.9,
                  scales: Optional[Sequence[float]] = None,
                  steps: Optional[Sequence[int]] = None) -> np.ndarray:
    """(sum_k H_k W_k A_k, 4) float32 xyxy pixel boxes."""
    s = _scales(len(aspect_ratios), min_ratio, max_ratio, scales)
    img_h, img_w = size
    out = []
    for k, ((fh, fw), ratios) in enumerate(zip(grids, aspect_ratios)):
        sp = math.sqrt(s[k] * s[k + 1])
        wh = [[s[k], s[k]], [sp, sp]]
        for r in ratios:
            q = math.sqrt(r)
            wh += [[s[k] * q, s[k] / q], [s[k] / q, s[k] * q]]
        wh = np.clip(np.asarray(wh, np.float32), 0.0, 1.0)
        xf, yf = ((img_w / steps[k], img_h / steps[k]) if steps is not None
                  else (float(fw), float(fh)))
        sx = (np.arange(fw, dtype=np.float32) + 0.5) / xf
        sy = (np.arange(fh, dtype=np.float32) + 0.5) / yf
        cy, cx = np.meshgrid(sy, sx, indexing="ij")
        centres = np.repeat(np.stack([cx.reshape(-1), cy.reshape(-1)], -1),
                            len(wh), axis=0)
        whs = np.tile(wh, (fh * fw, 1))
        xyxy = np.concatenate([centres - 0.5 * whs, centres + 0.5 * whs], -1)
        xyxy[:, 0::2] *= img_w
        xyxy[:, 1::2] *= img_h
        out.append(xyxy.astype(np.float32))
    return np.concatenate(out, axis=0)


def to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1)


def decode(deltas: torch.Tensor, anchors: torch.Tensor,
           weights: Sequence[float]) -> torch.Tensor:
    """(dx, dy, dw, dh) on xyxy anchors -> xyxy boxes."""
    wx, wy, ww, wh = weights
    a = to_cxcywh(anchors)
    dxy = deltas[..., :2] / deltas.new_tensor([wx, wy])
    dwh = (deltas[..., 2:] / deltas.new_tensor([ww, wh])).clamp(max=XFORM_CLIP)
    cxy = dxy * a[..., 2:] + a[..., :2]
    pwh = torch.exp(dwh) * a[..., 2:]
    return to_xyxy(torch.cat([cxy, pwh], dim=-1))


def encode(gt: torch.Tensor, anchors: torch.Tensor,
           weights: Sequence[float]) -> torch.Tensor:
    """xyxy gt boxes -> (dx, dy, dw, dh) against xyxy anchors; widths
    guarded at 1e-8 so that zero-padded gt rows stay finite."""
    wx, wy, ww, wh = weights
    a, g = to_cxcywh(anchors), to_cxcywh(gt)
    a_wh, g_wh = a[..., 2:].clamp(min=1e-8), g[..., 2:].clamp(min=1e-8)
    txy = (g[..., :2] - a[..., :2]) / a_wh
    twh = torch.log(g_wh / a_wh)
    return torch.stack([txy[..., 0] * wx, txy[..., 1] * wy,
                        twh[..., 0] * ww, twh[..., 1] * wh], -1)


def clip(boxes: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = size
    return torch.minimum(boxes.clamp(min=0.0), boxes.new_tensor([w, h, w, h]))


def iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N)."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9)
