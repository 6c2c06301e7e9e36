"""SSD default-box ("prior"/anchor) generation as a pure numpy function.

A copy of demonet_tpu/models/anchors.py (the port imports nothing of the
JAX package, not even its numpy-only modules). The arithmetic is kept
line for line so `default_boxes` is bit-equal to the reference; the test
tests/test_torch_boxes_anchors.py holds it to that.

Anchor ordering is location-major, anchor-minor: for feature map k with
grid HxW and A anchors/location, rows are [(y0,x0,a0), (y0,x0,a1), ...,
(y0,x1,a0), ...] -- the order of an NHWC head reshape
(N, H, W, A*K) -> (N, H*W*A, K), which the NCHW head reaches by a permute.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def compute_scales(
    num_outputs: int,
    min_ratio: float = 0.15,
    max_ratio: float = 0.9,
    scales: Optional[Sequence[float]] = None,
) -> List[float]:
    """Scale interpolation (reference anchor_utils.py:39-47)."""
    if scales is not None:
        return list(scales)
    if num_outputs > 1:
        rng = max_ratio - min_ratio
        out = [min_ratio + rng * k / (num_outputs - 1.0) for k in range(num_outputs)]
        out.append(1.0)
        return out
    return [min_ratio, max_ratio]


def wh_pairs_per_level(
    aspect_ratios: Sequence[Sequence[float]],
    scales: Sequence[float],
    clip: bool = True,
) -> List[np.ndarray]:
    """Width/height pairs per feature-map level (reference anchor_utils.py:51-68).

    Level k gets [s_k, s_k], [s'_k, s'_k] with s'_k = sqrt(s_k * s_{k+1}),
    plus [s_k*sqrt(ar), s_k/sqrt(ar)] and its transpose per aspect ratio.
    """
    out = []
    for k, ratios in enumerate(aspect_ratios):
        s_k = scales[k]
        s_prime_k = math.sqrt(scales[k] * scales[k + 1])
        pairs = [[s_k, s_k], [s_prime_k, s_prime_k]]
        for ar in ratios:
            sq = math.sqrt(ar)
            pairs.append([s_k * sq, s_k / sq])
            pairs.append([s_k / sq, s_k * sq])
        arr = np.asarray(pairs, dtype=np.float32)
        if clip:
            arr = np.clip(arr, 0.0, 1.0)
        out.append(arr)
    return out


def num_anchors_per_location(aspect_ratios: Sequence[Sequence[float]]) -> List[int]:
    """2 + 2 * len(ratios) per level (reference anchor_utils.py:70-72)."""
    return [2 + 2 * len(r) for r in aspect_ratios]


def default_boxes(
    grid_sizes: Sequence[Tuple[int, int]],
    image_size: Tuple[int, int],
    aspect_ratios: Sequence[Sequence[float]],
    min_ratio: float = 0.15,
    max_ratio: float = 0.9,
    scales: Optional[Sequence[float]] = None,
    steps: Optional[Sequence[int]] = None,
    clip: bool = True,
) -> np.ndarray:
    """All default boxes for a pyramid of feature maps, as pixel xyxy.

    Args:
      grid_sizes: (H_k, W_k) of each feature map.
      image_size: (H, W) of the (fixed) network input.
      aspect_ratios: per-level aspect ratio lists (e.g. 6 x [2, 3]).
      steps: optional per-level step overrides (reference anchor_utils.py:80-83).

    Returns:
      float32 (sum_k H_k*W_k*A_k, 4) xyxy array in input-image pixels.
    """
    if steps is not None and len(steps) != len(aspect_ratios):
        raise ValueError("steps must match aspect_ratios length")
    scales_ = compute_scales(len(aspect_ratios), min_ratio, max_ratio, scales)
    whs = wh_pairs_per_level(aspect_ratios, scales_, clip)

    img_h, img_w = image_size
    boxes = []
    for k, (f_h, f_w) in enumerate(grid_sizes):
        if steps is not None:
            # Cell-center denominators from explicit steps (reference :80-83).
            x_f_k = img_w / steps[k]
            y_f_k = img_h / steps[k]
        else:
            x_f_k, y_f_k = float(f_w), float(f_h)

        shifts_x = ((np.arange(f_w, dtype=np.float32) + 0.5) / x_f_k)
        shifts_y = ((np.arange(f_h, dtype=np.float32) + 0.5) / y_f_k)
        cy, cx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
        centers = np.stack([cx.reshape(-1), cy.reshape(-1)], axis=-1)  # (HW, 2)

        a = whs[k].shape[0]
        centers = np.repeat(centers, a, axis=0)                      # (HW*A, 2)
        wh = np.tile(whs[k], (f_h * f_w, 1))                         # (HW*A, 2)
        cxcywh = np.concatenate([centers, wh], axis=-1)

        xyxy = np.concatenate(
            [cxcywh[:, :2] - 0.5 * cxcywh[:, 2:], cxcywh[:, :2] + 0.5 * cxcywh[:, 2:]],
            axis=-1,
        )
        xyxy[:, 0::2] *= img_w
        xyxy[:, 1::2] *= img_h
        boxes.append(xyxy.astype(np.float32))

    return np.concatenate(boxes, axis=0)
