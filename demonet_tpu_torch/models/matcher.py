"""Anchor-to-ground-truth matching (counterpart of
demonet_tpu/models/matcher.py).

  * `match`            -- two-threshold matcher: BELOW_LOW_QUALITY = -1,
                          BETWEEN_THRESHOLDS = -2, optional low-quality
                          restore;
  * `ssd_match`        -- single-threshold SSD matcher with each gt forced
                          onto its best anchor;
  * `balanced_sampler` -- random balanced positive/negative masks.

Ground truth comes as fixed-size padded tensors with a validity mask:
padded rows never match (their quality row is set to -1) and are never
forced onto an anchor. The matchers take any leading batch dimensions,
(..., G, A) quality against (..., G) validity, in place of the JAX
package's vmap. Indices come back as int64 (torch's index type).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BELOW_LOW_QUALITY = -1
BETWEEN_THRESHOLDS = -2


def match(
    quality: torch.Tensor,
    high_threshold: float,
    low_threshold: float,
    allow_low_quality_matches: bool = False,
    gt_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., G, A) quality -> (..., A) gt index per anchor.

    Anchors whose best quality is below low_threshold get -1, in [low,
    high) -2. With ``allow_low_quality_matches``, every gt's best anchors
    (ties included) keep their match whatever its quality.
    """
    if gt_valid is not None:
        quality = torch.where(gt_valid[..., None], quality, -1.0)
    matched_vals = quality.amax(dim=-2)
    all_matches = quality.argmax(dim=-2)   # first of equal maxima, as JAX
    matches = torch.where(matched_vals >= high_threshold, all_matches,
                          BETWEEN_THRESHOLDS)
    matches = torch.where(matched_vals < low_threshold, BELOW_LOW_QUALITY,
                          matches)
    if allow_low_quality_matches:
        is_best = quality == quality.amax(dim=-1, keepdim=True)
        if gt_valid is not None:
            is_best = is_best & gt_valid[..., None]
        matches = torch.where(is_best.any(dim=-2), all_matches, matches)
    return matches


def ssd_match(
    iou: torch.Tensor,
    iou_thresh: float = 0.5,
    gt_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SSD matcher: (..., G, A) IoU -> (..., A) gt index or -1.

    Anchors whose best IoU is below iou_thresh are background (-1); then
    each valid gt is forced onto its best anchor. Where two gts share a
    best anchor the larger gt index wins: the JAX package's scatter keeps
    the last one on the CPU, and the reference's sequential overwrite
    does too. The rule is written out as a scatter with "amax", since
    `index_put_` with repeated indices leaves the winner unspecified (and
    on CUDA it varies from run to run).
    """
    g = iou.shape[-2]
    masked = iou if gt_valid is None else torch.where(
        gt_valid[..., None], iou, -1.0)
    matched_vals = masked.amax(dim=-2)
    matches = torch.where(matched_vals >= iou_thresh, masked.argmax(dim=-2),
                          BELOW_LOW_QUALITY)
    best_anchor = masked.argmax(dim=-1)                       # (..., G)
    gt_ids = torch.arange(g, device=iou.device).expand_as(best_anchor)
    if gt_valid is not None:
        gt_ids = torch.where(gt_valid, gt_ids, -1)            # never forced
    forced = torch.full_like(matches, -1).scatter_reduce(
        -1, best_anchor, gt_ids, "amax")
    return torch.where(forced >= 0, forced, matches)


def balanced_sampler(
    generator: torch.Generator,
    labels: torch.Tensor,
    batch_size_per_image: int,
    positive_fraction: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random balanced positive/negative masks over (A,) labels (1 =
    positive, 0 = negative, -1 = ignore).

    Takes min(#positives, batch_size_per_image * positive_fraction)
    positives and min(#negatives, batch_size_per_image - that) negatives,
    chosen uniformly by uniform draws from `generator` (on the labels'
    device). Fixed-shape masks; the counts stay on the device.
    """
    a = labels.shape[0]
    pos = labels >= 1
    neg = labels == 0
    num_pos = pos.sum().clamp(max=int(batch_size_per_image
                                      * positive_fraction))
    num_neg = torch.minimum(neg.sum(), batch_size_per_image - num_pos)
    place = torch.arange(a, device=labels.device)

    def pick(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        draw = torch.rand(a, generator=generator, device=labels.device)
        order = torch.argsort(torch.where(mask, -draw, 1.0), stable=True)
        rank = torch.empty_like(order).scatter_(0, order, place)
        return mask & (rank < k)

    return pick(pos, num_pos), pick(neg, num_neg)
