"""MultiBox loss (counterpart of demonet_tpu/models/losses.py): smooth-L1
box regression plus cross-entropy with 3:1 hard negative mining, dense
over a padded (B, A) batch.

  * regression: smooth-L1 (beta 1) over foreground anchors, divided by
    N = max(1, foreground anchors in the batch);
  * classification: per-anchor CE; per image, negatives ranked by
    descending CE with positives put last (-inf), the top
    neg_to_pos_ratio * positives kept; (foreground CE + kept negative CE)
    divided by the same N.

The JAX package selects the matched gt rows and the label logits with
one-hot products; a gather selects the same values exactly. Its argsort
is stable, and so is the one here (`stable=True`): ties in CE rank by
anchor index, as there. N stays on the device, so nothing here waits for
the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from demonet_tpu_torch.models.matcher import ssd_match
from demonet_tpu_torch.ops.boxes import box_iou, encode_boxes


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """F.smooth_l1_loss's formula, elementwise, as the JAX package writes
    it."""
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def match_batch(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    iou_thresh: float = 0.5,
) -> torch.Tensor:
    """SSD matching of a batch: (A, 4), (B, G, 4), (B, G) -> (B, A) gt
    index or -1."""
    iou, _ = box_iou(gt_boxes, anchors)                     # (B, G, A)
    return ssd_match(iou, iou_thresh, gt_valid)


def classification_terms(
    cls_logits: torch.Tensor,
    matched_idxs: torch.Tensor,
    gt_labels: torch.Tensor,
    neg_to_pos_ratio: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-anchor CE (B, A), the foreground mask and the mined negatives.

    CE is logsumexp minus the target's logit (the target is the matched
    gt's label on foreground anchors, 0 elsewhere). The negatives are the
    top neg_to_pos_ratio * positives of each image by CE, positives
    excluded: rank by a stable argsort of -CE, inverted by a scatter.
    """
    b, a, _ = cls_logits.shape
    fg = matched_idxs >= 0
    safe_idx = matched_idxs.clamp(0, gt_labels.shape[1] - 1)
    labels = torch.gather(gt_labels.long(), 1, safe_idx)
    targets = torch.where(fg, labels, 0)
    logz = torch.logsumexp(cls_logits, dim=-1)
    label_logit = torch.gather(cls_logits, 2, targets[..., None])[..., 0]
    ce = logz - label_logit

    num_neg = neg_to_pos_ratio * fg.sum(dim=1)              # (B,) float
    neg_loss = torch.where(fg, float("-inf"), ce.detach())
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    place = torch.arange(a, device=cls_logits.device).expand(b, a)
    rank = torch.empty_like(order).scatter_(1, order, place)
    bg = rank < num_neg[:, None]
    return ce, fg, bg


def multibox_loss(
    cls_logits: torch.Tensor,
    bbox_regression: torch.Tensor,
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    matched_idxs: Optional[torch.Tensor] = None,
    iou_thresh: float = 0.5,
    neg_to_pos_ratio: float = 3.0,
    box_coder_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0,
                                                           5.0),
) -> Dict[str, torch.Tensor]:
    """The SSD MultiBox loss over a padded batch.

    Args:
      cls_logits: (B, A, C), class 0 the background.
      bbox_regression: (B, A, 4) predicted deltas.
      anchors: (A, 4) xyxy, shared by the batch.
      gt_boxes: (B, G, 4) xyxy, zero-padded; gt_labels: (B, G) int,
        zero-padded; gt_valid: (B, G) bool.
      matched_idxs: optional precomputed (B, A) matching.

    Returns {'bbox_regression', 'classification'}: 0-d tensors on the
    logits' device.
    """
    if matched_idxs is None:
        matched_idxs = match_batch(anchors, gt_boxes, gt_valid, iou_thresh)
    b, a, _ = cls_logits.shape
    ce, fg, bg = classification_terms(cls_logits, matched_idxs, gt_labels,
                                      neg_to_pos_ratio)
    n = fg.sum().clamp(min=1).to(cls_logits.dtype)

    # the regression targets in float32 whatever the logits' dtype, as the
    # JAX package computes them
    safe_idx = matched_idxs.clamp(0, gt_boxes.shape[1] - 1)
    matched_gt = torch.gather(gt_boxes.to(torch.float32), 1,
                              safe_idx[..., None].expand(b, a, 4))
    target_reg = encode_boxes(matched_gt, anchors[None], box_coder_weights)
    reg_l = smooth_l1(bbox_regression - target_reg).sum(dim=-1)   # (B, A)
    bbox_loss = (reg_l * fg).sum() / n
    cls_loss = ((ce * fg).sum() + (ce * bg).sum()) / n
    return {"bbox_regression": bbox_loss, "classification": cls_loss}
