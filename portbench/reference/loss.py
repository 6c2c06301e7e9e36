"""SSD matching and the MultiBox loss (SSD, arXiv:1512.02325, sec. 2.2).

Matching: an anchor takes the gt of highest IoU when that IoU is at least
the threshold, else it is background; then every valid gt is forced onto
its best anchor (where two gts share one, the larger gt index wins).
Loss: smooth-L1 (beta 1) of the encoded regression over foreground
anchors, plus the cross-entropy of foreground anchors and of the hardest
negatives, ranked by their CE (ties by anchor index) up to 3 per
positive of the image; both sums over N = max(1, positives in the batch).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from reference import boxes as box_ops


def match(anchors: torch.Tensor, gt_boxes: torch.Tensor,
          gt_valid: torch.Tensor, thr: float) -> torch.Tensor:
    """(A, 4), (B, G, 4), (B, G) -> (B, A) gt index or -1."""
    q = box_ops.iou(gt_boxes, anchors)                          # (B, G, A)
    q = torch.where(gt_valid[..., None], q, -1.0)
    best, arg = q.max(dim=1)
    matches = torch.where(best >= thr, arg, -1)
    best_anchor = q.argmax(dim=2)                               # (B, G)
    g = gt_boxes.shape[1]
    ids = torch.where(gt_valid, torch.arange(g, device=q.device), -1)
    forced = torch.full_like(matches, -1).scatter_reduce(
        1, best_anchor, ids, "amax")
    return torch.where(forced >= 0, forced, matches)


def multibox(cls_logits: torch.Tensor, bbox_regression: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor, thr: float,
             neg_per_pos: float, weights: Sequence[float]
             ) -> Dict[str, torch.Tensor]:
    """{'bbox_regression', 'classification'}: 0-d float32 tensors."""
    cls_logits = cls_logits.to(torch.float32)
    bbox_regression = bbox_regression.to(torch.float32)
    b, a, _ = cls_logits.shape
    m = match(anchors, gt_boxes, gt_valid, thr)
    fg = m >= 0
    idx = m.clamp(min=0)
    labels = torch.where(fg, torch.gather(gt_labels.long(), 1, idx), 0)
    ce = torch.logsumexp(cls_logits, -1) - torch.gather(
        cls_logits, 2, labels[..., None])[..., 0]
    hard = torch.where(fg, float("-inf"), ce.detach())
    order = torch.argsort(-hard, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(a, device=order.device).expand(b, a))
    bg = rank < (neg_per_pos * fg.sum(1))[:, None]
    n = fg.sum().clamp(min=1).to(torch.float32)
    gt = torch.gather(gt_boxes.to(torch.float32), 1,
                      idx[..., None].expand(b, a, 4))
    diff = (bbox_regression - box_ops.encode(gt, anchors[None], weights)).abs()
    reg = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    return {"bbox_regression": (reg * fg).sum() / n,
            "classification": ((ce * fg).sum() + (ce * bg).sum()) / n}
