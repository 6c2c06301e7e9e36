"""Detections from head outputs: softmax, decode, clip; per (image,
class) the top-k anchors by score (a stable descending sort: ties go to
the smaller anchor index), scores at or below the threshold dropped;
greedy NMS in score order (a box is suppressed by an earlier kept box of
its class whose IoU with it is above the threshold); the image's top
`detections_per_img` survivors over all classes, padded.

Every step is exact given the scores and boxes: sorts, gathers and
comparisons, with the IoU computed as inter / max(area_i + area_j -
inter, 1e-9). `stages` returns the intermediate tensors the benchmark's
work counts read.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import boxes as box_ops

NEG = -1e30


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
               score_thr: float) -> torch.Tensor:
    """Keep mask (P, K) of P score-sorted problems of K boxes; entries
    with score <= score_thr are padding, never kept."""
    p, k, _ = boxes.shape
    live = scores > score_thr
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    removed = ~live
    idx = torch.arange(k, device=boxes.device)
    last = int((live * (idx + 1)).amax()) if p * k else 0
    for i in range(last):
        iw = (torch.minimum(x2, x2[:, i:i + 1])
              - torch.maximum(x1, x1[:, i:i + 1])).clamp(min=0.0)
        ih = (torch.minimum(y2, y2[:, i:i + 1])
              - torch.maximum(y1, y1[:, i:i + 1])).clamp(min=0.0)
        inter = iw * ih
        over = inter / (area + area[:, i:i + 1] - inter).clamp(min=1e-9)
        removed |= ~removed[:, i:i + 1] & (over > iou_thr) & (idx > i)
    return ~removed


def stages(cls_logits: torch.Tensor, bbox_regression: torch.Tensor,
           anchors: torch.Tensor, cfg: dict) -> Dict[str, torch.Tensor]:
    """The pipeline's tensors: 'scores' (B, A, C), 'boxes' (B, A, 4),
    'cand_boxes' (B, C-1, k, 4), 'cand_scores' (B, C-1, k), 'keep'
    (B, C-1, k) and the detections 'det_boxes', 'det_scores',
    'det_labels' (int32), 'det_valid' (B, D)."""
    scores = torch.softmax(cls_logits.to(torch.float32), dim=-1)
    deltas = bbox_regression.to(torch.float32)
    boxes = box_ops.clip(box_ops.decode(deltas, anchors[None],
                                        cfg["box_coder_weights"]),
                         tuple(cfg["size"]))
    b, a, c = scores.shape
    k = min(cfg["topk_candidates"], a)
    fg = scores[..., 1:].transpose(1, 2)
    top, top_idx = torch.sort(fg, dim=-1, descending=True, stable=True)
    top, top_idx = top[..., :k], top_idx[..., :k]
    cand_boxes = torch.gather(
        boxes, 1, top_idx.reshape(b, -1, 1).expand(-1, -1, 4)
    ).reshape(b, c - 1, k, 4)
    neg = torch.full((), NEG, dtype=top.dtype, device=top.device)
    cand = torch.where(top > cfg["score_thresh"], top, neg)
    keep = greedy_nms(cand_boxes.reshape(b * (c - 1), k, 4),
                      cand.reshape(b * (c - 1), k), cfg["nms_thresh"],
                      NEG / 2).reshape(b, c - 1, k)
    flat = torch.where(keep, cand, neg).reshape(b, -1)
    d = min(cfg["detections_per_img"], (c - 1) * k)
    out_sc, out_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    out_sc, out_idx = out_sc[:, :d], out_idx[:, :d]
    valid = out_sc > NEG / 2
    out_boxes = torch.gather(cand_boxes.reshape(b, -1, 4), 1,
                             out_idx[..., None].expand(-1, -1, 4))
    zero = torch.zeros((), dtype=out_boxes.dtype, device=out_boxes.device)
    out_boxes = torch.where(valid[..., None], out_boxes, zero)
    labels = torch.where(valid, (out_idx // k).to(torch.int32) + 1,
                         torch.zeros_like(out_idx, dtype=torch.int32))
    out_sc = torch.where(valid, out_sc, zero)
    pad = cfg["detections_per_img"] - d
    if pad > 0:
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        out_sc = torch.nn.functional.pad(out_sc, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return {"scores": scores, "boxes": boxes, "cand_boxes": cand_boxes,
            "cand_scores": cand, "keep": keep, "det_boxes": out_boxes,
            "det_scores": out_sc, "det_labels": labels, "det_valid": valid}


def detections(cls_logits: torch.Tensor, bbox_regression: torch.Tensor,
               anchors: torch.Tensor, cfg: dict) -> Dict[str, torch.Tensor]:
    """{'boxes', 'scores', 'labels', 'valid'} (B, D, ...)."""
    s = stages(cls_logits, bbox_regression, anchors, cfg)
    return {"boxes": s["det_boxes"], "scores": s["det_scores"],
            "labels": s["det_labels"], "valid": s["det_valid"]}
