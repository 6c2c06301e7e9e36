"""The SSD meta-architecture (counterpart of demonet_tpu/models/detection.py).

  * `SSD` (nn.Module)        -- extractor + head => {'cls_logits',
                                'bbox_regression'} dense outputs.
  * `preprocess`             -- uint8 scaling, normalize, resize.
  * `postprocess_detections` -- softmax, decode, clip; per-class score
                                filter + top-k; class-wise NMS over
                                B x (C-1) problems; global top
                                detections_per_img; rescale to original
                                sizes.
  * `Detector`               -- module + config + anchors, with `predict`.

Detections come back as padded (B, detections_per_img) tensors with a
`valid` mask, as in the JAX package. The postprocess after softmax/decode
is gathers, sorts and comparisons only, so given the same scores and
boxes it is bit-equal to the reference. Its two hot steps run on the
hand-written CUDA kernels for CUDA tensors: the candidate and final row
gathers (`ops/gather.py`, csrc/gather.cu) and the batched NMS
(`ops/nms.py`, csrc/nms.cu).

Top-k tie order: `lax.top_k` breaks ties by the smaller index. The port
takes a stable descending `torch.sort` and slices, which gives the same
order; `torch.topk` promises none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from demonet_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes
from demonet_tpu_torch.ops.gather import (
    gather_rows_batch,
    gather_rows_batch_plain,
)
from demonet_tpu_torch.ops.nms import nms_keep_batch, nms_keep_batch_plain

_NEG_INF = -1e30

_LATER = "a later slice of the PyTorch port (see ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Static detector hyper-parameters."""

    size: Tuple[int, int]  # (H, W) fixed network input
    num_classes: int
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    score_thresh: float = 0.01
    nms_thresh: float = 0.45
    detections_per_img: int = 200
    iou_thresh: float = 0.5
    topk_candidates: int = 400
    positive_fraction: float = 0.25
    box_coder_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)


class SSD(nn.Module):
    """extractor(images) -> multi-scale maps -> head -> dense predictions.

    Takes NHWC images (B, H, W, 3) and runs the convs NCHW. Output:
    {'cls_logits': (B, A, C), 'bbox_regression': (B, A, 4)}, A the total
    anchor count. The anchors themselves live in the `Detector`.
    """

    def __init__(self, extractor: nn.Module, head: nn.Module):
        super().__init__()
        self.extractor = extractor
        self.head = head

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.head(self.extractor(images.permute(0, 3, 1, 2)))


def preprocess(images: torch.Tensor, config: SSDConfig,
               resize: bool = True) -> torch.Tensor:
    """Normalize (and optionally resize) a (B, H, W, 3) batch, NHWC.

    uint8 input is scaled to [0, 1] first. The resize is bilinear with
    half-pixel centers and no antialiasing, as in the JAX package.
    """
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * np.float32(1.0 / 255.0)
    mean = torch.tensor(config.image_mean, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(config.image_std, dtype=images.dtype,
                       device=images.device)
    x = (images - mean) / std
    if resize and tuple(x.shape[1:3]) != tuple(config.size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(config.size),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1)
    return x


def _nms_keep(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
              config: SSDConfig, nms_impl: str) -> torch.Tensor:
    """Keep mask for (P, K) score-sorted candidate sets.

    'auto' = the kernel wrapper (csrc/nms.cu on CUDA, the plain version on
    the CPU); 'plain' = the plain PyTorch version on any device.
    """
    if nms_impl == "auto":
        fn = nms_keep_batch
    elif nms_impl == "plain":
        fn = nms_keep_batch_plain
    else:
        raise ValueError(f"nms_impl must be 'auto' or 'plain', got {nms_impl!r}")
    return fn(cand_boxes, cand_scores, config.nms_thresh, _NEG_INF / 2)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor,
                 gather_impl: str) -> torch.Tensor:
    """out[b, r] = table[b, idx[b, r]].

    'auto' = the kernel wrapper (csrc/gather.cu on CUDA, torch.gather on
    the CPU); 'plain' = torch.gather on any device.
    """
    if gather_impl == "auto":
        fn = gather_rows_batch
    elif gather_impl == "plain":
        fn = gather_rows_batch_plain
    else:
        raise ValueError(
            f"gather_impl must be 'auto' or 'plain', got {gather_impl!r}")
    return fn(table.contiguous(), idx.to(torch.int32).contiguous())


def _sorted_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, descending, ties to the smaller index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def postprocess_detections(
    cls_logits: torch.Tensor,
    bbox_regression: torch.Tensor,
    anchors: torch.Tensor,
    config: SSDConfig,
    original_sizes: Optional[torch.Tensor] = None,
    nms_impl: str = "auto",
    topk_impl: str = "exact",
    gather_impl: str = "auto",
    impl: str = "reference",
) -> Dict[str, torch.Tensor]:
    """Batched decode + class-wise NMS (+ rescale to original image sizes).

    Args:
      cls_logits: (B, A, C); bbox_regression: (B, A, 4); anchors: (A, 4).
      original_sizes: optional (B, 2) (h, w) per image; when given, boxes
        are rescaled from network-input coordinates to the original frame.

    Returns {'boxes': (B, D, 4), 'scores': (B, D), 'labels': (B, D) int32,
             'valid': (B, D) bool}.
    """
    if impl != "reference":
        raise NotImplementedError(
            f"impl={impl!r} (fused serving) comes in {_LATER}")
    scores, boxes = _scores_and_boxes(cls_logits, bbox_regression, anchors,
                                      config)
    return _postprocess_reference_core(
        scores, boxes, config, original_sizes, nms_impl, topk_impl,
        gather_impl)


def _scores_and_boxes(cls_logits: torch.Tensor, bbox_regression: torch.Tensor,
                      anchors: torch.Tensor, config: SSDConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax scores (B, A, C) and decoded, clipped boxes (B, A, 4)."""
    scores = torch.softmax(cls_logits.to(torch.float32), dim=-1)
    boxes = decode_boxes(bbox_regression.to(torch.float32), anchors[None],
                         config.box_coder_weights)
    return scores, clip_boxes_to_image(boxes, config.size)


def _select_candidates(scores: torch.Tensor, boxes: torch.Tensor,
                       config: SSDConfig, topk_impl: str, gather_impl: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (image, class): the top-k anchors by score, their boxes, and
    their scores with those at or below score_thresh set to -1e30.

    Returns cand_boxes (B, C-1, k, 4) and cand_sc (B, C-1, k).
    """
    if topk_impl != "exact":
        raise NotImplementedError(
            f"topk_impl={topk_impl!r} comes in {_LATER}; only 'exact' is "
            "ported")
    b, a, c = scores.shape
    k = min(config.topk_candidates, a)
    fg_scores = scores[..., 1:].transpose(1, 2)  # (B, C-1, A)
    top_sc, top_idx = _sorted_topk(fg_scores, k)
    cand_boxes = _gather_rows(
        boxes, top_idx.reshape(b, -1), gather_impl).reshape(b, c - 1, k, 4)
    # score-threshold filter, strict >
    cand_sc = torch.where(top_sc > config.score_thresh, top_sc,
                          torch.tensor(_NEG_INF, dtype=top_sc.dtype,
                                       device=top_sc.device))
    return cand_boxes, cand_sc


def _postprocess_reference_core(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    config: SSDConfig,
    original_sizes: Optional[torch.Tensor],
    nms_impl: str,
    topk_impl: str,
    gather_impl: str,
) -> Dict[str, torch.Tensor]:
    """The reference pipeline after softmax/decode/clip: (B, A, C) scores
    and (B, A, 4) boxes in, padded detections out."""
    b, _, c = scores.shape
    cand_boxes, cand_sc = _select_candidates(scores, boxes, config, topk_impl,
                                             gather_impl)
    k = cand_sc.shape[-1]
    neg = torch.tensor(_NEG_INF, dtype=cand_sc.dtype, device=cand_sc.device)

    keep = _nms_keep(
        cand_boxes.reshape(b * (c - 1), k, 4),
        cand_sc.reshape(b * (c - 1), k),
        config, nms_impl).reshape(b, c - 1, k)

    flat_sc = torch.where(keep, cand_sc, neg).reshape(b, -1)

    d = config.detections_per_img
    d2 = min(d, (c - 1) * k)  # pad below if fewer candidate slots than D
    out_scores, out_idx = _sorted_topk(flat_sc, d2)  # (B, D)
    valid = out_scores > _NEG_INF / 2
    # labels need no gather: the flat index encodes (class, candidate)
    out_boxes = _gather_rows(
        cand_boxes.reshape(b, (c - 1) * k, 4), out_idx, gather_impl)
    zero = torch.zeros((), dtype=out_boxes.dtype, device=out_boxes.device)
    out_boxes = torch.where(valid[..., None], out_boxes, zero)
    out_labels = torch.where(valid, (out_idx // k).to(torch.int32) + 1,
                             torch.zeros_like(out_idx, dtype=torch.int32))
    out_scores = torch.where(valid, out_scores, zero)
    if d2 < d:
        out_boxes = F.pad(out_boxes, (0, 0, 0, d - d2))
        out_labels = F.pad(out_labels, (0, d - d2))
        out_scores = F.pad(out_scores, (0, d - d2))
        valid = F.pad(valid, (0, d - d2))

    if original_sizes is not None:
        h, w = config.size
        ratio = original_sizes.to(device=out_boxes.device,
                                  dtype=torch.float32) / torch.tensor(
            [h, w], dtype=torch.float32, device=out_boxes.device)
        scale = torch.stack(
            [ratio[:, 1], ratio[:, 0], ratio[:, 1], ratio[:, 0]], dim=-1)
        out_boxes = out_boxes * scale[:, None, :]

    return {"boxes": out_boxes, "scores": out_scores,
            "labels": out_labels, "valid": valid}


@dataclasses.dataclass
class Detector:
    """A built detector: module + config + anchors (A, 4) xyxy pixels.

    The module holds its weights; `predict` takes images only.
    """

    model: SSD
    config: SSDConfig
    anchors: np.ndarray

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def predict(
        self,
        images: torch.Tensor,
        original_sizes: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Images (B, H, W, 3), float in [0, 1] or uint8 -> padded
        detections, on the model's device."""
        device = self.device
        with torch.inference_mode():
            x = preprocess(torch.as_tensor(images, device=device), self.config)
            outputs = self.model(x)
            return postprocess_detections(
                outputs["cls_logits"], outputs["bbox_regression"],
                torch.as_tensor(self.anchors, device=device), self.config,
                original_sizes)
