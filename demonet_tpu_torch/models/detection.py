"""The SSD meta-architecture (counterpart of demonet_tpu/models/detection.py).

  * `SSD` (nn.Module)        -- extractor + head => {'cls_logits',
                                'bbox_regression'} dense outputs.
  * `preprocess`             -- uint8 scaling, normalize, resize.
  * `postprocess_detections` -- softmax, decode, clip; per-class score
                                filter + top-k; class-wise NMS over
                                B x (C-1) problems; global top
                                detections_per_img; rescale to original
                                sizes.
  * `Detector`               -- module + config + anchors, with `predict`
                                (eval mode) and `loss` (train mode).

Detections come back as padded (B, detections_per_img) tensors with a
`valid` mask, as in the JAX package. The postprocess after softmax/decode
is gathers, sorts and comparisons only, so given the same scores and
boxes it is bit-equal to the reference. Its two hot steps run on the
hand-written CUDA kernels for CUDA tensors: the candidate and final row
gathers (`ops/gather.py`, csrc/gather.cu), the batched NMS (`ops/nms.py`,
csrc/nms.cu) and, with topk_impl "sparse" or "sparse_pallas", the
chunk-skipping top-k (`ops/topk.py`, csrc/topk.cu).

`impl="fused"` is the trained-model serving path (`_postprocess_fused`):
one candidate set per image instead of one per (image, class), with an
exact fallback to the reference pipeline.

Top-k tie order: `lax.top_k` breaks ties by the smaller index. The port
takes a stable descending `torch.sort` and slices, which gives the same
order; `torch.topk` promises none.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from demonet_tpu_torch.models.layers import compute_dtype
from demonet_tpu_torch.models.losses import multibox_loss
from demonet_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes
from demonet_tpu_torch.ops.gather import (
    gather_rows_batch,
    gather_rows_batch_plain,
)
from demonet_tpu_torch.ops.nms import nms_keep_batch, nms_keep_batch_plain
from demonet_tpu_torch.ops.topk import topk_sparse

_NEG_INF = -1e30


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

    @property
    def neg_to_pos_ratio(self) -> float:
        return (1.0 - self.positive_fraction) / self.positive_fraction


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


def to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 images scaled to [0, 1] in float32; other dtypes as they are."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) * np.float32(1.0 / 255.0)
    return images


def preprocess(images: torch.Tensor, config: SSDConfig,
               resize: bool = True) -> torch.Tensor:
    """Normalize (and optionally resize) a (B, H, W, 3) batch, NHWC.

    uint8 input is scaled to [0, 1] first. The resize is bilinear with
    half-pixel centers and no antialiasing, as in the JAX package. The
    mean and std are copied to the device on each call; the train step
    keeps its own on the device and calls `to_float` and the same
    arithmetic, so that it never waits on a host copy.
    """
    images = to_float(images)
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
    the CPU); 'plain' = the plain PyTorch version on any device. The
    wrapper takes contiguous tensors only: at B = 1 the scores come out of
    the per-class sort transposed in memory, so they are copied here.
    """
    if nms_impl == "auto":
        fn = nms_keep_batch
    elif nms_impl == "plain":
        fn = nms_keep_batch_plain
    else:
        raise ValueError(f"nms_impl must be 'auto' or 'plain', got {nms_impl!r}")
    return fn(cand_boxes.contiguous(), cand_scores.contiguous(),
              config.nms_thresh, _NEG_INF / 2)


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

    impl="fused" routes through the trained-model fast path
    (`_postprocess_fused`) with an exact fallback to the reference
    pipeline; topk_impl applies to the reference pipeline only.
    """
    if impl not in ("reference", "fused"):
        raise ValueError(
            f"impl must be 'reference' or 'fused', got {impl!r}")
    scores, boxes = _scores_and_boxes(cls_logits, bbox_regression, anchors,
                                      config)
    if impl == "fused":
        return _postprocess_fused(scores, boxes, config, original_sizes,
                                  nms_impl, gather_impl)
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

    topk_impl keeps the JAX package's names:
      * 'exact' and 'approx': a stable sort. The JAX 'approx'
        (`lax.approx_max_k`) exists only on the TPU; the exact top-k is
        within its contract.
      * 'sparse' and 'sparse_pallas': `ops.topk.topk_sparse`, the kernel
        csrc/topk.cu on CUDA and its plain version on the CPU. In the JAX
        package 'sparse' is `topk_sparse_xla`, an XLA formulation of the
        same function that was faster on the TPU than its Pallas kernel;
        it has no separate counterpart here. Entries at or below
        score_thresh come back as padding, which the filter below turns
        into the same -1e30 the exact top-k gives them, so the
        detections are bit-equal to 'exact'.
    """
    b, a, c = scores.shape
    k = min(config.topk_candidates, a)
    fg_scores = scores[..., 1:].transpose(1, 2)  # (B, C-1, A)
    if topk_impl in ("exact", "approx"):
        top_sc, top_idx = _sorted_topk(fg_scores, k)
    elif topk_impl in ("sparse", "sparse_pallas"):
        slots = max(8, -(-k // 128))
        top_sc, top_idx = topk_sparse(fg_scores.contiguous(), k,
                                      config.score_thresh, slots)
    else:
        raise ValueError("topk_impl must be 'exact', 'approx', 'sparse' or "
                         f"'sparse_pallas', got {topk_impl!r}")
    cand_boxes = _gather_rows(
        boxes, top_idx.reshape(b, -1), gather_impl).reshape(b, c - 1, k, 4)
    # score-threshold filter, strict >
    cand_sc = torch.where(top_sc > config.score_thresh, top_sc,
                          torch.full((), _NEG_INF, dtype=top_sc.dtype,
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
    neg = torch.full((), _NEG_INF, dtype=cand_sc.dtype, device=cand_sc.device)

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
    return _pad_and_rescale(out_boxes, out_scores, out_labels, valid, config,
                            original_sizes)


def _pad_and_rescale(out_boxes: torch.Tensor, out_scores: torch.Tensor,
                     out_labels: torch.Tensor, valid: torch.Tensor,
                     config: SSDConfig, original_sizes: Optional[torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Pad the detections below to detections_per_img and rescale the
    boxes to the original image sizes, when given."""
    pad = config.detections_per_img - valid.shape[1]
    if pad > 0:
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_labels = F.pad(out_labels, (0, pad))
        out_scores = F.pad(out_scores, (0, pad))
        valid = F.pad(valid, (0, pad))

    if original_sizes is not None:
        # times the float32 reciprocal of the network size: XLA compiles
        # the JAX package's division by the constant size so, and the
        # true quotient differs in the last bit (at 96, 640 / 96)
        h, w = config.size
        inv = np.float32(1.0) / np.asarray([h, w], np.float32)
        ratio = original_sizes.to(device=out_boxes.device,
                                  dtype=torch.float32) * torch.from_numpy(
            inv).to(out_boxes.device)
        scale = torch.stack(
            [ratio[:, 1], ratio[:, 0], ratio[:, 1], ratio[:, 0]], dim=-1)
        out_boxes = out_boxes * scale[:, None, :]

    return {"boxes": out_boxes, "scores": out_scores,
            "labels": out_labels, "valid": valid}


# Per-image live-candidate capacities of the fused path, tried smallest
# first per batch (the JAX package's values and reasons, detection.py:300).
_FUSED_TIERS = (1024, 2048)
# 128-score chunk budget per image (detection.py:315)
_FUSED_SLOTS = 192


class _FusedSizes(NamedTuple):
    """The fused path's static sizes for (B, A, C) scores: Python ints
    from the config and the shapes, computed once outside any branch."""

    b: int
    a: int
    c: int
    n: int          # (C - 1) * A entries of an image's flattened row
    n_chunks: int   # 128-wide chunks of that row
    slots: int      # chunks the path gathers
    cap: int        # the per-class topk_candidates cap
    tiers: Tuple[int, ...]


def _fused_sizes(shape: Tuple[int, int, int], config: SSDConfig
                 ) -> _FusedSizes:
    b, a, c = (int(v) for v in shape)
    n = (c - 1) * a
    n_chunks = -(-n // 128)
    slots = min(_FUSED_SLOTS, n_chunks)
    tiers = tuple(sorted({min(max(t, config.detections_per_img), n,
                              slots * 128) for t in _FUSED_TIERS}))
    return _FusedSizes(b, a, c, n, n_chunks, slots,
                       min(config.topk_candidates, a), tiers)


def _fused_guards(scores: torch.Tensor, config: SSDConfig, sz: _FusedSizes
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused path's guards on the device: the largest live count of
    an image (the scores above score_thresh), and whether some image's
    live entries span more than the chunk budget."""
    live = (scores[..., 1:].transpose(1, 2) > config.score_thresh).reshape(
        sz.b, sz.n)
    chunk_has = F.pad(live, (0, sz.n_chunks * 128 - sz.n)).reshape(
        sz.b, sz.n_chunks, 128).any(dim=2)
    return live.sum(dim=1).amax(), (chunk_has.sum(dim=1) > sz.slots).any()


def _fused_capacity(scores: torch.Tensor, config: SSDConfig) -> Optional[int]:
    """The fused path's guards for one batch of (B, A, C) scores, read on
    the host.

    Returns the smallest tier R that holds every image's live count, or
    None when the batch must take the reference pipeline: some image
    holds more than the largest tier, or its live entries span more than
    the chunk budget. Two numbers, (max_live, chunk_bad), come back to the
    host: the one device-to-host sync of the eager fused path, in place
    of the JAX `lax.switch`.
    """
    sz = _fused_sizes(scores.shape, config)
    max_live, chunk_bad = _fused_guards(scores, config, sz)
    max_live, chunk_bad = torch.stack([max_live,
                                       chunk_bad.long()]).tolist()
    if chunk_bad:
        return None
    return next((t for t in sz.tiers if max_live <= t), None)


def _fused_candidates(scores: torch.Tensor, all_boxes: torch.Tensor,
                      config: SSDConfig, sz: _FusedSizes, r: int,
                      gather_impl: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The top r live entries of each image, as one NMS problem per image.

    Returns the class-offset boxes (B, r, 4) and scores (B, r) of the NMS
    problem (dead and capped entries at -1e30), the candidates' own boxes
    (B, r, 4) and their 0-based foreground classes (B, r). Its sizes
    come from `sz`, computed once for the batch.
    """
    b, a, n, n_chunks, slots, cap = sz.b, sz.a, sz.n, sz.n_chunks, \
        sz.slots, sz.cap
    n_pad = n_chunks * 128
    dev = scores.device
    neg = torch.full((), _NEG_INF, dtype=scores.dtype, device=dev)

    fg = scores[..., 1:].transpose(1, 2)                  # (B, C-1, A)
    flat = torch.where(fg > config.score_thresh, fg, neg).reshape(b, n)
    grouped = F.pad(flat, (0, n_pad - n), value=_NEG_INF).reshape(
        b, n_chunks, 128)
    chunk_has = (grouped > _NEG_INF).any(dim=2)           # (B, n_chunks)
    chunk_ids = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    ids = torch.where(chunk_has, chunk_ids[None], n_chunks)
    sel = torch.sort(ids, dim=1).values[:, :slots]        # ascending
    sel_c = sel.clamp(max=n_chunks - 1)
    g = torch.gather(grouped, 1, sel_c[:, :, None].expand(-1, -1, 128))
    g = torch.where((sel < n_chunks)[:, :, None], g, neg)
    lanes = torch.arange(128, dtype=torch.int64, device=dev)
    pos_full = (sel_c[:, :, None] * 128 + lanes).reshape(b, slots * 128)
    # stable descending sort: ties keep ascending slot order, which is
    # ascending global position (sel is ascending)
    sc, order = torch.sort(g.reshape(b, slots * 128), dim=1,
                           descending=True, stable=True)
    sc = sc[:, :r]
    pos = torch.gather(pos_full, 1, order[:, :r]).clamp(max=n - 1)
    cls = pos // a                                        # 0-based fg class
    boxes = _gather_rows(all_boxes, pos % a, gather_impl)  # (B, r, 4)

    # per-class rank: a stable sort by class keeps each class's candidates
    # in score order; rank = place - start of the class's segment
    cls_s, pos_s = torch.sort(cls, dim=1, stable=True)
    place = torch.arange(r, dtype=torch.int64, device=dev)[None].expand(b, r)
    boundary = torch.ones_like(cls_s, dtype=torch.bool)
    boundary[:, 1:] = cls_s[:, 1:] != cls_s[:, :-1]
    seg_start = torch.cummax(torch.where(boundary, place, 0), dim=1).values
    rank = torch.empty_like(pos_s).scatter_(1, pos_s, place - seg_start)
    valid = (sc > config.score_thresh) & (rank < cap)

    # class-offset trick: boxes of different classes never overlap
    offset = float(max(config.size)) + 2.0
    off = boxes + (cls.to(torch.float32) * offset)[..., None]
    return off, torch.where(valid, sc, neg), boxes, cls


def _postprocess_fused(
    scores: torch.Tensor,
    all_boxes: torch.Tensor,
    config: SSDConfig,
    original_sizes: Optional[torch.Tensor],
    nms_impl: str,
    gather_impl: str,
) -> Dict[str, torch.Tensor]:
    """Trained-model serving fast path: one candidate set per image.

    The counterpart of the JAX `_postprocess_fused` (detection.py:320),
    step for step:

      1. guards (`_fused_capacity`): the live count of every image must
         fit a tier R, and its live 128-wide chunks of the flattened
         (C-1) * A row the chunk budget; otherwise the batch takes the
         reference pipeline (exact top-k), so the result is exact on
         every input. Random weights are dense and always fall back;
      2. (`_fused_candidates`) sort the live chunk ids ascending, gather
         the first `slots` chunks, and take the top R of the gathered
         scores by a stable sort that carries each entry's global
         position: ascending chunks give ascending positions, so ties fall
         in the reference's order;
      3. the per-class rank from a stable sort by class and a cummax
         drops what the reference's per-class topk_candidates cap drops;
      4. gather the R candidates' boxes (csrc/gather.cu on CUDA) and run
         ONE class-offset NMS problem per image (csrc/nms.cu): boxes
         shifted by class * (max(size) + 2) never overlap across classes,
         so the keep set is the reference's class-wise one;
      5. top detections_per_img of the kept scores and the final gather.

    The JAX `lax.switch` over the tiers (detection.py:502-523) becomes,
    in eager use, one host read per batch in `_fused_capacity`: the
    branch is chosen in Python, and each batch counts one in
    `_postprocess_fused.branches` under 'tier_<R>' or 'fallback'. Under
    `torch.export` (`torch.compiler.is_compiling()`) the guards stay on
    the device and nested `torch.cond`s choose the branch inside the
    program (`_fused_switch`); nothing is counted. Either branch launches
    one NMS and two gathers.
    """
    sz = _fused_sizes(scores.shape, config)
    if torch.compiler.is_compiling():
        out = _fused_switch(scores, all_boxes, config, sz, nms_impl,
                            gather_impl)
        return _pad_and_rescale(*out, config, original_sizes)
    r = _fused_capacity(scores, config)
    counts = _postprocess_fused.branches
    if r is None:
        counts["fallback"] += 1
        return _postprocess_reference_core(
            scores, all_boxes, config, original_sizes, nms_impl, "exact",
            gather_impl)
    counts[f"tier_{r}"] += 1
    return _pad_and_rescale(
        *_fused_tier(scores, all_boxes, config, sz, r, nms_impl,
                     gather_impl), config, original_sizes)


def _fused_tier(scores: torch.Tensor, all_boxes: torch.Tensor,
                config: SSDConfig, sz: _FusedSizes, r: int, nms_impl: str,
                gather_impl: str) -> Tuple[torch.Tensor, ...]:
    """Steps 2-5 of the fused path at capacity r: the detections (boxes,
    scores, labels, valid), min(detections_per_img, r) of them an image,
    before padding and rescaling."""
    off, nms_sc, boxes, cls = _fused_candidates(scores, all_boxes, config,
                                                sz, r, gather_impl)
    keep = _nms_keep(off, nms_sc, config, nms_impl)       # (B, R)
    neg = torch.full((), _NEG_INF, dtype=nms_sc.dtype, device=nms_sc.device)
    out_sc, oidx = _sorted_topk(torch.where(keep, nms_sc, neg),
                                min(config.detections_per_img, r))
    valid_out = out_sc > _NEG_INF / 2
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out_boxes = torch.where(valid_out[..., None],
                            _gather_rows(boxes, oidx, gather_impl), zero)
    out_labels = torch.where(valid_out, torch.gather(cls, 1, oidx) + 1,
                             0).to(torch.int32)
    out_scores = torch.where(valid_out, out_sc, zero)
    return out_boxes, out_scores, out_labels, valid_out


def _fused_switch(scores: torch.Tensor, all_boxes: torch.Tensor,
                  config: SSDConfig, sz: _FusedSizes, nms_impl: str,
                  gather_impl: str) -> Tuple[torch.Tensor, ...]:
    """The fused path's branch chosen on the device, for `torch.export`:
    nested `torch.cond`s over the tiers, smallest first, and the
    reference pipeline, as the JAX `lax.switch` chooses. Each branch
    returns the padded detections (boxes, scores, labels, valid), not
    rescaled; the sizes it needs are Python ints closed over from `sz`."""
    max_live, chunk_bad = _fused_guards(scores, config, sz)
    d = config.detections_per_img

    def static(sc, bx):
        # views of the operands at their static shapes: `torch.cond`
        # traces its branches with symbolic operand sizes
        return sc.reshape(sz.b, sz.a, sz.c), bx.reshape(sz.b, sz.a, 4)

    def fallback(sc, bx):
        out = _postprocess_reference_core(*static(sc, bx), config, None,
                                          nms_impl, "exact", gather_impl)
        return out["boxes"], out["scores"], out["labels"], out["valid"]

    def tier(r):
        def branch(sc, bx):
            out = _fused_tier(*static(sc, bx), config, sz, r, nms_impl,
                              gather_impl)
            if r >= d:
                return out
            return tuple(_pad_and_rescale(*out, config, None).values())
        return branch

    def choose(i):
        if i == len(sz.tiers):
            return fallback
        return lambda sc, bx: torch.cond(max_live <= sz.tiers[i],
                                         tier(sz.tiers[i]), choose(i + 1),
                                         (sc, bx))

    return torch.cond(chunk_bad, fallback, choose(0), (scores, all_boxes))


_postprocess_fused.branches = collections.Counter()


@dataclasses.dataclass
class Detector:
    """A built detector: module + config + anchors (A, 4) xyxy pixels.

    The module holds its weights: `predict` and `loss` take images (and
    ground truth) only, and each puts the module in the mode it needs.
    `dtype` is the module's compute dtype (the builders' `dtype`): its
    head outputs come in it, and the postprocess casts them to float32
    first, so the kernels always see float32.
    """

    model: SSD
    config: SSDConfig
    anchors: np.ndarray

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.model)

    def predict(
        self,
        images: torch.Tensor,
        original_sizes: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Images (B, H, W, 3), float in [0, 1] or uint8 -> padded
        detections, on the model's device, in eval mode whatever mode the
        module was left in (as the JAX package passes train=False)."""
        device = self.device
        if self.model.training:
            self.model.eval()
        with torch.inference_mode():
            x = preprocess(torch.as_tensor(images, device=device), self.config)
            outputs = self.model(x)
            return postprocess_detections(
                outputs["cls_logits"], outputs["bbox_regression"],
                torch.as_tensor(self.anchors, device=device), self.config,
                original_sizes)

    def loss(
        self,
        images: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Training loss on a padded batch of normalized images, in train
        mode: returns (loss dict, the BN running statistics after this
        forward, by state_dict name). The statistics are updated in place
        in the module; the dict holds the module's own buffers."""
        if not self.model.training:
            self.model.train()
        outputs = self.model(images)
        losses = multibox_loss(
            outputs["cls_logits"], outputs["bbox_regression"],
            torch.as_tensor(self.anchors, device=images.device), gt_boxes,
            gt_labels, gt_valid, iou_thresh=self.config.iou_thresh,
            neg_to_pos_ratio=self.config.neg_to_pos_ratio,
            box_coder_weights=self.config.box_coder_weights)
        stats = {name: buf for name, buf in self.model.named_buffers()
                 if name.endswith(("running_mean", "running_var"))}
        return losses, stats
