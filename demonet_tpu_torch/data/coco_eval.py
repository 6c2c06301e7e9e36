"""COCO-style mAP evaluation, self-contained numpy (no pycocotools); a
copy of demonet_tpu/data/coco_eval.py, whose summaries it gives exactly.

Capability parity with the reference's CocoEvaluator
(demonet/data/coco_eval.py:23-352), which wraps pycocotools' COCOeval. This
image ships no pycocotools, so the COCO bbox evaluation protocol is
implemented from its published semantics:

  * IoU thresholds 0.50:0.05:0.95 (10), recall thresholds 0:0.01:1 (101)
  * area ranges all / small(<32^2) / medium / large, maxDets 1/10/100
  * greedy score-descending matching per (category, image); crowd ground
    truths are ignore-regions that may match many detections and use
    intersection-over-detection-area instead of IoU
  * precision envelope (monotone non-increasing) sampled at the recall grid
  * the standard 12-number summary printout
  * iou_type="keypoints": OKS similarity (pycocotools computeOks — COCO
    person sigmas, gt-area normalization, 2x-box distance for invisible
    gts, no-visible-keypoint gts as ignore-regions), maxDets 20,
    all/medium/large ranges, the 10-number keypoint summary

`synchronize_between_processes` returns in a single process. Across
processes it merges detections as the JAX package does, with a
fixed-layout array merge: each process packs its detections into one
contiguous numeric buffer (i64 header + img_ids/counts/boxes/scores/
labels [+ keypoints] sections, `_pack_detections`), the buffers ride a
padded uint8 all-gather (`parallel.dist.all_gather_arrays`), and every
process unpacks and merges in rank order, with no pickle (the reference
pickles arbitrary objects into a ByteTensor, misc.py:75-115). Repeated
image ids from padded sharding de-duplicate first-wins (reference
coco_eval.py:183-184 keeps unique ids).

Matching is vectorized: the greedy assignment is sequential in detections
(each choice consumes ground truths) but independent across the 10 IoU
thresholds x 4 area ranges, so all 40 problems run as one batched numpy
loop over detections. Golden-validated against hand-derived protocol
outputs and a scalar implementation (tests/test_coco_eval.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)

# keypoint (OKS) protocol: COCO person sigmas, maxDets 20, no small range
KPT_OKS_SIGMAS = np.asarray(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]) / 10.0
KPT_AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
KPT_MAX_DETS = (20,)


def _match_greedy(ious: np.ndarray, g_ignore: np.ndarray,
                  g_crowd: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """Batched greedy COCO matching.

    ious: (D, G) detection x gt overlaps (detections already score-sorted).
    g_ignore: (P, G) per-problem gt ignore flags.
    g_crowd: (G,) crowd flags (crowd gts stay available after matching).
    thr: (P,) effective IoU thresholds.
    Returns dtm: (P, D) matched gt index or -1.

    The protocol's scan (gts stably sorted non-ignored-first, running max
    updated on iou >= best, early break at the ignored suffix once a
    non-ignored match exists) is equivalent to: among still-available gts
    with iou >= thr, take the LAST argmax over non-ignored candidates if
    any exist, else the LAST argmax over ignored candidates — "last" in
    original gt order, which the stable sort preserves within each tier.
    Sequential in D (each match consumes a non-crowd gt), vectorized over P.
    """
    p_n = len(thr)
    d_n, g_n = ious.shape
    dtm = np.full((p_n, d_n), -1, np.int64)
    if d_n == 0 or g_n == 0:
        return dtm
    gt_taken = np.zeros((p_n, g_n), bool)
    not_crowd = ~g_crowd[None, :]
    thr_col = thr[:, None]
    neg_inf = -np.inf
    for d in range(d_n):
        iou_d = ious[d][None, :]                       # (1, G)
        avail = ~(gt_taken & not_crowd)                # (P, G)
        cand = avail & (iou_d >= thr_col)              # (P, G)
        cand_ni = cand & ~g_ignore
        cand_ig = cand & g_ignore
        # last argmax: argmax of the reversed masked row gives the last
        # maximal element in original order
        masked_ni = np.where(cand_ni, iou_d, neg_inf)[:, ::-1]
        masked_ig = np.where(cand_ig, iou_d, neg_inf)[:, ::-1]
        m_ni = g_n - 1 - np.argmax(masked_ni, axis=1)
        m_ig = g_n - 1 - np.argmax(masked_ig, axis=1)
        has_ni = cand_ni.any(axis=1)
        has_ig = cand_ig.any(axis=1)
        m = np.where(has_ni, m_ni, np.where(has_ig, m_ig, -1))
        rows = np.nonzero(m >= 0)[0]
        dtm[rows, d] = m[rows]
        gt_taken[rows, m[rows]] = True
    return dtm


def _as_kps(kps, n: int) -> np.ndarray:
    """Normalize a keypoints field to (N, K, 3): accepts (N, K, 3),
    COCO-flat (N, 3K), or empty."""
    a = np.asarray(kps, np.float64)
    if n == 0 or a.size == 0:
        return np.zeros((n, 0, 3))
    if a.ndim == 2:  # flat COCO [x1, y1, v1, ...] rows
        a = a.reshape(n, -1, 3)
    if a.ndim != 3 or a.shape[0] != n or a.shape[2] != 3:
        raise ValueError(f"keypoints shape {np.asarray(kps).shape} for "
                         f"{n} instances")
    return a


def _kp_extent_area(kps: np.ndarray) -> np.ndarray:
    """(N, K, 3) -> keypoint-extent area per instance — pycocotools
    loadRes's dt area for keypoint results (x/y extent over ALL
    keypoints)."""
    if kps.shape[1] == 0:
        return np.zeros(kps.shape[0])
    x, y = kps[:, :, 0], kps[:, :, 1]
    return (x.max(axis=1) - x.min(axis=1)) * (y.max(axis=1) - y.min(axis=1))


def _oks(d_kps: np.ndarray, g_kps: np.ndarray, g_boxes_xyxy: np.ndarray,
         g_areas: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """Object Keypoint Similarity (pycocotools computeOks semantics).

    d_kps: (D, K, 3); g_kps: (G, K, 3); g_areas: the annotation areas.
    For gts with no visible keypoint, distances are measured to the
    2x-expanded gt box (the computeOks z-clip branch).
    """
    d_n, g_n = len(d_kps), len(g_kps)
    if d_n == 0 or g_n == 0:
        return np.zeros((d_n, g_n))
    var = (sigmas * 2.0) ** 2                     # (K,)
    out = np.zeros((d_n, g_n))
    for j in range(g_n):
        xg, yg, vg = g_kps[j, :, 0], g_kps[j, :, 1], g_kps[j, :, 2]
        vis = vg > 0
        k1 = int(vis.sum())
        if k1 > 0:
            dx = d_kps[:, :, 0] - xg[None, :]     # (D, K)
            dy = d_kps[:, :, 1] - yg[None, :]
        else:
            bx0, by0, bx1, by1 = g_boxes_xyxy[j]
            w, h = bx1 - bx0, by1 - by0
            x0, x1 = bx0 - w, bx1 + w             # 2x-expanded box
            y0, y1 = by0 - h, by1 + h
            xd, yd = d_kps[:, :, 0], d_kps[:, :, 1]
            dx = np.clip(x0 - xd, 0, None) + np.clip(xd - x1, 0, None)
            dy = np.clip(y0 - yd, 0, None) + np.clip(yd - y1, 0, None)
        e = (dx ** 2 + dy ** 2) / var[None, :] / (
            g_areas[j] + np.spacing(1)) / 2.0
        if k1 > 0:
            e = e[:, vis]
        out[:, j] = np.exp(-e).sum(axis=1) / e.shape[1]
    return out


def _iou_xyxy(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU; for crowd gt, intersection / detection area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-10)


def _pack_detections(detections: Dict[int, Dict]) -> np.ndarray:
    """Per-host detections -> one contiguous uint8 buffer, fixed layout.

    Layout (little-endian, section lengths all derivable from the header):
      header   i64[3]                 [n_img, total_dets, total_kp_floats]
      img_ids  i64[n_img]
      counts   i64[n_img]             detections per image
      kp_dims  i64[n_img]             keypoints-per-instance K_i, -1 if none
      boxes    f64[total_dets * 4]
      scores   f64[total_dets]
      labels   i64[total_dets]
      kps      f64[total_kp_floats]   concat of (count_i * K_i * 3) blocks

    Pickle-free and numerically exact: float64 payloads travel as raw bytes
    (a jax f64 allgather would downcast to f32 with x64 disabled).
    """
    ids = sorted(detections)
    counts, kp_dims, boxes, scores, labels, kps = [], [], [], [], [], []
    for i in ids:
        d = detections[i]
        counts.append(len(d["scores"]))
        boxes.append(np.ascontiguousarray(d["boxes"], np.float64))
        scores.append(np.ascontiguousarray(d["scores"], np.float64))
        labels.append(np.ascontiguousarray(d["labels"], np.int64))
        if "keypoints" in d:
            k = np.ascontiguousarray(d["keypoints"], np.float64)
            kp_dims.append(k.shape[1] if k.ndim == 3 else 0)
            kps.append(k.reshape(-1))
        else:
            kp_dims.append(-1)
    total = int(np.sum(counts)) if counts else 0
    kp_flat = (np.concatenate(kps) if kps
               else np.zeros(0, np.float64))
    sections = [
        np.asarray([len(ids), total, kp_flat.size], np.int64),
        np.asarray(ids, np.int64),
        np.asarray(counts, np.int64),
        np.asarray(kp_dims, np.int64),
        (np.concatenate(boxes).reshape(-1) if boxes
         else np.zeros(0, np.float64)),
        (np.concatenate(scores) if scores else np.zeros(0, np.float64)),
        (np.concatenate(labels) if labels else np.zeros(0, np.int64)),
        kp_flat,
    ]
    return np.concatenate(
        [np.frombuffer(s.astype(s.dtype.newbyteorder("<")).tobytes(),
                       np.uint8) for s in sections])


def _unpack_detections(buf: np.ndarray) -> Dict[int, Dict]:
    """Inverse of `_pack_detections` (bit-exact round trip)."""
    buf = np.ascontiguousarray(buf, np.uint8)
    pos = [0]

    def take(n, dtype):
        d = np.dtype(dtype).newbyteorder("<")
        out = np.frombuffer(buf[pos[0]:pos[0] + n * d.itemsize].tobytes(), d)
        pos[0] += n * d.itemsize
        return out.astype(dtype)

    n_img, total, kp_floats = (int(x) for x in take(3, np.int64))
    img_ids = take(n_img, np.int64)
    counts = take(n_img, np.int64)
    kp_dims = take(n_img, np.int64)
    boxes = take(total * 4, np.float64).reshape(total, 4)
    scores = take(total, np.float64)
    labels = take(total, np.int64)
    kps = take(kp_floats, np.float64)
    out: Dict[int, Dict] = {}
    off = 0
    kp_off = 0
    for i in range(n_img):
        c = int(counts[i])
        det = {
            "boxes": boxes[off:off + c],
            "scores": scores[off:off + c],
            "labels": labels[off:off + c],
        }
        k = int(kp_dims[i])
        if k >= 0:
            det["keypoints"] = kps[kp_off:kp_off + c * k * 3].reshape(c, k, 3)
            kp_off += c * k * 3
        out[int(img_ids[i])] = det
        off += c
    assert off == total and kp_off == kp_floats
    return out


class CocoEvaluator:
    """Accumulates detections and computes COCO bbox mAP.

    Ground truth is registered once at construction as per-image dicts:
      {'image_id', 'boxes' (N,4 xyxy), 'labels' (N,), 'iscrowd' (N,),
       'areas' (N,)}  — 'areas' defaults to box area when absent.
    Detections arrive via update() as
      {'image_id', 'boxes' (M,4 xyxy), 'scores' (M,), 'labels' (M,)}.
    """

    def __init__(self, ground_truth: Iterable[Dict],
                 category_ids: Optional[Sequence[int]] = None,
                 iou_type: str = "bbox",
                 kpt_sigmas: Optional[np.ndarray] = None):
        if iou_type not in ("bbox", "keypoints"):
            raise ValueError(f"iou_type {iou_type!r}")  # segm: no mask heads
        self.iou_type = iou_type
        if iou_type == "keypoints":
            self.area_ranges = dict(KPT_AREA_RANGES)
            self.max_dets = KPT_MAX_DETS
            self.kpt_sigmas = np.asarray(
                kpt_sigmas if kpt_sigmas is not None else KPT_OKS_SIGMAS)
        else:
            self.area_ranges = dict(AREA_RANGES)
            self.max_dets = MAX_DETS
            self.kpt_sigmas = None
        self._area_lo_hi = (
            np.asarray([lo for lo, _ in self.area_ranges.values()]),
            np.asarray([hi for _, hi in self.area_ranges.values()]))
        self.gts: Dict[int, Dict] = {}
        cats = set()
        for g in ground_truth:
            img_id = int(g["image_id"])
            boxes = np.asarray(g["boxes"], np.float64).reshape(-1, 4)
            labels = np.asarray(g["labels"], np.int64).reshape(-1)
            iscrowd = np.asarray(
                g.get("iscrowd", np.zeros(len(labels))), bool).reshape(-1)
            areas = g.get("areas")
            if areas is None:
                areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            areas = np.asarray(areas, np.float64).reshape(-1)
            self.gts[img_id] = {
                "boxes": boxes, "labels": labels,
                "iscrowd": iscrowd, "areas": areas}
            if "boxes_unclipped" in g:
                # raw annotation bbox (pre image-bounds clip) — the box
                # computeOks expands for zero-visible-keypoint gts
                self.gts[img_id]["boxes_unclipped"] = np.asarray(
                    g["boxes_unclipped"], np.float64).reshape(-1, 4)
            if "keypoints" in g:
                self.gts[img_id]["keypoints"] = _as_kps(
                    g["keypoints"], len(labels))
            elif iou_type == "keypoints":
                raise ValueError(
                    f"iou_type='keypoints' but image {img_id} ground truth "
                    "has no 'keypoints'")
            cats.update(labels.tolist())
        self.category_ids = sorted(category_ids) if category_ids is not None \
            else sorted(cats)
        self.detections: Dict[int, Dict] = {}
        self._eval = None
        self.stats: Optional[np.ndarray] = None

    def update(self, results: Iterable[Dict]) -> None:
        for r in results:
            img_id = int(r["image_id"])
            det = {
                "boxes": np.asarray(r["boxes"], np.float64).reshape(-1, 4),
                "scores": np.asarray(r["scores"], np.float64).reshape(-1),
                "labels": np.asarray(r["labels"], np.int64).reshape(-1),
            }
            if "keypoints" in r:
                det["keypoints"] = _as_kps(r["keypoints"],
                                           len(det["labels"]))
            elif self.iou_type == "keypoints":
                raise ValueError("iou_type='keypoints' detections need a "
                                 "'keypoints' field")
            # first wins: the reference keeps the FIRST occurrence of a
            # duplicate image id (np.unique over the accumulated list,
            # coco_eval.py:183-184); duplicates come from padded
            # distributed sharding
            self.detections.setdefault(img_id, det)

    def synchronize_between_processes(self, group=None) -> None:
        """Merge the detection sets of the processes of `group` (None: all
        of them; reference coco_eval.py:52-55, misc.py:75-115, but a
        fixed-layout array merge, no pickle): every process gets the
        union, the first occurrence of an image id in rank order kept."""
        from demonet_tpu_torch.parallel.dist import (
            all_gather_arrays,
            process_count,
        )

        if process_count(group) == 1:
            return
        payload = _pack_detections(self.detections)
        sizes = all_gather_arrays(np.asarray(np.int64(len(payload))), group)
        buf = np.zeros(int(sizes.max()), np.uint8)
        buf[:len(payload)] = payload
        bufs = all_gather_arrays(buf, group)
        merged: Dict[int, Dict] = {}
        for size, b in zip(sizes, bufs):
            # first wins across ranks, as the reference's de-dup order
            for img_id, det in _unpack_detections(b[:int(size)]).items():
                merged.setdefault(img_id, det)
        self.detections = merged

    # ---- core evaluation ----

    def _evaluate_cat_img(self, cat: int, img_id: int):
        """Greedy-match all (area_range x iou_threshold) problems for one
        (category, image) pair in one vectorized pass.

        Protocol notes (COCOeval semantics):
          * detections sorted score-descending (stable) and truncated to
            max(MAX_DETS) BEFORE matching; smaller maxDets are per-image
            truncations applied later in accumulate().
          * a gt is "ignored" for a range if it is crowd or its area is
            outside the range; the per-detection scan prefers non-ignored
            gts, consumes non-crowd gts on match, ties go to the LATER gt
            (running max updates on >=), and the scan considers ignored gts
            only when no non-ignored candidate reached the threshold —
            the two-tier last-argmax in _match_greedy.
          * a detection is ignored if matched to an ignored gt, or
            unmatched with area outside the range.
        Returns None if the image has neither gt nor dt of this category,
        else dict(dt_scores (D,), dt_matched (A,T,D), dt_ignore (A,T,D),
        num_gt (A,)).
        """
        gt_all = self.gts.get(img_id)
        if gt_all is None:
            return None
        gm = gt_all["labels"] == cat
        det = self.detections.get(img_id)
        dm = (det["labels"] == cat) if det is not None else np.zeros(0, bool)
        if not gm.any() and not dm.any():
            return None

        g_boxes = gt_all["boxes"][gm]
        g_crowd = gt_all["iscrowd"][gm]
        g_area = gt_all["areas"][gm]
        g_kps = gt_all.get("keypoints")
        if g_kps is not None:
            g_kps = g_kps[gm]
        area_lo, area_hi = self._area_lo_hi  # (A,) each
        # (A, G): per-range gt ignore flags
        g_ignore = (g_crowd[None, :]
                    | (g_area[None, :] < area_lo[:, None])
                    | (g_area[None, :] > area_hi[:, None]))
        if self.iou_type == "keypoints":
            # gts without visible keypoints are ignore-regions
            # (pycocotools COCOeval._prepare: ignore |= num_keypoints == 0)
            no_vis = (g_kps[:, :, 2] > 0).sum(axis=1) == 0
            g_ignore = g_ignore | no_vis[None, :]
        num_gt = (~g_ignore).sum(axis=1).astype(np.int64)

        if dm.any():
            d_boxes = det["boxes"][dm]
            d_scores = det["scores"][dm]
            d_kps = det.get("keypoints")
            if d_kps is not None:
                d_kps = d_kps[dm]
        else:
            d_boxes = np.zeros((0, 4))
            d_scores = np.zeros(0)
            d_kps = None
        d_order = np.argsort(-d_scores, kind="mergesort")[:max(self.max_dets)]
        d_boxes, d_scores = d_boxes[d_order], d_scores[d_order]
        if d_kps is not None:
            d_kps = d_kps[d_order]

        a_n, t_n = len(self.area_ranges), len(IOU_THRS)
        d_n, g_n = len(d_boxes), len(g_boxes)
        if d_n == 0:
            return {
                "dt_scores": d_scores,
                "dt_matched": np.zeros((a_n, t_n, 0), bool),
                "dt_ignore": np.zeros((a_n, t_n, 0), bool),
                "num_gt": num_gt,
            }

        if self.iou_type == "keypoints":
            # pycocotools loadRes derives dt area from the keypoint extent
            # (keypoint results carry no bbox)
            d_area = _kp_extent_area(d_kps)
        else:
            d_area = ((d_boxes[:, 2] - d_boxes[:, 0])
                      * (d_boxes[:, 3] - d_boxes[:, 1]))
        d_oor = ((d_area[None, :] < area_lo[:, None])
                 | (d_area[None, :] > area_hi[:, None]))  # (A, D)
        d_oor_at = np.broadcast_to(d_oor[:, None, :], (a_n, t_n, d_n))

        if g_n == 0:
            # no gt of this category: every det is unmatched; ignored iff
            # out of the area range
            return {
                "dt_scores": d_scores,
                "dt_matched": np.zeros((a_n, t_n, d_n), bool),
                "dt_ignore": d_oor_at.copy(),
                "num_gt": num_gt,
            }

        if self.iou_type == "keypoints":
            g_oks_boxes = gt_all.get("boxes_unclipped")
            g_oks_boxes = (g_oks_boxes[gm] if g_oks_boxes is not None
                           else g_boxes)
            ious = _oks(d_kps, g_kps, g_oks_boxes, g_area, self.kpt_sigmas)
        else:
            ious = _iou_xyxy(d_boxes, g_boxes, g_crowd)

        # Stack (area, thr) into one problem axis P = A*T.
        thr_eff = np.minimum(IOU_THRS, 1 - 1e-10)
        p_thr = np.broadcast_to(thr_eff[None, :], (a_n, t_n)).reshape(-1)
        p_ignore = np.broadcast_to(
            g_ignore[:, None, :], (a_n, t_n, g_n)).reshape(-1, g_n)
        dtm = _match_greedy(ious, p_ignore, g_crowd, p_thr)  # (P, D)

        matched = dtm >= 0
        # detection ignored: matched to ignored gt, or unmatched + out of range
        matched_gt_ignored = np.take_along_axis(
            p_ignore, np.maximum(dtm, 0), axis=1) & matched
        dt_ignore = np.where(
            matched, matched_gt_ignored, d_oor_at.reshape(-1, d_n))

        return {
            "dt_scores": d_scores,
            "dt_matched": matched.reshape(a_n, t_n, d_n),
            "dt_ignore": dt_ignore.reshape(a_n, t_n, d_n),
            "num_gt": num_gt,
        }

    def _images_by_category(self) -> Dict[int, List[int]]:
        """cat -> sorted image ids with any gt or dt of that category
        (one pass; skips the quadratic empty-pair walk — pycocotools
        achieves the same via its index). Image order is sorted ids, which
        fixes the cross-image order of tied scores in accumulate()."""
        by_cat: Dict[int, set] = {c: set() for c in self.category_ids}
        for img_id in self.gts:
            for c in np.unique(self.gts[img_id]["labels"]).tolist():
                if c in by_cat:
                    by_cat[c].add(img_id)
        for img_id, d in self.detections.items():
            if img_id not in self.gts:
                continue  # dt for unknown image: dropped (loadRes rejects)
            for c in np.unique(d["labels"]).tolist():
                if c in by_cat:
                    by_cat[c].add(img_id)
        return {c: sorted(s) for c, s in by_cat.items()}

    def accumulate(self) -> None:
        k_n = len(self.category_ids)
        a_n = len(self.area_ranges)
        m_n = len(self.max_dets)
        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))
        by_cat = self._images_by_category()

        for ki, cat in enumerate(self.category_ids):
            per_img = [self._evaluate_cat_img(cat, i) for i in by_cat[cat]]
            per_img = [e for e in per_img if e is not None]
            if not per_img:
                continue
            num_gt_a = np.sum([e["num_gt"] for e in per_img], axis=0)
            for ai in range(a_n):
                num_gt = int(num_gt_a[ai])
                if num_gt == 0:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [e["dt_scores"][:max_det] for e in per_img])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e["dt_matched"][ai, :, :max_det] for e in per_img],
                        axis=1)[:, order]
                    ignored = np.concatenate(
                        [e["dt_ignore"][ai, :, :max_det] for e in per_img],
                        axis=1)[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(t_n):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        # precision envelope (monotone from the right)
                        pr_env = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(r_n)
                        valid = inds < len(pr_env)
                        q[valid] = pr_env[inds[valid]]
                        precision[ti, :, ki, ai, mi] = q
        self._eval = {"precision": precision, "recall": recall}

    def _summ(self, ap: bool, iou: Optional[float] = None,
              area: str = "all", max_det: int = 100) -> float:
        if self._eval is None:
            raise RuntimeError("accumulate() first")
        ai = list(self.area_ranges).index(area)
        mi = self.max_dets.index(max_det)
        if ap:
            s = self._eval["precision"][:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou))[0][0])
                s = s[ti:ti + 1]
        else:
            s = self._eval["recall"][:, :, ai, mi]
            if iou is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou))[0][0])
                s = s[ti:ti + 1]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        """Print the standard summary (12 lines bbox, 10 keypoints);
        return the stats dict."""
        if self.iou_type == "keypoints":
            defs = [
                ("AP", True, None, "all", 20),
                ("AP50", True, 0.5, "all", 20),
                ("AP75", True, 0.75, "all", 20),
                ("APm", True, None, "medium", 20),
                ("APl", True, None, "large", 20),
                ("AR", False, None, "all", 20),
                ("AR50", False, 0.5, "all", 20),
                ("AR75", False, 0.75, "all", 20),
                ("ARm", False, None, "medium", 20),
                ("ARl", False, None, "large", 20),
            ]
        else:
            defs = [
                ("AP", True, None, "all", 100),
                ("AP50", True, 0.5, "all", 100),
                ("AP75", True, 0.75, "all", 100),
                ("APs", True, None, "small", 100),
                ("APm", True, None, "medium", 100),
                ("APl", True, None, "large", 100),
                ("AR1", False, None, "all", 1),
                ("AR10", False, None, "all", 10),
                ("AR100", False, None, "all", 100),
                ("ARs", False, None, "small", 100),
                ("ARm", False, None, "medium", 100),
                ("ARl", False, None, "large", 100),
            ]
        stats = {}
        for name, ap, iou, area, md in defs:
            v = self._summ(ap, iou, area, md)
            stats[name] = v
            kind = "Average Precision" if ap else "Average Recall"
            metric = "(AP)" if ap else "(AR)"
            iou_str = f"{iou:0.2f}     " if iou is not None else "0.50:0.95"
            print(f" {kind:<18} {metric} @[ IoU={iou_str} | "
                  f"area={area:>6s} | maxDets={md:>3d} ] = {v:0.3f}")
        self.stats = np.asarray([stats[d[0]] for d in defs])
        return stats
