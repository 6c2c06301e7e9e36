"""PASCAL VOC detection evaluation (official protocol), numpy.

A copy of demonet_tpu/data/voc_eval.py for the PyTorch port, which imports
nothing of the JAX package.

Capability parity with reference demonet/data/voc_eval.py:
  * voc_ap (:29-58): 11-point VOC07 metric and the AUC metric
  * voc_eval (:61-166): per-class TP/FP marking against difficult-aware
    ground truth, greedy max-IoU matching with the "already-taken" rule
  * the write-results-file + per-class AP summary flow of eval_voc.py
    (:50-96) as a VocEvaluator class with the same update/accumulate/
    summarize lifecycle as CocoEvaluator (dedups repeated image ids from
    padded distributed sharding, reference voc_eval.py:176-196)
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from recall/precision curves (reference voc_eval.py:29-58)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval(
    detections: np.ndarray,
    image_names: Sequence[str],
    annotations: Dict[str, List[Dict]],
    classname: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
):
    """Evaluate one class (reference voc_eval.py:61-166).

    Args:
      detections: (N, 6) rows [image_index, score, x1, y1, x2, y2] where
        image_index indexes into image_names.
      annotations: image name -> list of {'name', 'bbox', 'difficult'}.

    Returns (recall, precision, ap).
    """
    class_recs = {}
    npos = 0
    for name in image_names:
        objs = [o for o in annotations.get(name, []) if o["name"] == classname]
        bbox = np.asarray([o["bbox"] for o in objs]).reshape(-1, 4)
        difficult = np.asarray([o["difficult"] for o in objs], bool)
        npos += int((~difficult).sum())
        class_recs[name] = {
            "bbox": bbox, "difficult": difficult,
            "det": np.zeros(len(objs), bool)}

    if len(detections) == 0:
        return np.zeros(0), np.zeros(0), 0.0

    order = np.argsort(-detections[:, 1], kind="stable")
    detections = detections[order]
    nd = len(detections)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = class_recs[image_names[int(detections[d, 0])]]
        bb = detections[d, 2:6]
        bbgt = rec["bbox"]
        ovmax, jmax = -np.inf, -1
        if len(bbgt):
            ixmin = np.maximum(bbgt[:, 0], bb[0])
            iymin = np.maximum(bbgt[:, 1], bb[1])
            ixmax = np.minimum(bbgt[:, 2], bb[2])
            iymax = np.minimum(bbgt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (bbgt[:, 2] - bbgt[:, 0] + 1.0)
                   * (bbgt[:, 3] - bbgt[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / float(max(npos, 1))
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


class VocEvaluator:
    """update/accumulate/summarize evaluator over VOC ground truth.

    Mirrors the eval_voc.py flow (:50-96): accumulate per-class detections
    across batches, then compute per-class AP + mAP with the VOC07 metric.
    """

    def __init__(self, dataset, classes: Optional[Sequence[str]] = None,
                 use_07_metric: bool = True, ovthresh: float = 0.5,
                 output_dir: Optional[str] = None):
        from demonet_tpu_torch.data.voc import VOC_CLASSES

        self.classes = list(classes or VOC_CLASSES)
        self.image_names = list(dataset.image_names)
        self.annotations = dataset.annotations_by_name()
        self.use_07_metric = use_07_metric
        self.ovthresh = ovthresh
        self.output_dir = output_dir
        self._dets: Dict[int, Dict] = {}
        self.aps: Dict[str, float] = {}

    def update(self, results: Iterable[Dict]) -> None:
        for r in results:
            # image_id dedup (reference voc_eval.py:176-196)
            self._dets[int(r["image_id"])] = {
                "boxes": np.asarray(r["boxes"], np.float64).reshape(-1, 4),
                "scores": np.asarray(r["scores"], np.float64).reshape(-1),
                "labels": np.asarray(r["labels"], np.int64).reshape(-1),
            }

    def synchronize_between_processes(self, group=None) -> None:
        """Merge the detections of the processes of `group` (None: all of
        them) as the JAX package does: each process's dict pickled, the
        bytes all-gathered, and the dicts applied in rank order with
        `update`, so the last occurrence of an image id wins. The bytes
        unpickled are those this program's processes wrote."""
        import pickle

        from demonet_tpu_torch.parallel.dist import (
            all_gather_arrays,
            process_count,
        )

        if process_count(group) == 1:
            return
        payload = np.frombuffer(pickle.dumps(self._dets), np.uint8)
        sizes = all_gather_arrays(np.asarray(np.int64(len(payload))), group)
        buf = np.zeros(int(sizes.max()), np.uint8)
        buf[:len(payload)] = payload
        bufs = all_gather_arrays(buf, group)
        merged: Dict[int, Dict] = {}
        for size, b in zip(sizes, bufs):
            merged.update(pickle.loads(b[:int(size)].tobytes()))
        self._dets = merged

    def _write_results_files(self, per_class_rows: Dict[str, np.ndarray]):
        """VOCdevkit-style det_test_<cls>.txt files (voc_eval.py:169-211)."""
        os.makedirs(self.output_dir, exist_ok=True)
        for cls, rows in per_class_rows.items():
            if cls == "__background__":
                continue
            path = os.path.join(self.output_dir, f"det_test_{cls}.txt")
            with open(path, "w") as f:
                for r in rows:
                    name = self.image_names[int(r[0])]
                    # VOC format: 1-based pixel coords
                    f.write(f"{name} {r[1]:.3f} {r[2] + 1:.1f} "
                            f"{r[3] + 1:.1f} {r[4] + 1:.1f} {r[5] + 1:.1f}\n")

    def accumulate(self) -> None:
        rows_by_class: Dict[str, list] = {c: [] for c in self.classes}
        for img_id, det in self._dets.items():
            for box, score, label in zip(
                    det["boxes"], det["scores"], det["labels"]):
                cls = self.classes[int(label)]
                rows_by_class[cls].append(
                    [img_id, score, box[0], box[1], box[2], box[3]])
        self._rows_by_class = {
            c: np.asarray(v, np.float64).reshape(-1, 6)
            for c, v in rows_by_class.items()}
        if self.output_dir:
            self._write_results_files(self._rows_by_class)

    def summarize(self) -> Dict[str, float]:
        """Per-class AP + mAP printout (reference voc_eval.py:214-237)."""
        aps = {}
        for cls in self.classes:
            if cls == "__background__":
                continue
            _, _, ap = voc_eval(
                self._rows_by_class[cls], self.image_names, self.annotations,
                cls, self.ovthresh, self.use_07_metric)
            aps[cls] = ap
            print(f"AP for {cls} = {ap:.4f}")
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        print(f"Mean AP = {mean_ap:.4f}")
        self.aps = dict(aps, mAP=mean_ap)
        return self.aps
