"""Synthetic detection data — deterministic, generated on the fly.

A copy of demonet_tpu/data/synthetic.py for the PyTorch port, which imports
nothing of the JAX package.

Where no COCO/VOC archive is at hand, this dataset stands in
for them wherever an end-to-end run is needed: the train CLI
(`--dataset synthetic`), loader benchmarks (tools/bench_loader.py), and
the overfit acceptance test. Images are noise backgrounds with axis-
aligned filled rectangles; the rectangle bounds are the ground truth, so
a working train/predict/eval stack can drive AP to 1.0 on it.

Everything is a pure function of (seed, index): the dataset is picklable
and cheap to ship to loader worker processes, and two instances with the
same constructor arguments produce identical samples.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


class SyntheticDetection:
    """len()/[] detection dataset of procedurally drawn rectangles."""

    def __init__(self, n: int = 64, image_size: Tuple[int, int] = (320, 320),
                 num_classes: int = 7, max_objects: int = 4, seed: int = 0,
                 transforms=None, variable_size: bool = False):
        self.n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.max_objects = max_objects
        self.seed = seed
        self.transforms = transforms
        self.variable_size = variable_size

    def __len__(self) -> int:
        return self.n

    def _size(self, idx: int) -> Tuple[int, int]:
        if not self.variable_size:
            return self.image_size
        rng = np.random.default_rng([self.seed, idx, 2])
        h, w = self.image_size
        return (int(rng.integers(h // 2, h * 2)),
                int(rng.integers(w // 2, w * 2)))

    def _spec(self, idx: int) -> Dict:
        """Target without pixels (independent RNG stream from the noise
        background, so eval/metadata paths never pay for image drawing)."""
        h, w = self._size(idx)
        rng = np.random.default_rng([self.seed, idx, 1])
        k = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        for _ in range(k):
            bw = int(rng.integers(w // 8, w // 2))
            bh = int(rng.integers(h // 8, h // 2))
            x0 = int(rng.integers(0, w - bw))
            y0 = int(rng.integers(0, h - bh))
            boxes.append([x0, y0, x0 + bw, y0 + bh])
            labels.append(int(rng.integers(1, self.num_classes)))
        return {
            "boxes": np.asarray(boxes, np.float32),
            "labels": np.asarray(labels, np.int64),
            "image_id": idx,
            "orig_size": (h, w),
        }

    def _make(self, idx: int):
        target = self._spec(idx)
        h, w = target["orig_size"]
        rng = np.random.default_rng([self.seed, idx, 0])
        img = rng.integers(0, 60, (h, w, 3), np.uint8)
        for box, label in zip(target["boxes"], target["labels"]):
            x0, y0, x1, y1 = box.astype(int)
            color = np.asarray(
                [40 * label % 255, 80 + 50 * label % 175, 255 - 30 * label],
                np.uint8)
            img[y0:y1, x0:x1] = color
        return img, target

    def __getitem__(self, idx: int, rng=None):
        img, target = self._make(idx)
        if self.transforms is not None:
            img, target = self.transforms(img, target, rng)
        return img, target

    def get_height_and_width(self, idx: int) -> Tuple[int, int]:
        return self._size(idx)

    def ground_truth_for_eval(self) -> List[Dict]:
        out = []
        for idx in range(self.n):
            t = self._spec(idx)
            out.append({
                "image_id": idx,
                "boxes": t["boxes"].astype(np.float64),
                "labels": t["labels"],
                "iscrowd": np.zeros(len(t["labels"]), bool),
                "areas": ((t["boxes"][:, 2] - t["boxes"][:, 0])
                          * (t["boxes"][:, 3] - t["boxes"][:, 1])),
            })
        return out


class SyntheticJpegDetection(SyntheticDetection):
    """Synthetic dataset materialized as JPEG files on disk — exercises the
    full decode path (PIL/cv2 or the native C++ decoder via raw_item), for
    loader throughput measurement on hosts without COCO."""

    def __init__(self, root: str, n: int = 256,
                 image_size: Tuple[int, int] = (480, 640), **kw):
        super().__init__(n=n, image_size=image_size, **kw)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._ensure_files()

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, f"{idx:06d}.jpg")

    def _ensure_files(self) -> None:
        import cv2

        for idx in range(self.n):
            path = self._path(idx)
            if not os.path.exists(path):
                img, _ = self._make(idx)
                cv2.imwrite(path, img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 90])

    def __getitem__(self, idx: int, rng=None):
        import cv2

        img = cv2.imread(self._path(idx))[..., ::-1]
        target = self._spec(idx)
        if self.transforms is not None:
            img, target = self.transforms(img, target, rng)
        return img, target

    def raw_item(self, idx: int):
        with open(self._path(idx), "rb") as f:
            blob = f.read()
        return blob, self._spec(idx)
