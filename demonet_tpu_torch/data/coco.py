"""COCO detection dataset — self-contained JSON parsing (no pycocotools).

A copy of demonet_tpu/data/coco.py for the PyTorch port, which imports
nothing of the JAX package.

Capability parity with reference demonet/data/coco.py:
  * target canonicalization: xywh->xyxy, degenerate-box filter, labels,
    image_id, area, iscrowd (ConvertCocoPolysToMask, coco.py:53-106)
  * remove images without annotations for training
    (_coco_remove_images_without_annotations, coco.py:109-146)
  * category filter/remap (FilterAndRemapCocoCategories, coco.py:18-50)
  * get_coco with the train2017/val2017 layout (coco.py:226-252)
  * the 91-slot CLASSES list with N/A holes (data/__init__.py:5-20)

Images load via PIL as RGB uint8 HWC numpy arrays; targets are numpy dicts.
All torch-specific machinery (masks-from-polygons, keypoints) is carried as
data fields where present; this detector family consumes boxes+labels.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

COCO_CLASSES = [
    '__background__', 'person', 'bicycle', 'car', 'motorcycle', 'airplane',
    'bus', 'train', 'truck', 'boat', 'traffic light', 'fire hydrant', 'N/A',
    'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse',
    'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'N/A', 'backpack',
    'umbrella', 'N/A', 'N/A', 'handbag', 'tie', 'suitcase', 'frisbee', 'skis',
    'snowboard', 'sports ball', 'kite', 'baseball bat', 'baseball glove',
    'skateboard', 'surfboard', 'tennis racket', 'bottle', 'N/A', 'wine glass',
    'cup', 'fork', 'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich',
    'orange', 'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake',
    'chair', 'couch', 'potted plant', 'bed', 'N/A', 'dining table', 'N/A',
    'N/A', 'toilet', 'N/A', 'tv', 'laptop', 'mouse', 'remote', 'keyboard',
    'cell phone', 'microwave', 'oven', 'toaster', 'sink', 'refrigerator',
    'N/A', 'book', 'clock', 'vase', 'scissors', 'teddy bear', 'hair drier',
    'toothbrush',
]


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class CocoDetection:
    """Map-style dataset over a COCO-format annotation file.

    __getitem__ -> (image uint8 HWC RGB, target dict with numpy
    'boxes' (N,4 xyxy float32), 'labels' (N,) int64, 'image_id' int,
    'area' (N,), 'iscrowd' (N,), 'orig_size' (h, w)).
    """

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        transforms: Optional[Callable] = None,
        remove_images_without_annotations: bool = False,
        category_ids: Optional[Sequence[int]] = None,
        return_masks: bool = False,
        return_keypoints: bool = False,
    ):
        self.img_folder = img_folder
        self.transforms = transforms
        self.return_masks = return_masks
        self.return_keypoints = return_keypoints

        with open(ann_file) as f:
            coco = json.load(f)

        self.images = {im["id"]: im for im in coco["images"]}
        self.cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.categories = {c["id"]: c for c in coco.get("categories", [])}

        anns_by_img: Dict[int, List[dict]] = {i: [] for i in self.images}
        for ann in coco.get("annotations", []):
            if category_ids is not None and ann["category_id"] not in category_ids:
                continue
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.anns_by_img = anns_by_img

        ids = sorted(self.images)
        if remove_images_without_annotations:
            # reference coco.py:109-146: drop empty / all-degenerate images
            ids = [i for i in ids if self._has_valid_annotation(anns_by_img[i])]
        self.ids = ids

    @staticmethod
    def _has_valid_annotation(anns: List[dict]) -> bool:
        anns = [a for a in anns if a.get("iscrowd", 0) == 0]
        if not anns:
            return False
        return any(a["bbox"][2] > 1 and a["bbox"][3] > 1 for a in anns)

    def __len__(self) -> int:
        return len(self.ids)

    def get_height_and_width(self, idx: int) -> Tuple[int, int]:
        """Fast aspect-ratio path (reference group_by_aspect_ratio.py:131)."""
        im = self.images[self.ids[idx]]
        return im["height"], im["width"]

    def _make_target(self, img_id: int, h: int, w: int) -> Dict:
        anns = [a for a in self.anns_by_img.get(img_id, [])
                if a.get("iscrowd", 0) == 0]
        boxes = np.asarray(
            [a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        # xywh -> xyxy, clamp (reference coco.py:67-73)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        labels = np.asarray([a["category_id"] for a in anns], np.int64)
        area = np.asarray([a.get("area", 0.0) for a in anns], np.float32)
        iscrowd = np.asarray([a.get("iscrowd", 0) for a in anns], np.int64)
        # degenerate filter (reference coco.py:85-90)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        target = {
            "boxes": boxes[keep], "labels": labels[keep],
            "area": area[keep], "iscrowd": iscrowd[keep],
            "image_id": img_id, "orig_size": (h, w),
        }
        if self.return_masks:
            # polygon -> binary mask rasterization (the reference converts
            # via pycocotools, coco.py:33-50; PIL rasterizes equivalently)
            masks = [
                _polygons_to_mask(a.get("segmentation", []), h, w)
                for a in anns]
            masks = (np.stack(masks) if masks
                     else np.zeros((0, h, w), bool))
            target["masks"] = masks[keep]
        if self.return_keypoints:
            # (N, K, 3) [x, y, visibility] (reference coco.py:77-82)
            kps = [np.asarray(a.get("keypoints", []), np.float32).reshape(-1, 3)
                   for a in anns]
            if kps:
                width = max((k.shape[0] for k in kps), default=0)
                kps = [np.pad(k, ((0, width - k.shape[0]), (0, 0)))
                       for k in kps]
                target["keypoints"] = np.stack(kps)[keep]
            else:
                target["keypoints"] = np.zeros((0, 0, 3), np.float32)
        return target

    def __getitem__(self, idx: int, rng=None):
        """rng: per-sample np.random.Generator for the augmentations —
        supplied by the loader so runs are reproducible end-to-end
        regardless of worker count (derived from (seed, epoch, idx))."""
        img_id = self.ids[idx]
        info = self.images[img_id]
        img = _load_image(os.path.join(self.img_folder, info["file_name"]))
        target = self._make_target(img_id, info["height"], info["width"])
        if self.transforms is not None:
            img, target = self.transforms(img, target, rng)
        return img, target

    def raw_item(self, idx: int):
        """(jpeg bytes or None, untransformed target) — the native-decode
        fast path (data/native.py)."""
        img_id = self.ids[idx]
        info = self.images[img_id]
        path = os.path.join(self.img_folder, info["file_name"])
        blob = None
        if path.lower().endswith((".jpg", ".jpeg")):
            with open(path, "rb") as f:
                blob = f.read()
        return blob, self._make_target(img_id, info["height"], info["width"])

    def ground_truth_for_eval(self) -> List[Dict]:
        """All ground truth (crowd included) for CocoEvaluator."""
        out = []
        for img_id in self.ids:
            info = self.images[img_id]
            h, w = info["height"], info["width"]
            anns = self.anns_by_img.get(img_id, [])
            boxes = np.asarray(
                [a["bbox"] for a in anns], np.float64).reshape(-1, 4)
            if len(boxes):
                boxes[:, 2:] += boxes[:, :2]
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            entry = {
                "image_id": img_id,
                "boxes": boxes,
                "labels": np.asarray([a["category_id"] for a in anns], np.int64),
                "iscrowd": np.asarray([a.get("iscrowd", 0) for a in anns], bool),
                "areas": np.asarray([a.get("area",
                                           (a["bbox"][2] * a["bbox"][3]))
                                     for a in anns], np.float64),
            }
            if self.return_keypoints:
                # pycocotools computeOks expands the RAW annotation bbox
                # (unclipped) for zero-visible-keypoint gts — carry it
                # separately from the clipped eval boxes
                raw = np.asarray(
                    [a["bbox"] for a in anns], np.float64).reshape(-1, 4)
                if len(raw):
                    raw[:, 2:] += raw[:, :2]
                entry["boxes_unclipped"] = raw
                # COCO-flat rows -> (N, K, 3) for
                # CocoEvaluator(iou_type='keypoints')
                kps = [np.asarray(a.get("keypoints", []),
                                  np.float64).reshape(-1, 3) for a in anns]
                width = max((k.shape[0] for k in kps), default=0)
                entry["keypoints"] = (
                    np.stack([np.pad(k, ((0, width - k.shape[0]), (0, 0)))
                              for k in kps])
                    if kps else np.zeros((0, 0, 3)))
            out.append(entry)
        return out


def _polygons_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation to a binary (h, w) mask."""
    from PIL import Image, ImageDraw

    img = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(img)
    if isinstance(segmentation, list):
        for poly in segmentation:
            if isinstance(poly, list) and len(poly) >= 6:
                draw.polygon([(poly[i], poly[i + 1])
                              for i in range(0, len(poly), 2)], fill=1)
    return np.asarray(img, bool)


def get_coco(root: str, image_set: str,
             transforms: Optional[Callable] = None,
             mode: str = "instances", **kwargs) -> CocoDetection:
    """train2017/val2017 layout (reference coco.py:226-252)."""
    anno_file = os.path.join(
        "annotations", f"{mode}_{image_set}2017.json")
    img_folder = os.path.join(root, f"{image_set}2017")
    return CocoDetection(
        img_folder, os.path.join(root, anno_file), transforms=transforms,
        remove_images_without_annotations=(image_set == "train"), **kwargs)


def get_coco_kp(root: str, image_set: str,
                transforms: Optional[Callable] = None) -> CocoDetection:
    """Keypoint variant (reference coco.py:254-255)."""
    return get_coco(root, image_set, transforms,
                    mode="person_keypoints", return_keypoints=True)
