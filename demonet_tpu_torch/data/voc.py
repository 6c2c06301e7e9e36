"""PASCAL VOC detection dataset (XML annotations), self-contained.

A copy of demonet_tpu/data/voc.py for the PyTorch port, which imports
nothing of the JAX package.

Capability parity with reference demonet/data/voc.py:
  * the 21-class VOC list (voc.py:9-15)
  * VOC->COCO-style target conversion incl. difficult/"ishard" flag
    (ConvertVOCtoCOCO, voc.py:7-55)
  * the VOCdevkit/VOC2007-2012 directory layout + ImageSets splits
    (torchvision VOCDetection semantics the reference wraps, voc.py:57-74)
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

VOC_CLASSES = (
    '__background__',
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat',
    'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor',
)
_CLASS_TO_IDX = {c: i for i, c in enumerate(VOC_CLASSES)}


def parse_voc_xml(path: str) -> Dict:
    """Parse one VOC annotation file -> dict (reference voc_eval.py:8-26)."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    objects = []
    for obj in root.findall("object"):
        bbox = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text.strip(),
            "difficult": int((obj.find("difficult").text or "0"))
            if obj.find("difficult") is not None else 0,
            # VOC pixel indices are 1-based (reference voc.py:33-38 style)
            "bbox": [
                float(bbox.find("xmin").text) - 1,
                float(bbox.find("ymin").text) - 1,
                float(bbox.find("xmax").text) - 1,
                float(bbox.find("ymax").text) - 1,
            ],
        })
    return {"height": h, "width": w, "objects": objects}


class VOCDetection:
    """Map-style VOC dataset yielding the same target schema as CocoDetection.

    Layout: root/VOC{year}/{JPEGImages, Annotations, ImageSets/Main}.
    """

    def __init__(
        self,
        root: str,
        year: str = "2007",
        image_set: str = "trainval",
        transforms: Optional[Callable] = None,
        keep_difficult: bool = True,
    ):
        self.transforms = transforms
        self.keep_difficult = keep_difficult
        voc_root = os.path.join(root, f"VOC{year}")
        split_file = os.path.join(
            voc_root, "ImageSets", "Main", f"{image_set}.txt")
        with open(split_file) as f:
            self.image_names = [ln.strip() for ln in f if ln.strip()]
        self.img_dir = os.path.join(voc_root, "JPEGImages")
        self.ann_dir = os.path.join(voc_root, "Annotations")

    def __len__(self) -> int:
        return len(self.image_names)

    def _target(self, name: str, idx: int) -> Tuple[Dict, Dict]:
        ann = parse_voc_xml(os.path.join(self.ann_dir, f"{name}.xml"))
        objs = ann["objects"]
        if not self.keep_difficult:
            objs = [o for o in objs if not o["difficult"]]
        boxes = np.asarray([o["bbox"] for o in objs], np.float32).reshape(-1, 4)
        labels = np.asarray(
            [_CLASS_TO_IDX[o["name"]] for o in objs], np.int64)
        difficult = np.asarray([o["difficult"] for o in objs], np.int64)
        target = {
            "boxes": boxes,
            "labels": labels,
            "iscrowd": np.zeros(len(objs), np.int64),
            "difficult": difficult,  # "ishard" in the reference (voc.py:44)
            "area": (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            if len(boxes) else np.zeros(0, np.float32),
            "image_id": idx,
            "image_name": name,
            "orig_size": (ann["height"], ann["width"]),
        }
        return ann, target

    def __getitem__(self, idx: int, rng=None):
        """rng: per-sample np.random.Generator (see CocoDetection)."""
        from demonet_tpu_torch.data.coco import _load_image

        name = self.image_names[idx]
        img = _load_image(os.path.join(self.img_dir, f"{name}.jpg"))
        _, target = self._target(name, idx)
        if self.transforms is not None:
            img, target = self.transforms(img, target, rng)
        return img, target

    def raw_item(self, idx: int):
        """(jpeg bytes, untransformed target) for the native-decode path."""
        name = self.image_names[idx]
        with open(os.path.join(self.img_dir, f"{name}.jpg"), "rb") as f:
            blob = f.read()
        _, target = self._target(name, idx)
        return blob, target

    def get_height_and_width(self, idx: int) -> Tuple[int, int]:
        ann = parse_voc_xml(
            os.path.join(self.ann_dir, f"{self.image_names[idx]}.xml"))
        return ann["height"], ann["width"]

    def annotations_by_name(self) -> Dict[str, List[Dict]]:
        """name -> object list, the shape voc_eval consumes."""
        out = {}
        for name in self.image_names:
            out[name] = parse_voc_xml(
                os.path.join(self.ann_dir, f"{name}.xml"))["objects"]
        return out
