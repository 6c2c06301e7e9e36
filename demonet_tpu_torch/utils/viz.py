"""Demo-time image loading and detection drawing (counterpart of
demonet_tpu/utils/viz.py; reference demonet/util/image_utils.py): numpy
and cv2, cv2 imported inside the functions that use it.

  * load_image (:7-27): file -> RGB float32 HWC in [0, 1], optionally
    resized and normalised
  * select_top_predictions (:30-35)
  * compute_colors_for_labels (:38-50), the same palette
  * overlay_boxes (:54-70), overlay_class_names (:73-103)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def load_image(
    path: str,
    size: Optional[Tuple[int, int]] = None,
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
    normalize: bool = False,
) -> np.ndarray:
    """Read an image file -> float32 RGB HWC in [0, 1] (resized to `size`
    (h, w) by cv2's bilinear rule and mean/std-normalised, if asked)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size is not None:
        img = cv2.resize(img, (size[1], size[0]),
                         interpolation=cv2.INTER_LINEAR)
    img = img.astype(np.float32) / 255.0
    if normalize:
        img = (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return img


def select_top_predictions(detections: Dict[str, np.ndarray],
                           threshold: float) -> Dict[str, np.ndarray]:
    """One image's detections with score > threshold (and valid, where a
    `valid` mask is given)."""
    keep = np.asarray(detections["scores"]) > threshold
    if "valid" in detections:
        keep &= np.asarray(detections["valid"])
    return {k: np.asarray(v)[keep] for k, v in detections.items()}


def compute_colors_for_labels(labels: np.ndarray) -> np.ndarray:
    """A fixed colour per class id."""
    palette = np.asarray([2 ** 25 - 1, 2 ** 15 - 1, 2 ** 21 - 1])
    colors = labels[:, None].astype(np.int64) * palette[None, :]
    return (colors % 255).astype(np.uint8)


def overlay_boxes(image: np.ndarray, boxes: np.ndarray,
                  labels: np.ndarray) -> np.ndarray:
    """Boxes drawn in their class's colour on a copy of a uint8 HWC
    image."""
    import cv2

    out = image.copy()
    colors = compute_colors_for_labels(np.asarray(labels))
    for box, color in zip(np.asarray(boxes), colors):
        x1, y1, x2, y2 = [int(v) for v in box]
        cv2.rectangle(out, (x1, y1), (x2, y2),
                      tuple(int(c) for c in color), 2)
    return out


def overlay_class_names(image: np.ndarray, boxes: np.ndarray,
                        labels: np.ndarray, scores: np.ndarray,
                        class_names: Sequence[str]) -> np.ndarray:
    """'name: score' captions drawn above the boxes on a copy of a uint8
    HWC image."""
    import cv2

    out = image.copy()
    for box, label, score in zip(np.asarray(boxes), np.asarray(labels),
                                 np.asarray(scores)):
        x, y = int(box[0]), max(int(box[1]) - 4, 10)
        text = f"{class_names[int(label)]}: {score:.2f}"
        cv2.putText(out, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1)
    return out
