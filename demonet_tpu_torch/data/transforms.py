"""SSD data-augmentation suite — numpy, host-side.

A copy of demonet_tpu/data/transforms.py for the PyTorch port, which imports
nothing of the JAX package.

Capability parity with reference demonet/data/transforms.py (the SSD paper
sec. 2.2 pipeline):
  * Compose (:20), RandomHorizontalFlip (:30)
  * RandomIoUCrop (:54-130): min-IoU options {0,.1,.3,.5,.7,.9,leave-as-is},
    scale 0.3-1, aspect ratio 0.5-2, 40 trials, center-in-crop + jaccard
    acceptance, box clipping
  * RandomZoomOut (:132-185): canvas 1-4x, per-channel fill
  * RandomPhotometricDistort (:190-237): brightness/contrast/saturation/hue
    jitter with the contrast-before-or-after coin flip + channel permute
  * ToFloat / Resize replacing torchvision ToTensor + the model transform's
    fixed-size resize

These stay on the host on purpose: they're branchy rejection-sampling loops
(SURVEY.md §7 "keep on host"). RNG is an explicit np.random.Generator so runs
are reproducible end-to-end.

Images are HWC numpy; uint8 until ToFloat. Targets are numpy dicts
('boxes' xyxy float32, 'labels' int64, ...). When 'masks' (N,H,W) or
'keypoints' (N,K,3) are present they are flipped/resized/cropped/padded
alongside the boxes (reference transforms.py:30-44, transform.py:27-53).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# COCO person keypoint left/right swap under horizontal flip
# (reference transforms.py:10-17 _flip_coco_person_keypoints).
_COCO_KP_FLIP_INDS = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def _flip_keypoints(kps: np.ndarray, width: float) -> np.ndarray:
    """(N, K, 3) [x, y, vis] -> horizontally flipped, COCO convention that
    invisible points stay zeroed (reference transforms.py:10-17)."""
    if kps.size == 0:
        return kps
    inds = _COCO_KP_FLIP_INDS if kps.shape[1] == 17 else list(range(kps.shape[1]))
    flipped = kps[:, inds].copy()
    flipped[..., 0] = width - flipped[..., 0]
    flipped[flipped[..., 2] == 0] = 0
    return flipped


def _resize_masks(masks: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(N, H, W) -> (N, nh, nw), EXACT parity with the reference's mask
    resize (transform.py:58-62): torch F.interpolate with the default
    mode='nearest' then a byte cast. Torch's nearest index map is
    src = min(floor(dst * in/out), in-1) — asymmetric, not center-based,
    and computed in float32 (e.g. 23 * float32(114/46) = 56.999996 -> 56,
    where float64 gives exactly 57.0). Oracle-tested against executed torch
    in tests/test_reference_oracle.py.
    """
    if masks.shape[0] == 0:
        return np.zeros((0, nh, nw), masks.dtype)
    h, w = masks.shape[1:3]
    ys = np.minimum(
        (np.arange(nh, dtype=np.float32)
         * (np.float32(h) / np.float32(nh))).astype(np.int64),
        h - 1)
    xs = np.minimum(
        (np.arange(nw, dtype=np.float32)
         * (np.float32(w) / np.float32(nw))).astype(np.int64),
        w - 1)
    return masks[:, ys[:, None], xs[None, :]]


def _scale_keypoints(kps: np.ndarray, sx: float, sy: float) -> np.ndarray:
    if kps.size == 0:
        return kps
    out = kps.copy()
    out[..., 0] *= sx
    out[..., 1] *= sy
    return out


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, image, target, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            image, target = t(image, target, rng)
        return image, target


class RandomHorizontalFlip:
    """Flip image + boxes with probability p (reference transforms.py:30-44)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, target, rng):
        if rng.random() < self.p:
            w = image.shape[1]
            image = image[:, ::-1].copy()
            boxes = target["boxes"].copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
            target = dict(target, boxes=boxes)
            if "masks" in target:
                target["masks"] = target["masks"][:, :, ::-1].copy()
            if "keypoints" in target:
                target["keypoints"] = _flip_keypoints(target["keypoints"], w)
        return image, target


class ToFloat:
    """uint8 [0,255] -> float32 [0,1] (the ToTensor scaling, transforms.py:47)."""

    def __call__(self, image, target, rng=None):
        return image.astype(np.float32) / 255.0, target


class Resize:
    """Resize image to a fixed (h, w) and scale boxes accordingly — the
    host half of the model transform (reference transform.py:150-173)."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, image, target, rng=None):
        import cv2

        h, w = image.shape[:2]
        nh, nw = self.size
        image = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
        if target is not None and len(target.get("boxes", ())):
            boxes = target["boxes"] * np.asarray(
                [nw / w, nh / h, nw / w, nh / h], np.float32)
            target = dict(target, boxes=boxes)
            if "masks" in target:
                target["masks"] = _resize_masks(target["masks"], nh, nw)
            if "keypoints" in target:
                target["keypoints"] = _scale_keypoints(
                    target["keypoints"], nw / w, nh / h)
        return image, target


class ResizeShortestEdge:
    """Aspect-preserving min/max-size resize — the reference transform's
    non-fixed mode (transform.py:150-173, _resize_image_and_masks:27-53):
    scale so the short side hits min_size unless the long side would exceed
    max_size."""

    def __init__(self, min_size: int = 800, max_size: int = 1333):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, image, target, rng=None):
        import cv2

        h, w = image.shape[:2]
        scale = self.min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        image = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
        if target is not None and len(target.get("boxes", ())):
            boxes = target["boxes"] * np.asarray(
                [nw / w, nh / h, nw / w, nh / h], np.float32)
            target = dict(target, boxes=boxes)
            if "masks" in target:
                target["masks"] = _resize_masks(target["masks"], nh, nw)
            if "keypoints" in target:
                target["keypoints"] = _scale_keypoints(
                    target["keypoints"], nw / w, nh / h)
        return image, target


class RandomIoUCrop:
    """SSD sampler crop (reference transforms.py:54-130)."""

    def __init__(self, min_scale: float = 0.3, max_scale: float = 1.0,
                 min_aspect_ratio: float = 0.5, max_aspect_ratio: float = 2.0,
                 sampler_options: Optional[List[float]] = None,
                 trials: int = 40):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.min_ar = min_aspect_ratio
        self.max_ar = max_aspect_ratio
        self.options = sampler_options or [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0]
        self.trials = trials

    def __call__(self, image, target, rng):
        if len(target["boxes"]) == 0:
            return image, target
        orig_h, orig_w = image.shape[:2]
        boxes = target["boxes"]
        while True:
            min_overlap = self.options[int(rng.integers(len(self.options)))]
            if min_overlap >= 1.0:  # leave-as-is option
                return image, target
            for _ in range(self.trials):
                r = self.min_scale + (self.max_scale - self.min_scale) * rng.random(2)
                new_w = int(orig_w * r[0])
                new_h = int(orig_h * r[1])
                if new_h == 0 or not (self.min_ar <= new_w / max(new_h, 1) <= self.max_ar):
                    continue
                r = rng.random(2)
                left = int((orig_w - new_w) * r[0])
                top = int((orig_h - new_h) * r[1])
                right, bottom = left + new_w, top + new_h
                if left == right or top == bottom:
                    continue
                cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
                cy = 0.5 * (boxes[:, 1] + boxes[:, 3])
                within = (left < cx) & (cx < right) & (top < cy) & (cy < bottom)
                if not within.any():
                    continue
                kept = boxes[within]
                # IoU of kept boxes vs crop rectangle
                ix = (np.minimum(kept[:, 2], right) - np.maximum(kept[:, 0], left)).clip(0)
                iy = (np.minimum(kept[:, 3], bottom) - np.maximum(kept[:, 1], top)).clip(0)
                inter = ix * iy
                area_b = (kept[:, 2] - kept[:, 0]) * (kept[:, 3] - kept[:, 1])
                iou = inter / (area_b + new_w * new_h - inter)
                if iou.max() < min_overlap:
                    continue
                new_boxes = kept.copy()
                new_boxes[:, 0::2] = (new_boxes[:, 0::2] - left).clip(0, new_w)
                new_boxes[:, 1::2] = (new_boxes[:, 1::2] - top).clip(0, new_h)
                new_target = dict(target, boxes=new_boxes,
                                  labels=target["labels"][within])
                for k in ("area", "iscrowd", "difficult"):
                    if k in target and len(target[k]) == len(within):
                        new_target[k] = target[k][within]
                if "masks" in target:
                    new_target["masks"] = (
                        target["masks"][within][:, top:bottom, left:right].copy())
                if "keypoints" in target:
                    kps = target["keypoints"][within].copy()
                    if kps.size:
                        kps[..., 0] -= left
                        kps[..., 1] -= top
                        # points falling outside the crop become invisible,
                        # COCO convention vis==0 -> x=y=0
                        oob = ((kps[..., 0] < 0) | (kps[..., 0] > new_w)
                               | (kps[..., 1] < 0) | (kps[..., 1] > new_h))
                        kps[oob] = 0
                    new_target["keypoints"] = kps
                return image[top:bottom, left:right].copy(), new_target


class RandomZoomOut:
    """Place the image on a larger canvas (reference transforms.py:132-185)."""

    def __init__(self, fill: Optional[Sequence[float]] = None,
                 side_range: Tuple[float, float] = (1.0, 4.0), p: float = 0.5):
        self.fill = np.asarray(fill if fill is not None else [0.0, 0.0, 0.0])
        if side_range[0] < 1.0 or side_range[0] > side_range[1]:
            raise ValueError(f"Invalid canvas side range {side_range}.")
        self.side_range = side_range
        self.p = p

    def __call__(self, image, target, rng):
        if rng.random() >= self.p:
            return image, target
        orig_h, orig_w = image.shape[:2]
        r = self.side_range[0] + rng.random() * (
            self.side_range[1] - self.side_range[0])
        canvas_w, canvas_h = int(orig_w * r), int(orig_h * r)
        rr = rng.random(2)
        left = int((canvas_w - orig_w) * rr[0])
        top = int((canvas_h - orig_h) * rr[1])
        canvas = np.empty((canvas_h, canvas_w, image.shape[2]), image.dtype)
        canvas[...] = self.fill.astype(image.dtype)
        canvas[top:top + orig_h, left:left + orig_w] = image
        boxes = target["boxes"].copy()
        boxes[:, 0::2] += left
        boxes[:, 1::2] += top
        target = dict(target, boxes=boxes)
        if "masks" in target:
            m = target["masks"]
            mc = np.zeros((m.shape[0], canvas_h, canvas_w), m.dtype)
            mc[:, top:top + orig_h, left:left + orig_w] = m
            target["masks"] = mc
        if "keypoints" in target and target["keypoints"].size:
            kps = target["keypoints"].copy()
            vis = kps[..., 2] > 0
            kps[..., 0] += np.where(vis, float(left), 0.0)
            kps[..., 1] += np.where(vis, float(top), 0.0)
            target["keypoints"] = kps
        return canvas, target


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    """b may be an array or a scalar (contrast blends against the mean)."""
    return (factor * a + (1.0 - factor) * b).clip(0, 255)


def _grayscale(img_f: np.ndarray) -> np.ndarray:
    return (0.2989 * img_f[..., 0] + 0.587 * img_f[..., 1]
            + 0.114 * img_f[..., 2])[..., None]


class RandomPhotometricDistort:
    """Brightness/contrast/saturation/hue jitter + channel permute
    (reference transforms.py:190-237)."""

    def __init__(self, contrast=(0.5, 1.5), saturation=(0.5, 1.5),
                 hue=(-0.05, 0.05), brightness=(0.875, 1.125), p: float = 0.5):
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.brightness = brightness
        self.p = p

    def _apply_hue(self, img: np.ndarray, shift: float) -> np.ndarray:
        import cv2

        hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
        # OpenCV hue range is [0, 180); shift is in turns of the color wheel
        hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                       + int(shift * 180)) % 180
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(img.dtype)

    def __call__(self, image, target, rng):
        img = image.astype(np.float32)
        r = rng.random(7)

        if r[0] < self.p:
            f = rng.uniform(*self.brightness)
            img = (img * f).clip(0, 255)

        def contrast(img):
            f = rng.uniform(*self.contrast)
            mean = _grayscale(img).mean()
            return _blend(img, mean, f)  # scalar blend, no full_like alloc

        contrast_before = r[1] < 0.5
        if contrast_before and r[2] < self.p:
            img = contrast(img)
        if r[3] < self.p:
            f = rng.uniform(*self.saturation)
            img = _blend(img, _grayscale(img), f)
        if r[4] < self.p:
            img = self._apply_hue(img, rng.uniform(*self.hue)).astype(np.float32)
        if not contrast_before and r[5] < self.p:
            img = contrast(img)
        if r[6] < self.p:
            perm = rng.permutation(img.shape[-1])
            img = img[..., perm]

        return img.astype(image.dtype) if image.dtype == np.uint8 else img, target
