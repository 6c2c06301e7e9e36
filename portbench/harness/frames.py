"""Seeded inputs: the streams of one run's seed, and "shapes" frames.

A shapes frame is noise in [0, 60) with 1-4 filled rectangles of sides in
[size/8, size/2) and colours in [40, 256), each rectangle a ground-truth
box labelled 1 + (sum of its colour) % 6: the frames the trained flagship
weights were trained on. The rectangles are drawn on the host, the noise
on the device in one call, and the pool lands in pinned host memory,
from which every request or step copies its batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# the streams drawn from one seed
FRAMES, WEIGHTS, SAMPLE = 1, 2, 3


def seed_state(seed: int, stream: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % 2 ** 64, stream])


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_state(seed, stream))


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_state(seed, stream).generate_state(1, np.uint64)[0]
                      >> np.uint64(1)))
    return g


def shapes(seed: int, n: int, size: int, max_gt: int, device
           ) -> Dict[str, torch.Tensor]:
    """{'images': (n, size, size, 3) uint8, 'gt_boxes': (n, max_gt, 4) xyxy
    float32, 'gt_labels': (n, max_gt) int32, 'gt_valid': (n, max_gt)
    bool}, on the host (pinned where `device` is a GPU)."""
    r = rng(seed, FRAMES)
    gen = torch_generator(seed, FRAMES, device)
    imgs = torch.randint(0, 60, (n, size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.zeros((n, max_gt), np.int32)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        for j in range(int(r.integers(1, 5))):
            bw, bh = (int(v) for v in r.integers(size // 8, size // 2, 2))
            x0 = int(r.integers(0, size - bw))
            y0 = int(r.integers(0, size - bh))
            colour = r.integers(40, 256, 3)
            imgs[i, y0:y0 + bh, x0:x0 + bw] = torch.as_tensor(
                colour.astype(np.uint8), device=device)
            boxes[i, j] = [x0, y0, x0 + bw, y0 + bh]
            labels[i, j] = 1 + int(colour.sum()) % 6
            valid[i, j] = True
    pin = torch.device(device).type == "cuda"
    out = {"images": imgs.cpu(), "gt_boxes": torch.from_numpy(boxes),
           "gt_labels": torch.from_numpy(labels),
           "gt_valid": torch.from_numpy(valid)}
    return {k: v.pin_memory() if pin else v for k, v in out.items()}
