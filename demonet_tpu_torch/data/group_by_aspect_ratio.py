"""Aspect-ratio grouped batching (reference demonet/data/group_by_aspect_ratio.py).

A copy of demonet_tpu/data/group_by_aspect_ratio.py for the PyTorch port, which imports
nothing of the JAX package.

With the fixed-size resize this is a *padding optimization only*
(SURVEY.md §7): batches of same-orientation images waste less interpolation
distortion when letterboxing is used, and it keeps host decode cache-friendly.
Capability parity:
  * compute_aspect_ratios with fast paths for COCO/VOC-style datasets
    (:87-160) via `get_height_and_width` where available
  * create_aspect_ratio_groups with 2^linspace(-1, 1, 2k+1) bins (:186-195)
  * GroupedBatchSampler semantics (:23-81): batches drawn from one group,
    remainder filled from the largest groups deterministically
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterator, List, Optional, Sequence

import numpy as np


def compute_aspect_ratios(dataset, indices: Optional[Sequence[int]] = None
                          ) -> List[float]:
    """w/h per image; uses the dataset's metadata fast path when present
    (reference :87-160)."""
    if indices is None:
        indices = range(len(dataset))
    if hasattr(dataset, "get_height_and_width"):
        out = []
        for i in indices:
            h, w = dataset.get_height_and_width(i)
            out.append(w / h)
        return out
    out = []
    for i in indices:
        img, _ = dataset[i]
        h, w = img.shape[:2]
        out.append(w / h)
    return out


def _quantize(x: Sequence[float], bins: Sequence[float]) -> List[int]:
    return [bisect.bisect_right(bins, v) for v in x]


def create_aspect_ratio_groups(dataset, k: int = 0) -> List[int]:
    """Group id per image; bins at 2^linspace(-1, 1, 2k+1) (reference :186-195)."""
    aspect_ratios = compute_aspect_ratios(dataset)
    bins = (2 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    groups = _quantize(aspect_ratios, bins)
    counts = np.bincount(groups, minlength=len(bins) + 1)
    fbins = [0.0] + list(bins) + [np.inf]
    print(f"Using {fbins} as bins for aspect ratio quantization")
    print(f"Count of instances per bin: {list(counts)}")
    return groups


class GroupedBatchSampler:
    """Yields index batches where all elements share a group
    (reference :23-81). Iterable of List[int]."""

    def __init__(self, group_ids: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.group_ids = np.asarray(group_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return (len(self.group_ids) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(len(self.group_ids))
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(order)

        buffer: dict = defaultdict(list)
        num_batches = 0
        for idx in order:
            g = self.group_ids[idx]
            buffer[g].append(int(idx))
            if len(buffer[g]) == self.batch_size:
                yield buffer[g]
                num_batches += 1
                buffer[g] = []

        # deterministic fill-up of the remainder (reference :66-81):
        # drain leftover buffers from the largest first, topping batches up
        # with repeated elements of the same group.
        expected = len(self)
        leftovers = sorted(buffer.values(), key=len, reverse=True)
        for left in leftovers:
            if num_batches >= expected or not left:
                break
            while len(left) < self.batch_size:
                left.append(left[len(left) % max(1, len(left)) - 1])
            yield left[:self.batch_size]
            num_batches += 1
