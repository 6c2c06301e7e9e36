"""Augmentation policy presets (reference demonet/data/presets.py:4-31).

A copy of demonet_tpu/data/presets.py for the PyTorch port, which imports
nothing of the JAX package.

'hflip' = flip only; 'ssd' = the full SSD suite (photometric distort,
zoom-out with the model's un-normalized mean fill, IoU crop, flip).

Presets keep images uint8: the loader resizes uint8 (cheaper, especially on
the up-to-4x zoom-out canvases) and fuses the [0,1] float conversion into
one pass at the final 320^2 size. Resize lives in the loader so eval keeps
original sizes for box rescaling.
"""

from __future__ import annotations

from typing import Sequence

from demonet_tpu_torch.data import transforms as T


class DetectionPresetTrain:
    def __init__(self, data_augmentation: str = "hflip",
                 hflip_prob: float = 0.5,
                 mean: Sequence[float] = (123.0, 117.0, 104.0)):
        if data_augmentation == "hflip":
            self.transforms = T.Compose([
                T.RandomHorizontalFlip(p=hflip_prob),
            ])
        elif data_augmentation == "ssd":
            self.transforms = T.Compose([
                T.RandomPhotometricDistort(),
                T.RandomZoomOut(fill=list(mean)),
                T.RandomIoUCrop(),
                T.RandomHorizontalFlip(p=hflip_prob),
            ])
        else:
            raise ValueError(
                f'Unknown data augmentation policy "{data_augmentation}"')

    def __call__(self, img, target, rng=None):
        return self.transforms(img, target, rng)


class DetectionPresetEval:
    def __init__(self):
        self.transforms = T.Compose([])

    def __call__(self, img, target, rng=None):
        return self.transforms(img, target, rng)
