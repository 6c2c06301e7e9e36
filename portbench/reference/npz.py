"""A flat npz of JAX-style variables ("params/extractor/trunk/blocks_3/
depthwise/conv/kernel", float16 or float32) as a float32 state_dict of
the reference nets: list members `name_<n>` become `name.<n>` (a segment
with a digit before its `_<n>`, such as `conv4_3`, is a name and stays);
conv kernels (H, W, I/groups, O) become (O, I/groups, H, W); BN `scale`
becomes `weight`, its batch_stats `mean` and `var` the running ones.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("params", "scale_weight"): "scale_weight",
         ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def name_of(key: str) -> str:
    collection, *path, leaf = key.split("/")
    path = [re.sub(r"^([A-Za-z]+)_(\d+)$", r"\1.\2", seg) for seg in path]
    return ".".join([*path, _LEAF[(collection, leaf)]])


def state_dict(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in arrays.items():
        arr = np.asarray(value, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        out[name_of(key)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
