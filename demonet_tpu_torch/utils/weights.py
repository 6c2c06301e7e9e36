"""Carry the JAX package's weights into the port's modules.

`load_jax_variables(model, variables)` takes the JAX package's variables
as numpy arrays, in either of the forms the repository has:

  * the nested {'params': ..., 'batch_stats': ...} tree that
    `jax.device_get(det.init(...))` gives;
  * the flat {"params/extractor/...": array} dict of the bench npz
    (bench_assets/ssdlite320_shapes_trained.npz, stored as fp16).

Every leaf is cast to float32 and lands in the module's state_dict by rule:

  * a path segment of letters and `_<n>` (`blocks_3`, `extras_0`, `cls_0`,
    `layers_1`, `resblock_2`) becomes `blocks.3` ... (JAX list members vs
    nn.ModuleList); a segment with a digit before its `_<n>` is a module
    name and stays (`conv4_3`, `denseblock1_layer2`);
  * conv `kernel` (H, W, I/groups, O) -> `weight` (O, I/groups, H, W);
    Dense `kernel` (in, out) -> Linear `weight` (out, in);
  * `scale` (BN) -> `weight`; `bias` stays `bias`; VGG's learned L2
    rescale `scale_weight` stays `scale_weight`;
  * batch_stats `.../mean|var` -> `running_mean|running_var`.

It is strict: every parameter and buffer of the module is filled exactly
once (`num_batches_tracked` excepted), a shape mismatch raises, and a key
the module has no place for raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale_weight"): "scale_weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def torch_name(jax_key: str) -> str:
    """"params/extractor/trunk/blocks_3/depthwise/conv/kernel" ->
    "extractor.trunk.blocks.3.depthwise.conv.weight"."""
    collection, *path, leaf = jax_key.split("/")
    try:
        name = _LEAF[(collection, leaf)]
    except KeyError:
        raise KeyError(f"no rule for JAX variable {jax_key!r}") from None
    path = [re.sub(r"^([A-Za-z]+)_(\d+)$", r"\1.\2", seg) for seg in path]
    return ".".join([*path, name])


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill `model`'s parameters and buffers from JAX variables, in place.

    Raises KeyError on a JAX key with no place in the module or a module
    entry left unfilled, ValueError on a shape mismatch.
    """
    flat = _flatten(variables)
    state = model.state_dict()
    want = {k for k in state if not k.endswith("num_batches_tracked")}
    filled = {}
    for key, value in flat.items():
        name = torch_name(key)
        if name not in want:
            raise KeyError(f"JAX variable {key!r} maps to {name!r}, which "
                           f"{type(model).__name__} does not have")
        if name in filled:
            raise KeyError(f"{name!r} is filled by both {filled[name]!r} "
                           f"and {key!r}")
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:  # (H, W, I/g, O) -> (O, I/g, H, W)
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            arr = arr.T
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(f"{key!r}: shape {arr.shape} does not fit "
                             f"{name!r} {tuple(state[name].shape)}")
        filled[name] = key
        with torch.no_grad():
            state[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    missing = sorted(want - set(filled))
    if missing:
        raise KeyError(f"{len(missing)} entries of {type(model).__name__} "
                       f"have no JAX variable, e.g. {missing[:5]}")
