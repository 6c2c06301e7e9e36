"""Published checkpoints: resolution in a local cache and loading
(counterpart of demonet_tpu/utils/pretrained.py; the reference's
`pretrained=True`, ssd_mobilenetv3.py:20-23, ssd_vgg16.py:19-26,
mobilenetv2.py:11-13, mobilenetv3.py:16-19, hubconf.py:22).

Each published checkpoint's URL names a file in the weights cache,
`$DEMONET_WEIGHTS_DIR` or else `~/.cache/demonet_tpu/weights` (the JAX
package's cache: one serves both). Resolution is cache-only: nothing is
fetched, and a missing file raises with the URL to fetch it from on a
connected machine. A found file goes through `utils.torch_weights` into
the port's model.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from torch import nn

# model name -> url; the filenames follow torch.hub's, so a cache that
# torchvision filled can be linked in as it is
PRETRAINED_URLS: Dict[str, str] = {
    # reference ssd_mobilenetv3.py:20-23
    "ssdlite320_mobilenet_v3_large":
        "https://download.pytorch.org/models/"
        "ssdlite320_mobilenet_v3_large_coco-a79551df.pth",
    # reference ssd_vgg16.py:19-21
    "ssd300_vgg16":
        "https://download.pytorch.org/models/ssd300_vgg16_coco-b556d3b4.pth",
    # reference mobilenetv2.py:11-13
    "mobilenet_v2":
        "https://download.pytorch.org/models/mobilenet_v2-b0353104.pth",
    # reference mobilenetv3.py:16-19
    "mobilenet_v3_large":
        "https://download.pytorch.org/models/"
        "mobilenet_v3_large-8738ca79.pth",
    "mobilenet_v3_small":
        "https://download.pytorch.org/models/"
        "mobilenet_v3_small-047dcff4.pth",
}

# checkpoints the reference loads from a local path, not a URL
# (hubconf.py:22: './checkpoints/mobilenet_v2/ssd_lite_mobilenet_v2_199.pth')
LOCAL_ONLY = {
    "ssd_lite_mobilenet_v2": "ssd_lite_mobilenet_v2_199.pth",
}


def weights_cache_dir() -> str:
    return os.environ.get(
        "DEMONET_WEIGHTS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "demonet_tpu",
                     "weights"))


def cached_weights_path(model_name: str) -> str:
    """The cache file of a model's published checkpoint (may not exist)."""
    if model_name in PRETRAINED_URLS:
        fname = PRETRAINED_URLS[model_name].rsplit("/", 1)[1]
    elif model_name in LOCAL_ONLY:
        fname = LOCAL_ONLY[model_name]
    else:
        raise ValueError(
            f"No published checkpoint known for {model_name!r}; "
            f"available: {sorted(PRETRAINED_URLS) + sorted(LOCAL_ONLY)}")
    return os.path.join(weights_cache_dir(), fname)


def resolve_weights(model_name: str, path: Optional[str] = None) -> str:
    """A readable .pth path for `model_name`: `path` if given (it must
    exist), else the cache file; a cold cache raises FileNotFoundError
    naming the URL."""
    if path:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"weights file not found: {path}")
        return path
    cached = cached_weights_path(model_name)
    if os.path.isfile(cached):
        return cached
    url = PRETRAINED_URLS.get(model_name)
    hint = (f"download {url}" if url else
            "obtain the checkpoint from the reference release")
    raise FileNotFoundError(
        f"No cached weights for {model_name!r} at {cached}, and nothing is "
        f"fetched: on a connected machine {hint} and copy the file to "
        f"{weights_cache_dir()} (or set $DEMONET_WEIGHTS_DIR).")


def load_pretrained(model: nn.Module, model_name: str,
                    path: Optional[str] = None, **key_map_kwargs: Any
                    ) -> str:
    """Resolve `model_name`'s checkpoint (or `path`) and load it into
    `model` (a detector's `.model` or a classifier), in place and
    strictly. Returns the file it read."""
    from demonet_tpu_torch.utils.torch_weights import (
        load_torch_checkpoint,
        load_torch_weights,
    )

    resolved = resolve_weights(model_name, path)
    load_torch_weights(model, model_name, load_torch_checkpoint(resolved),
                       **key_map_kwargs)
    return resolved


def apply_pretrained(state, model_name: str, path: Optional[str] = None,
                     **key_map_kwargs: Any):
    """`state` (an `engine.state.TrainState`) with its model's parameters
    and BN statistics replaced by the checkpoint's, in place; the
    optimizer's buffers are left as they are, as the reference loads a
    model-only .pth into a trainer already built. Returns `state`."""
    load_pretrained(state.model, model_name, path, **key_map_kwargs)
    return state
