"""Model builders (counterpart of demonet_tpu/models/builders.py).

This slice ports the flagship, `ssdlite320_mobilenet_v3_large`. The
registry (`MODEL_REGISTRY`, `get_model`) holds all nine of the JAX
package's names; the other families and the classifiers raise
NotImplementedError until a later slice ports them (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple, Union

import torch
from torch import nn

from demonet_tpu_torch.models import anchors as anchor_lib
from demonet_tpu_torch.models.detection import Detector, SSD, SSDConfig
from demonet_tpu_torch.models.features import SSDLiteMobileNetExtractor
from demonet_tpu_torch.models.heads import SSDLiteHead

Device = Union[str, torch.device, None]

# SSDLite's detection BN: torch momentum 0.03 on every BN of the model
# (the JAX package's decay 0.97, demonet_tpu/models/features.py:73 and
# heads.py:99)
_SSDLITE_BN_MOMENTUM = 0.03


def resolve_device(device: Device) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. With no GPU and no device asked for, raise; never fall back
    to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _init_weights(model: SSD, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from `generator`: kaiming
    normal (fan_out) for the trunk convs, lecun normal for the SE convs,
    normal(0, 0.03) for the extra blocks and the head; zero biases; BN
    scale 1, bias 0, running mean 0, var 1."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            receptive = w.shape[2] * w.shape[3]
            if name.startswith("extractor.trunk.") and ".se." in name:
                std = math.sqrt(1.0 / (w.shape[1] * receptive))
            elif name.startswith("extractor.trunk."):
                std = math.sqrt(2.0 / (w.shape[0] * receptive))
            else:
                std = 0.03
            with torch.no_grad():
                w.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def ssdlite320_mobilenet_v3_large(
    num_classes: int = 91,
    size: Tuple[int, int] = (320, 320),
    device: Device = None,
    seed: int = 0,
    **config_overrides: Any,
) -> Detector:
    """SSDLite320 + MobileNetV3-Large, the flagship model, in eval mode.

    Weights are random, drawn from a `torch.Generator` seeded with `seed`;
    `utils.weights.load_jax_variables` replaces them with the JAX
    package's. Runs on `cuda` unless `device` names another.
    """
    device = resolve_device(device)
    aspect_ratios = [[2, 3]] * 6
    num_anchors = anchor_lib.num_anchors_per_location(aspect_ratios)
    extractor = SSDLiteMobileNetExtractor(bn_momentum=_SSDLITE_BN_MOMENTUM)
    grids = extractor.grid_sizes(size)
    head = SSDLiteHead(extractor.out_channels, num_anchors, num_classes,
                       bn_momentum=_SSDLITE_BN_MOMENTUM)
    model = SSD(extractor, head)
    _init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    defaults = dict(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
        score_thresh=0.001, nms_thresh=0.55,
        detections_per_img=300, topk_candidates=300)
    config = SSDConfig(size=size, num_classes=num_classes,
                       **{**defaults, **config_overrides})
    boxes = anchor_lib.default_boxes(
        grids, size, aspect_ratios, min_ratio=0.2, max_ratio=0.95)
    return Detector(model, config, boxes)


def _unported_builder(name: str) -> Callable[..., Any]:
    def build(**kwargs: Any) -> Detector:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue 1, item 9); "
            "the port builds ssdlite320_mobilenet_v3_large")

    build.__name__ = name
    return build


# the JAX package's nine public names (demonet_tpu/models/builders.py:220-245;
# reference demonet/models/__init__.py + train.py:154); the other families
# and the classifiers wait for ROADMAP Queue 1 item 9
MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    "ssdlite320_mobilenet_v3_large": ssdlite320_mobilenet_v3_large,
    **{name: _unported_builder(name) for name in (
        "ssd300_vgg16", "ssd512_vgg16", "ssd_lite_mobilenet_v2", "pelee304",
        "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
        "peleenet_v1")},
}


def get_model(name: str, **kwargs: Any):
    """Resolve a model by its public name (torch.hub-style registry)."""
    try:
        builder = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return builder(**kwargs)
