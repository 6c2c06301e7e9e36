"""Model builders and the registry (counterpart of
demonet_tpu/models/builders.py).

The five detectors and the four classifiers of the JAX package, under
its nine names:

  * ssdlite320_mobilenet_v3_large: the flagship (SSDLite320 +
    MobileNetV3-Large);
  * ssd300_vgg16, ssd512_vgg16: the classic SSD on VGG16;
  * ssd_lite_mobilenet_v2: the legacy SSDLite + MobileNetV2 VOC model;
  * pelee304: Pelee-SSD;
  * mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small, peleenet_v1: the
    classifiers, as modules that take NHWC images.

A detector builder returns a `Detector` (module + SSDConfig + anchors), a
classifier builder the module itself, each in eval mode on `device`
(`cuda` unless the caller names another), its weights drawn from a
`torch.Generator` seeded with `seed` by the JAX package's initializers;
`utils.weights.load_jax_variables` replaces them with the JAX package's.
Each builder takes the JAX builders' `dtype`, the compute dtype
(`torch.float32` by default, or `torch.bfloat16`): the parameters and BN
statistics stay float32 and the convs and linears compute in it
(`layers.set_compute_dtype`). The JAX builders' layout keywords run
the same math in another layout, with the same state_dict and, from the
same seed, the same weights: `lane_pack` (the flagship's early trunk
blocks, `lane_pack_max_lanes` wide; VGG's block 1) and `stem_s2d` (the
stem conv on the space-to-depth layout; the flagship and
ssd_lite_mobilenet_v2). A builder without the keyword raises TypeError,
as the JAX package's do.
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Any, Callable, Dict, List, Tuple, Union

import torch
from torch import nn

from demonet_tpu_torch.models import anchors as anchor_lib
from demonet_tpu_torch.models.detection import Detector, SSD, SSDConfig
from demonet_tpu_torch.models.features import (
    MobileNetV2ExtraBlocks,
    SSDLiteMobileNetExtractor,
)
from demonet_tpu_torch.models.heads import Pelee1x1Head, SSDHead, SSDLiteHead
from demonet_tpu_torch.models.layers import set_compute_dtype
from demonet_tpu_torch.models.mobilenetv2 import MobileNetV2
from demonet_tpu_torch.models.mobilenetv3 import MobileNetV3
from demonet_tpu_torch.models.peleenet import PeleeExtractor, PeleeNet
from demonet_tpu_torch.models.vgg import VGG16SSDExtractor

Device = Union[str, torch.device, None]
KindOf = Callable[[str], str]

# SSDLite's detection BN: torch momentum 0.03 on every BN of the model
# (the JAX package's decay 0.97, demonet_tpu/models/features.py:73 and
# heads.py:99)
_SSDLITE_BN_MOMENTUM = 0.03
# the detectors among the registry's names; the rest are classifiers
DETECTORS = ("ssdlite320_mobilenet_v3_large", "ssd300_vgg16", "ssd512_vgg16",
             "ssd_lite_mobilenet_v2", "pelee304")


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


def feature_grid_sizes(extractor: nn.Module, size: Tuple[int, int]
                       ) -> List[Tuple[int, int]]:
    """(H, W) of each feature map for an input of `size`, from a forward
    on the meta device (shapes only, no arithmetic), as the JAX package
    traces them with eval_shape."""
    meta = {n: t.to("meta") for n, t in itertools.chain(
        extractor.named_parameters(), extractor.named_buffers())}
    x = torch.empty((1, 3, *size), device="meta")
    with torch.no_grad():
        outs = torch.func.functional_call(extractor, meta, (x,))
    return [tuple(int(d) for d in o.shape[2:]) for o in outs]


# the JAX package's kernel initializers (its conventions: fan_in is
# in/groups x receptive field, fan_out is out x receptive field; a Linear
# is (out, in) here, (in, out) there)
def _fans(w: torch.Tensor) -> Tuple[int, int]:
    receptive = math.prod(w.shape[2:])
    return w.shape[1] * receptive, w.shape[0] * receptive


def _draw(kind: str, w: torch.Tensor, gen: torch.Generator) -> None:
    fan_in, fan_out = _fans(w)
    if kind == "kaiming_out":        # variance_scaling(2, fan_out, normal)
        w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
    elif kind == "lecun_normal":     # variance_scaling(1, fan_in, truncated)
        # a normal truncated at +-2 std, rescaled to keep the variance
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
    elif kind == "xavier_uniform":   # variance_scaling(1, fan_avg, uniform)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w.uniform_(-limit, limit, generator=gen)
    elif kind == "normal_003":       # SSDLite's normal(0, 0.03)
        w.normal_(0.0, 0.03, generator=gen)
    else:
        raise ValueError(f"unknown initializer {kind!r}")


def _init_weights(model: nn.Module, generator: torch.Generator,
                  kind_of: KindOf) -> None:
    """Every conv and linear weight drawn from `generator` by the
    initializer kind_of(module name) names, in module order; zero
    biases; BN scale 1, bias 0, running mean 0, var 1."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _draw(kind_of(name), m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _ssdlite_init(name: str) -> str:
    """Flagship: kaiming (fan_out) in the trunk, lecun in its SE convs,
    normal(0, 0.03) in the extras and the head."""
    if name.startswith("extractor.trunk."):
        return "lecun_normal" if ".se." in name else "kaiming_out"
    return "normal_003"


def _vgg_init(name: str) -> str:
    """VGG SSDs: lecun in the trunk (conv1_1 ... conv5_3), xavier uniform
    from fc6 on and in the head."""
    trunk = re.fullmatch(r"extractor\.conv[1-5]_\d", name)
    return "lecun_normal" if trunk else "xavier_uniform"


def _v2_init(name: str) -> str:
    """The legacy SSDLite: kaiming (fan_out) in the trunk and the extras,
    normal(0, 0.03) in the head."""
    return "normal_003" if name.startswith("head.") else "kaiming_out"


def _lecun(name: str) -> str:
    """PeleeNet, Pelee-SSD: the JAX package's default conv and Dense
    init (lecun normal) everywhere."""
    return "lecun_normal"


def _classifier_init(name: str) -> str:
    """MobileNet classifiers: kaiming (fan_out) in the ConvBNAct convs,
    lecun in the SE convs and the Linear layers."""
    return ("lecun_normal" if ".se." in name or "classifier" in name
            else "kaiming_out")


def _config(size, num_classes, defaults, overrides) -> SSDConfig:
    return SSDConfig(size=tuple(size), num_classes=num_classes,
                     **{**defaults, **overrides})


def _detector(extractor: nn.Module, head: nn.Module, kind_of: KindOf,
              seed: int, device: torch.device, dtype: torch.dtype,
              config: SSDConfig,
              make_boxes: Callable[[List[Tuple[int, int]]], Any]
              ) -> Detector:
    grids = feature_grid_sizes(extractor, config.size)
    model = SSD(extractor, head)
    _init_weights(model, torch.Generator().manual_seed(seed), kind_of)
    set_compute_dtype(model, dtype)
    return Detector(model.to(device).eval(), config, make_boxes(grids))


def ssdlite320_mobilenet_v3_large(
    num_classes: int = 91,
    size: Tuple[int, int] = (320, 320),
    reduced_tail: bool = True,
    device: Device = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    lane_pack: bool = False,
    lane_pack_max_lanes: int = 128,
    stem_s2d: bool = False,
    **config_overrides: Any,
) -> Detector:
    """SSDLite320 + MobileNetV3-Large, the flagship model. `lane_pack`
    runs the early trunk blocks in the lane-packed layout; `stem_s2d`
    the stem conv on the space-to-depth layout."""
    device = resolve_device(device)
    aspect_ratios = [[2, 3]] * 6
    num_anchors = anchor_lib.num_anchors_per_location(aspect_ratios)
    extractor = SSDLiteMobileNetExtractor(
        bn_momentum=_SSDLITE_BN_MOMENTUM, reduced_tail=reduced_tail,
        lane_pack=lane_pack, lane_pack_max_lanes=lane_pack_max_lanes,
        stem_s2d=stem_s2d)
    head = SSDLiteHead(extractor.out_channels, num_anchors, num_classes,
                       bn_momentum=_SSDLITE_BN_MOMENTUM)
    config = _config(size, num_classes, dict(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
        score_thresh=0.001, nms_thresh=0.55,
        detections_per_img=300, topk_candidates=300), config_overrides)
    return _detector(extractor, head, _ssdlite_init, seed, device, dtype,
                     config,
                     lambda grids: anchor_lib.default_boxes(
                         grids, size, aspect_ratios, min_ratio=0.2,
                         max_ratio=0.95))


def _ssd_vgg16(num_classes: int, size: Tuple[int, int], highres: bool,
               device: Device, seed: int, dtype: torch.dtype,
               lane_pack: bool, config_overrides) -> Detector:
    device = resolve_device(device)
    if highres:    # SSD512, the SSD paper's 7 maps
        aspect_ratios = [[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]]
        scales = [0.04, 0.1, 0.26, 0.42, 0.58, 0.74, 0.9, 1.06]
        steps = [8, 16, 32, 64, 128, 256, 512]
    else:
        aspect_ratios = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]
        scales = [0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05]
        steps = [8, 16, 32, 64, 100, 300]
    num_anchors = anchor_lib.num_anchors_per_location(aspect_ratios)
    extractor = VGG16SSDExtractor(highres=highres, lane_pack=lane_pack)
    head = SSDHead(extractor.out_channels, num_anchors, num_classes)
    # caffe-style normalisation: mean in [0, 1] units, std 1/255
    config = _config(size, num_classes, dict(
        image_mean=(0.48235, 0.45882, 0.40784),
        image_std=(1.0 / 255.0, 1.0 / 255.0, 1.0 / 255.0)), config_overrides)
    return _detector(extractor, head, _vgg_init, seed, device, dtype, config,
                     lambda grids: anchor_lib.default_boxes(
                         grids, size, aspect_ratios, scales=scales,
                         steps=steps))


def ssd300_vgg16(num_classes: int = 91, device: Device = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, lane_pack: bool = False,
                 **config_overrides: Any) -> Detector:
    """The classic SSD300 on VGG16 (300x300, 8,732 anchors). `lane_pack`
    runs block 1 in the lane-packed layout."""
    return _ssd_vgg16(num_classes, (300, 300), False, device, seed, dtype,
                      lane_pack, config_overrides)


def ssd512_vgg16(num_classes: int = 91, device: Device = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, lane_pack: bool = False,
                 **config_overrides: Any) -> Detector:
    """SSD512 on VGG16 through the highres extras (512x512, 24,732
    anchors). `lane_pack` as ssd300_vgg16's."""
    return _ssd_vgg16(num_classes, (512, 512), True, device, seed, dtype,
                      lane_pack, config_overrides)


def ssd_lite_mobilenet_v2(
    num_classes: int = 21,
    size: Tuple[int, int] = (320, 320),
    score_thresh: float = 0.5,
    device: Device = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    stem_s2d: bool = False,
    **config_overrides: Any,
) -> Detector:
    """The legacy SSDLite + MobileNetV2 VOC model: 6 x [2, 3] ratios,
    scales 0.2-0.95; the head's BN eps 1e-5 and a plain 1x1 conv on the
    last level. `stem_s2d` computes the stem conv on the space-to-depth
    layout."""
    device = resolve_device(device)
    aspect_ratios = [[2, 3]] * 6
    num_anchors = anchor_lib.num_anchors_per_location(aspect_ratios)
    extractor = MobileNetV2ExtraBlocks(stem_s2d=stem_s2d)
    head = SSDLiteHead(extractor.out_channels, num_anchors, num_classes,
                       bn_momentum=0.1, bn_eps=1e-5, last_plain=True)
    config = _config(size, num_classes, dict(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
        score_thresh=score_thresh, nms_thresh=0.45,
        detections_per_img=100, topk_candidates=400), config_overrides)
    return _detector(extractor, head, _v2_init, seed, device, dtype, config,
                     lambda grids: anchor_lib.default_boxes(
                         grids, size, aspect_ratios, min_ratio=0.2,
                         max_ratio=0.95))


def pelee304(
    num_classes: int = 21,
    size: Tuple[int, int] = (304, 304),
    score_thresh: float = 0.5,
    device: Device = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    **config_overrides: Any,
) -> Detector:
    """Pelee-SSD 304: PeleeNet, 5 maps of 6 anchors each, ratios 5 x
    [2, 3], scales 0.15-0.9; the paper's steps [16, 30, 60, 101, 304] at
    304x304, grid-derived centres at any other size."""
    device = resolve_device(device)
    aspect_ratios = [[2, 3]] * 5
    num_anchors = anchor_lib.num_anchors_per_location(aspect_ratios)
    extractor = PeleeExtractor()
    head = Pelee1x1Head(extractor.out_channels, num_anchors, num_classes)
    config = _config(size, num_classes, dict(
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
        score_thresh=score_thresh, nms_thresh=0.45,
        detections_per_img=100, topk_candidates=400), config_overrides)
    steps = [16, 30, 60, 101, 304] if tuple(size) == (304, 304) else None
    return _detector(extractor, head, _lecun, seed, device, dtype, config,
                     lambda grids: anchor_lib.default_boxes(
                         grids, size, aspect_ratios, min_ratio=0.15,
                         max_ratio=0.9, steps=steps))


def _classifier(module: nn.Module, kind_of: KindOf, seed: int,
                device: torch.device, dtype: torch.dtype) -> nn.Module:
    _init_weights(module, torch.Generator().manual_seed(seed), kind_of)
    return set_compute_dtype(module, dtype).to(device).eval()


def mobilenet_v2(num_classes: int = 1000, device: Device = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 **kwargs: Any) -> MobileNetV2:
    """The MobileNetV2 classifier (width_mult, dropout_rate)."""
    device = resolve_device(device)
    return _classifier(MobileNetV2(num_classes=num_classes, **kwargs),
                       _classifier_init, seed, device, dtype)


def mobilenet_v3_large(num_classes: int = 1000, device: Device = None,
                       seed: int = 0, dtype: torch.dtype = torch.float32,
                       **kwargs: Any) -> MobileNetV3:
    """The MobileNetV3-Large classifier (width_mult, reduced_tail,
    dilated, dropout_rate)."""
    device = resolve_device(device)
    return _classifier(MobileNetV3("mobilenet_v3_large", num_classes,
                                   **kwargs), _classifier_init, seed, device,
                       dtype)


def mobilenet_v3_small(num_classes: int = 1000, device: Device = None,
                       seed: int = 0, dtype: torch.dtype = torch.float32,
                       **kwargs: Any) -> MobileNetV3:
    """The MobileNetV3-Small classifier (as mobilenet_v3_large)."""
    device = resolve_device(device)
    return _classifier(MobileNetV3("mobilenet_v3_small", num_classes,
                                   **kwargs), _classifier_init, seed, device,
                       dtype)


def peleenet_v1(num_classes: int = 1000, device: Device = None,
                seed: int = 0, dtype: torch.dtype = torch.float32,
                **kwargs: Any) -> PeleeNet:
    """The PeleeNet classifier (growth_rate, block_config,
    num_init_features, bn_size, drop_rate)."""
    device = resolve_device(device)
    return _classifier(PeleeNet(num_classes=num_classes, **kwargs), _lecun,
                       seed, device, dtype)


# the JAX package's nine public names (demonet_tpu/models/builders.py:220-245)
MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    "ssdlite320_mobilenet_v3_large": ssdlite320_mobilenet_v3_large,
    "ssd300_vgg16": ssd300_vgg16,
    "ssd512_vgg16": ssd512_vgg16,
    "ssd_lite_mobilenet_v2": ssd_lite_mobilenet_v2,
    "pelee304": pelee304,
    "mobilenet_v2": mobilenet_v2,
    "mobilenet_v3_large": mobilenet_v3_large,
    "mobilenet_v3_small": mobilenet_v3_small,
    "peleenet_v1": peleenet_v1,
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
