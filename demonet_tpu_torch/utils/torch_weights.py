"""torch checkpoints in the reference's state_dict layout -> the port's
modules (counterpart of demonet_tpu/utils/torch_weights.py).

The published checkpoints (torchvision's .pth files, the reference's own
training checkpoints) name their tensors by the reference's torch module
tree. The key maps below carry each tensor to the JAX package's variable
path, with its layout moved:

  * conv weight  (O, I/g, H, W) -> kernel (H, W, I/g, O)
  * linear weight (O, I)        -> kernel (I, O)
  * BatchNorm weight/bias       -> bn scale/bias (params)
    running_mean/running_var    -> bn mean/var (batch_stats)

`convert_state_dict` gives that JAX-layout tree of numpy arrays;
`load_torch_weights` puts it into a port model through the strict
`utils.weights.load_jax_variables`, the one loading path, held to the
JAX package. `synthesize_torch_state_dict` is the inverse (tests write
their own checkpoints with it). The port keeps its own copy of every map:
it imports nothing of the JAX package. Pelee has no map, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from demonet_tpu_torch.utils.weights import load_jax_variables

# (JAX variable path, torch key, kind); kind in {conv, linear, raw}
MapEntry = Tuple[str, str, str]


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _conv_bn(prefix: str, torch_prefix: str,
             conv_idx: int = 0, bn_idx: int = 1) -> List[MapEntry]:
    """A torch ConvBNActivation Sequential -> the JAX package's ConvBNAct."""
    return [
        (f"params/{prefix}/conv/kernel",
         f"{torch_prefix}.{conv_idx}.weight", "conv"),
        (f"params/{prefix}/bn/scale",
         f"{torch_prefix}.{bn_idx}.weight", "raw"),
        (f"params/{prefix}/bn/bias",
         f"{torch_prefix}.{bn_idx}.bias", "raw"),
        (f"batch_stats/{prefix}/bn/mean",
         f"{torch_prefix}.{bn_idx}.running_mean", "raw"),
        (f"batch_stats/{prefix}/bn/var",
         f"{torch_prefix}.{bn_idx}.running_var", "raw"),
    ]


def _se(prefix: str, torch_prefix: str) -> List[MapEntry]:
    """SqueezeExcitation fc1/fc2 1x1 convs (reference mobilenetv3.py:22-40)."""
    out = []
    for fc in ("fc1", "fc2"):
        out.append((f"params/{prefix}/{fc}/kernel",
                    f"{torch_prefix}.{fc}.weight", "conv"))
        out.append((f"params/{prefix}/{fc}/bias",
                    f"{torch_prefix}.{fc}.bias", "raw"))
    return out


def _mnv3_block(prefix: str, torch_block: str, cfg) -> List[MapEntry]:
    """One reference InvertedResidual `.block` Sequential
    (mobilenetv3.py:61-99): [expand?, depthwise, se?, project]."""
    entries = []
    j = 0
    if cfg.expanded_channels != cfg.in_channels:
        entries += _conv_bn(f"{prefix}/expand_conv", f"{torch_block}.{j}")
        j += 1
    entries += _conv_bn(f"{prefix}/depthwise", f"{torch_block}.{j}")
    j += 1
    if cfg.use_se:
        entries += _se(f"{prefix}/se", f"{torch_block}.{j}")
        j += 1
    entries += _conv_bn(f"{prefix}/project", f"{torch_block}.{j}")
    return entries


def _mnv3_trunk(prefix: str, torch_prefix: str, configs) -> List[MapEntry]:
    """A plain (unsplit) MobileNetV3 `features` Sequential."""
    entries = _conv_bn(f"{prefix}/stem", f"{torch_prefix}.0")
    for i, cfg in enumerate(configs):
        entries += _mnv3_block(
            f"{prefix}/blocks_{i}", f"{torch_prefix}.{i + 1}.block", cfg)
    entries += _conv_bn(
        f"{prefix}/last_conv", f"{torch_prefix}.{len(configs) + 1}")
    return entries


def ssdlite_mnv3_key_map(reduced_tail: bool = True,
                         arch: str = "mobilenet_v3_large") -> List[MapEntry]:
    """ssdlite320_mobilenet_v3_large checkpoint layout.

    The trunk is split at C4 (reference ssd_mobilenetv3.py:104-108):
      backbone.features.0 = [features[0..c4-1], features[c4].block[0]]
      backbone.features.1 = [features[c4].block[1:], features[c4+1..]]
    plus backbone.extra.{0..3} (:111-116) and
    head.{classification,regression}_head.module_list.{0..5}
    (:65-96, generalized_ssd.py:38-64).
    """
    from demonet_tpu_torch.models.mobilenetv3 import mobilenet_v3_conf

    configs, _ = mobilenet_v3_conf(arch, reduced_tail=reduced_tail)
    c4 = max(i for i, c in enumerate(configs) if c.stride > 1)

    # stem = features.0.0
    entries = _conv_bn("extractor/trunk/stem", "backbone.features.0.0")
    # blocks 0..c4-1 at features.0.<i+1>.block
    for i in range(c4):
        entries += _mnv3_block(
            f"extractor/trunk/blocks_{i}",
            f"backbone.features.0.{i + 1}.block", configs[i])
    # C4 block: expand at features.0.<c4+1> (a bare ConvBNActivation),
    # remainder at features.1.0.<j> where j keeps the ORIGINAL block
    # child index — torch nn.Sequential slicing preserves the sliced
    # children's names (block[1:] -> children still named 1, 2, 3), it
    # does NOT reindex from 0 (the JAX package checks this map against the
    # reference model's own state_dict).
    c4cfg = configs[c4]
    assert c4cfg.expanded_channels != c4cfg.in_channels
    entries += _conv_bn(
        f"extractor/trunk/blocks_{c4}/expand_conv",
        f"backbone.features.0.{c4 + 1}")
    rem = f"backbone.features.1.0"
    entries += _conv_bn(
        f"extractor/trunk/blocks_{c4}/depthwise", f"{rem}.1")
    if c4cfg.use_se:
        entries += _se(f"extractor/trunk/blocks_{c4}/se", f"{rem}.2")
        entries += _conv_bn(
            f"extractor/trunk/blocks_{c4}/project", f"{rem}.3")
    else:
        entries += _conv_bn(
            f"extractor/trunk/blocks_{c4}/project", f"{rem}.2")
    # blocks c4+1.. at features.1.<k>, k starting at 1
    for k, i in enumerate(range(c4 + 1, len(configs)), start=1):
        entries += _mnv3_block(
            f"extractor/trunk/blocks_{i}",
            f"backbone.features.1.{k}.block", configs[i])
    # last conv = features.1.<last>
    k_last = len(configs) - c4
    entries += _conv_bn(
        "extractor/trunk/last_conv", f"backbone.features.1.{k_last}")
    # extras: Sequential(proj CBA, dw CBA, expand CBA)
    for e in range(4):
        for j, part in enumerate(("proj", "dw", "expand")):
            entries += _conv_bn(
                f"extractor/extras_{e}/{part}", f"backbone.extra.{e}.{j}")
    # heads: module_list.<k> = Sequential(CBA dw, Conv2d pw)
    for torch_head, head in (("classification_head", "cls"),
                                  ("regression_head", "reg")):
        for k in range(6):
            tp = f"head.{torch_head}.module_list.{k}"
            entries += _conv_bn(f"head/{head}_{k}/dw", f"{tp}.0")
            entries.append((f"params/head/{head}_{k}/pw/kernel",
                            f"{tp}.1.weight", "conv"))
            entries.append((f"params/head/{head}_{k}/pw/bias",
                            f"{tp}.1.bias", "raw"))
    return entries


def mobilenet_v3_classifier_key_map(arch: str = "mobilenet_v3_large",
                                    reduced_tail: bool = False) -> List[MapEntry]:
    """mobilenet_v3_large/small classifier checkpoints
    (reference mobilenetv3.py:102-161: features + classifier.[0,3])."""
    from demonet_tpu_torch.models.mobilenetv3 import mobilenet_v3_conf

    configs, _ = mobilenet_v3_conf(arch, reduced_tail=reduced_tail)
    entries = _mnv3_trunk("features", "features", configs)
    entries += [
        ("params/pre_classifier/kernel", "classifier.0.weight", "linear"),
        ("params/pre_classifier/bias", "classifier.0.bias", "raw"),
        ("params/classifier/kernel", "classifier.3.weight", "linear"),
        ("params/classifier/bias", "classifier.3.bias", "raw"),
    ]
    return entries


def _mnv2_trunk(prefix: str, torch_prefix: str) -> List[MapEntry]:
    """MobileNetV2 `features` trunk key entries (torch layout per reference
    mobilenetv2.py:103-201: .0 stem, .1-17 InvertedResidual `.conv`,
    .18 last conv).

    The torch InvertedResidual.conv Sequential is
    [expand CBA?, dw CBA, pw-linear Conv2d, BN] (mobilenetv2.py:78-92) —
    note the final conv+bn are two separate entries, not a CBA.
    """
    from demonet_tpu_torch.models.mobilenetv2 import _V2_SETTING

    entries = _conv_bn(f"{prefix}/stem", f"{torch_prefix}.0")
    i = 0
    for t, c, n, s in _V2_SETTING:
        for r in range(n):
            tp = f"{torch_prefix}.{i + 1}.conv"
            fp = f"{prefix}/blocks_{i}"
            j = 0
            layer = 0
            if t != 1:
                entries += _conv_bn(f"{fp}/layers_{layer}", f"{tp}.{j}")
                j += 1
                layer += 1
            entries += _conv_bn(f"{fp}/layers_{layer}", f"{tp}.{j}")
            j += 1
            layer += 1
            # pw-linear conv + bare BN
            entries.append((f"params/{fp}/layers_{layer}/conv/kernel",
                            f"{tp}.{j}.weight", "conv"))
            entries += [
                (f"params/{fp}/layers_{layer}/bn/scale", f"{tp}.{j+1}.weight", "raw"),
                (f"params/{fp}/layers_{layer}/bn/bias", f"{tp}.{j+1}.bias", "raw"),
                (f"batch_stats/{fp}/layers_{layer}/bn/mean",
                 f"{tp}.{j+1}.running_mean", "raw"),
                (f"batch_stats/{fp}/layers_{layer}/bn/var",
                 f"{tp}.{j+1}.running_var", "raw"),
            ]
            i += 1
    entries += _conv_bn(f"{prefix}/last_conv", f"{torch_prefix}.{i + 1}")
    return entries


def mobilenet_v2_key_map(width_mult: float = 1.0) -> List[MapEntry]:
    """mobilenet_v2 classifier (reference mobilenetv2.py:103-201)."""
    entries = _mnv2_trunk("features", "features")
    entries += [
        ("params/classifier/kernel", "classifier.1.weight", "linear"),
        ("params/classifier/bias", "classifier.1.bias", "raw"),
    ]
    return entries


def ssd_lite_mobilenet_v2_key_map() -> List[MapEntry]:
    """The legacy v0 ssd_lite_mobilenet_v2 checkpoint layout
    (the hubconf.py:22 .pth: AP50 68.39 on VOC).

    Derived from the reference components that survive in-tree:
      * backbone = MobileNetWithExtraBlocks (backbone.py:45-67) wrapped in
        IntermediateLayerGetter -> `backbone.body.<i>` keeps torchvision
        mobilenet_v2 `features` numbering; `backbone.extra_blocks.<i>.conv`
        is [pw CBA, dw CBA, pw-linear Conv2d, BN] (backbone.py:81-119).
      * head = MultiBoxLiteHead (box_head.py:37-56): `cls_logits.<k>` /
        `bbox_pred.<k>`; k<5 SeperableConv2d [dw Conv2d, BN, ReLU6, pw
        Conv2d] (:24-34), k=5 plain 1x1 Conv2d (:55-56).

    The enclosing module's attribute names come from the (now missing)
    `ssd_mobilenet.SSDLiteWithMobileNetV2`; `backbone` / `multibox_head`
    follow its constructor argument names (hubconf.py:10-17). If a real
    .pth disagrees, strict conversion names the mismatched keys and the
    prefixes below are the one-line fix.
    """
    entries = _mnv2_trunk("extractor/trunk", "backbone.body")
    for e in range(4):
        tp = f"backbone.extra_blocks.{e}.conv"
        fp = f"extractor/extras_{e}"
        entries += _conv_bn(f"{fp}/pw", f"{tp}.0")
        entries += _conv_bn(f"{fp}/dw", f"{tp}.1")
        entries.append((f"params/{fp}/pw_linear/conv/kernel",
                        f"{tp}.2.weight", "conv"))
        entries += [
            (f"params/{fp}/pw_linear/bn/scale", f"{tp}.3.weight", "raw"),
            (f"params/{fp}/pw_linear/bn/bias", f"{tp}.3.bias", "raw"),
            (f"batch_stats/{fp}/pw_linear/bn/mean",
             f"{tp}.3.running_mean", "raw"),
            (f"batch_stats/{fp}/pw_linear/bn/var",
             f"{tp}.3.running_var", "raw"),
        ]
    for torch_head, head in (("cls_logits", "cls"),
                                  ("bbox_pred", "reg")):
        for k in range(5):
            tp = f"multibox_head.{torch_head}.{k}"
            fp = f"head/{head}_{k}"
            # SeperableConv2d: .0 dw conv (bias=True), .1 bn, .3 pw conv.
            # The JAX dw conv is bias-free — conv bias before BN folds
            # exactly into the running mean (BN(y+b) == BN'(y) with
            # mean' = mean - b).
            entries.append((f"params/{fp}/dw/conv/kernel",
                            f"{tp}.0.weight", "conv"))
            entries += [
                (f"params/{fp}/dw/bn/scale", f"{tp}.1.weight", "raw"),
                (f"params/{fp}/dw/bn/bias", f"{tp}.1.bias", "raw"),
                (f"batch_stats/{fp}/dw/bn/mean",
                 f"{tp}.1.running_mean|{tp}.0.bias", "mean_minus_bias"),
                (f"batch_stats/{fp}/dw/bn/var", f"{tp}.1.running_var", "raw"),
            ]
            entries.append((f"params/{fp}/pw/kernel", f"{tp}.3.weight", "conv"))
            entries.append((f"params/{fp}/pw/bias", f"{tp}.3.bias", "raw"))
        tp = f"multibox_head.{torch_head}.5"
        entries.append((f"params/head/{head}_5/kernel",
                        f"{tp}.weight", "conv"))
        entries.append((f"params/head/{head}_5/bias",
                        f"{tp}.bias", "raw"))
    return entries


def ssd_vgg16_key_map(highres: bool = False) -> List[MapEntry]:
    """ssd300_vgg16 checkpoint layout (reference ssd_vgg16.py:30-109).

    backbone.features.<i> = VGG convs up to conv4_3 (torchvision vgg16
    features indices); backbone.extra.0 = [conv5 block + fc], extra.1-4(5) =
    the conv8-11(12) pairs; backbone.scale_weight; head.* plain convs.
    """
    entries: List[MapEntry] = []

    def conv(name: str, torch_key: str):
        entries.append((f"params/extractor/{name}/kernel",
                        f"{torch_key}.weight", "conv"))
        entries.append((f"params/extractor/{name}/bias",
                        f"{torch_key}.bias", "raw"))

    # trunk through conv4_3: torchvision vgg16.features conv indices
    vgg_idx = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
               "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
               "conv4_1": 17, "conv4_2": 19, "conv4_3": 21}
    for name, i in vgg_idx.items():
        conv(name, f"backbone.features.{i}")
    entries.append(("params/extractor/scale_weight",
                    "backbone.scale_weight", "raw"))
    # extra.0: Sequential(*backbone[maxpool4:-1], fc) =
    #   [maxpool(23), conv5_1(0->24)...]; submodule indices restart at 0:
    #   extra.0.0 = maxpool, .1 = conv5_1, .3 = conv5_2, .5 = conv5_3,
    #   .7 = fc Sequential(maxpool5, fc6, relu, fc7, relu)
    conv("conv5_1", "backbone.extra.0.1")
    conv("conv5_2", "backbone.extra.0.3")
    conv("conv5_3", "backbone.extra.0.5")
    conv("fc6", "backbone.extra.0.7.1")
    conv("fc7", "backbone.extra.0.7.3")
    pairs = [("conv8_1", "conv8_2"), ("conv9_1", "conv9_2"),
             ("conv10_1", "conv10_2"), ("conv11_1", "conv11_2")]
    if highres:
        pairs.append(("conv12_1", "conv12_2"))
    for e, (a, b) in enumerate(pairs, start=1):
        conv(a, f"backbone.extra.{e}.0")
        conv(b, f"backbone.extra.{e}.2")
    # heads: plain Conv2d per level (generalized_ssd.py:77-93)
    n_levels = 7 if highres else 6
    for torch_head, head in (("classification_head", "cls"),
                                  ("regression_head", "reg")):
        for k in range(n_levels):
            tp = f"head.{torch_head}.module_list.{k}"
            entries.append((f"params/head/{head}_{k}/kernel",
                            f"{tp}.weight", "conv"))
            entries.append((f"params/head/{head}_{k}/bias",
                            f"{tp}.bias", "raw"))
    return entries


_KEY_MAPS: Dict[str, Callable[..., List[MapEntry]]] = {
    "ssdlite320_mobilenet_v3_large": ssdlite_mnv3_key_map,
    "ssd_lite_mobilenet_v2": ssd_lite_mobilenet_v2_key_map,
    "mobilenet_v3_large": lambda **kw: mobilenet_v3_classifier_key_map(
        "mobilenet_v3_large", **kw),
    "mobilenet_v3_small": lambda **kw: mobilenet_v3_classifier_key_map(
        "mobilenet_v3_small", **kw),
    "mobilenet_v2": mobilenet_v2_key_map,
    "ssd300_vgg16": ssd_vgg16_key_map,
    "ssd512_vgg16": lambda **kw: ssd_vgg16_key_map(highres=True, **kw),
}

_TRANSFORMS = {"conv": _t_conv, "linear": _t_linear, "raw": lambda x: x}
_INVERSE = {"conv": lambda x: np.transpose(x, (3, 2, 0, 1)),
            "linear": _t_linear, "raw": lambda x: x}


def key_map_for(model_name: str, **kwargs: Any) -> List[MapEntry]:
    if model_name not in _KEY_MAPS:
        raise ValueError(
            f"No torch key map for {model_name!r}; available: "
            f"{sorted(_KEY_MAPS)}")
    return _KEY_MAPS[model_name](**kwargs)


def _numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def convert_state_dict(
    model_name: str,
    state_dict: Mapping[str, Any],
    strict: bool = True,
    **kwargs: Any,
) -> Dict[str, Any]:
    """torch state_dict (tensors or numpy arrays) -> the JAX package's
    {'params', 'batch_stats'} tree of numpy arrays. With strict, a key the
    map needs and the state_dict lacks raises KeyError."""
    entries = key_map_for(model_name, **kwargs)
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    missing = []
    for path, torch_key, kind in entries:
        if kind == "mean_minus_bias":
            # running_mean with a pre-BN conv bias folded in (the v0
            # SeperableConv2d entries): torch_key is "<mean_key>|<bias_key>"
            mean_key, bias_key = torch_key.split("|")
            absent = [k for k in (mean_key, bias_key) if k not in state_dict]
            if absent:
                missing += absent
                continue
            out[tuple(path.split("/"))] = (_numpy(state_dict[mean_key])
                                           - _numpy(state_dict[bias_key]))
            continue
        if torch_key not in state_dict:
            missing.append(torch_key)
            continue
        out[tuple(path.split("/"))] = _TRANSFORMS[kind](
            _numpy(state_dict[torch_key]))
    if missing and strict:
        raise KeyError(
            f"{len(missing)} torch keys missing, e.g. {missing[:5]}")
    tree = _unflatten(out)
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


def synthesize_torch_state_dict(
    model_name: str, variables: Mapping[str, Any], **kwargs: Any
) -> Dict[str, np.ndarray]:
    """The inverse: JAX-layout variables -> a reference-shaped state_dict
    of numpy arrays (a folded conv bias comes back as zeros)."""
    entries = key_map_for(model_name, **kwargs)
    flat = {"params": _flatten(variables.get("params", {})),
            "batch_stats": _flatten(variables.get("batch_stats", {}))}
    sd = {}
    for path, torch_key, kind in entries:
        coll, *rest = path.split("/")
        rest = tuple(rest)
        if rest not in flat[coll]:
            raise KeyError(f"variable path {path} not found")
        value = _numpy(flat[coll][rest])
        if kind == "mean_minus_bias":
            # underdetermined inverse: zero conv bias + the raw mean
            mean_key, bias_key = torch_key.split("|")
            sd[mean_key] = value
            sd[bias_key] = np.zeros_like(value)
            continue
        sd[torch_key] = _INVERSE[kind](value)
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth file -> a numpy-valued state_dict. A training checkpoint of
    the reference ({"model": ..., "optimizer": ...}) gives its model.
    The reference's checkpoints pickle more than tensors, so this loads
    with weights_only=False: read only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    return {k: _numpy(v) for k, v in obj.items()}


def load_torch_weights(model: nn.Module, model_name: str,
                       state_dict: Mapping[str, Any], **kwargs: Any) -> None:
    """Fill a port model (a detector's `.model` or a classifier) from a
    torch state_dict of `model_name`'s layout, in place and strictly."""
    load_jax_variables(model, convert_state_dict(model_name, state_dict,
                                                 **kwargs))
