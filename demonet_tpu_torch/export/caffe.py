"""Caffe deploy-format export: prototxt + caffemodel (counterpart of
demonet_tpu/export/caffe.py).

Given a model of the port, emit

  * net.prototxt   - the Caffe NetParameter in protobuf TEXT format
  * net.caffemodel - the weights in protobuf BINARY format

The protobuf wire format is written by hand (varint and length-delimited
fields) against the standard BVLC Caffe schema's field numbers, with no
protoc step. Each exportable family has a hand-built layer graph
(`CaffeNet` below) read from the port's modules; `tracing.py` converts
any model by walking its `torch.export` graph instead.

The files are byte-equal to the JAX package's for the same weights: the
same layers in the same order under the same names, the same parameters,
and every blob float32 little-endian. The port's weights are in Caffe's
layouts already (conv OIHW, depthwise (C, 1, k, k), Linear (O, I)), so
nothing is transposed; a bf16 model's parameters are float32 (only its
compute dtype is bf16), and a blob is written from the float32 value.

Layer types: Input, Convolution (depthwise through group, atrous through
dilation), BatchNorm + Scale, ReLU, ReLU6 (a literal layer type, as the
mobile-deploy Caffe forks read it), Power, Pooling, InnerProduct,
Eltwise (SUM/PROD), two-bottom Scale, Concat, Softmax, Flatten, Permute,
Reshape and the SSD fork's Normalize. hard-swish and hard-sigmoid are
decomposed exactly into Power/ReLU/Eltwise chains; SE blocks use the
SENet two-bottom-Scale deploy pattern.

Families: the mobilenet_v2 classifier, ssd_lite_mobilenet_v2,
ssd300_vgg16 (conv4_3 Normalize, floor/ceil pooling, atrous fc6),
ssdlite320_mobilenet_v3_large and pelee304, each detector with the
classic SSD deploy tail (Permute/Flatten/Concat, conf Reshape + Softmax).
The graph ends at the raw heads: decode and NMS belong to the SSD fork's
DetectionOutput stage downstream. `python -m demonet_tpu_torch.export.cli
--format caffe` writes the files.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

# ---------------------------------------------------------------------------
# minimal protobuf wire encoding (standard varint / length-delimited)
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _string(field: int, s: str) -> bytes:
    data = s.encode()
    return _tag(field, 2) + _varint(len(data)) + data


def _message(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _uint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _bool(field: int, v: bool) -> bytes:
    return _uint(field, 1 if v else 0)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def _packed_floats(field: int, values: np.ndarray) -> bytes:
    data = np.ascontiguousarray(values, "<f4").tobytes()
    return _tag(field, 2) + _varint(len(data)) + data


def _packed_int64(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return _tag(field, 2) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# Caffe IR
# ---------------------------------------------------------------------------


def as_blob(value: Any) -> np.ndarray:
    """A weight as a float32 C-order numpy array on the host (from a
    tensor on any device, in any float dtype, or an array), copied: a
    blob never shares memory with a parameter."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).numpy()
    return np.array(value, np.float32, order="C")


@dataclasses.dataclass
class Layer:
    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    blobs: List[np.ndarray] = dataclasses.field(default_factory=list)


class CaffeNet:
    """NetParameter builder: one method per layer type. Weights arrive in
    Caffe's layouts (conv OIHW, InnerProduct (O, I)) as tensors or arrays
    and are kept as float32 numpy blobs."""

    def __init__(self, name: str):
        self.name = name
        self.layers: List[Layer] = []
        self.output_tops: List[str] = []

    def input(self, top: str, shape: Sequence[int]) -> str:
        self.layers.append(Layer(top, "Input", [], [top],
                                 {"input_shape": [int(d) for d in shape]}))
        return top

    def conv(self, name: str, bottom: str, weight: Any, bias: Any = None,
             stride: int = 1, pad: int = 0, group: int = 1,
             dilation: int = 1) -> str:
        w = as_blob(weight)
        blobs = [w] + ([as_blob(bias)] if bias is not None else [])
        self.layers.append(Layer(
            name, "Convolution", [bottom], [name],
            {"num_output": w.shape[0],
             "kernel_size": w.shape[2], "stride": stride, "pad": pad,
             "group": group, "dilation": dilation,
             "bias_term": bias is not None}, blobs))
        return name

    def batch_norm(self, name: str, bottom: str, mean: Any, var: Any,
                   scale: Any, bias: Any, eps: float = 1e-5) -> str:
        # Caffe splits BN into BatchNorm (mean/var/scale_factor) + Scale
        self.layers.append(Layer(
            f"{name}_bn", "BatchNorm", [bottom], [name], {"eps": eps},
            [as_blob(mean), as_blob(var), as_blob([1.0])]))
        self.layers.append(Layer(
            f"{name}_scale", "Scale", [name], [name],
            {"bias_term": True}, [as_blob(scale), as_blob(bias)]))
        return name

    def relu(self, name: str, bottom: str) -> str:
        self.layers.append(Layer(name, "ReLU", [bottom], [bottom], {}))
        return bottom

    def relu_out(self, name: str, bottom: str) -> str:
        """ReLU with its own top, for a bottom that other layers read."""
        self.layers.append(Layer(name, "ReLU", [bottom], [name], {}))
        return name

    def relu6(self, name: str, bottom: str) -> str:
        self.layers.append(Layer(name, "ReLU6", [bottom], [bottom], {}))
        return bottom

    def pool(self, name: str, bottom: str, kernel: int, stride: int,
             method: str = "MAX", pad: int = 0,
             global_pooling: bool = False, ceil_mode: bool = True) -> str:
        self.layers.append(Layer(
            name, "Pooling", [bottom], [name],
            {"pool": 0 if method == "MAX" else 1, "kernel_size": kernel,
             "stride": stride, "pad": pad, "global_pooling": global_pooling,
             "round_mode": 0 if ceil_mode else 1}))
        return name

    def normalize(self, name: str, bottom: str, scale: Any) -> str:
        """The SSD fork's Normalize layer (per-channel L2 rescale, the
        conv4_3 trick); blob = the learned per-channel scales."""
        self.layers.append(Layer(
            name, "Normalize", [bottom], [name],
            {"across_spatial": False, "channel_shared": False},
            [as_blob(scale)]))
        return name

    def inner_product(self, name: str, bottom: str, weight: Any,
                      bias: Any = None) -> str:
        w = as_blob(weight)
        blobs = [w] + ([as_blob(bias)] if bias is not None else [])
        self.layers.append(Layer(
            name, "InnerProduct", [bottom], [name],
            {"num_output": w.shape[0], "bias_term": bias is not None}, blobs))
        return name

    def eltwise_sum(self, name: str, a: str, b: str) -> str:
        self.layers.append(Layer(name, "Eltwise", [a, b], [name],
                                 {"operation": 1}))
        return name

    def eltwise_prod(self, name: str, a: str, b: str) -> str:
        self.layers.append(Layer(name, "Eltwise", [a, b], [name],
                                 {"operation": 0}))
        return name

    def power(self, name: str, bottom: str, power: float = 1.0,
              scale: float = 1.0, shift: float = 0.0) -> str:
        """y = (shift + scale * x) ^ power, the stock Power layer."""
        self.layers.append(Layer(name, "Power", [bottom], [name],
                                 {"power": power, "scale": scale,
                                  "shift": shift}))
        return name

    def scale(self, name: str, bottom: str, scale: Any, bias: Any) -> str:
        """One-bottom Scale with learned per-channel blobs (axis 1)."""
        self.layers.append(Layer(name, "Scale", [bottom], [name],
                                 {"bias_term": True},
                                 [as_blob(scale), as_blob(bias)]))
        return name

    def scale_bottoms(self, name: str, bottom: str, scale_bottom: str,
                      axis: int = 0) -> str:
        """Two-bottom Scale: per-channel broadcast multiply, the SENet
        deploy pattern (second bottom (N, C), axis 0)."""
        self.layers.append(Layer(name, "Scale", [bottom, scale_bottom],
                                 [name], {"axis": axis, "bias_term": False}))
        return name

    def concat(self, name: str, bottoms: List[str], axis: int = 1) -> str:
        self.layers.append(Layer(name, "Concat", list(bottoms), [name],
                                 {"axis": axis}))
        return name

    def softmax(self, name: str, bottom: str, axis: int = 1) -> str:
        self.layers.append(Layer(name, "Softmax", [bottom], [name],
                                 {"axis": axis}))
        return name

    def permute(self, name: str, bottom: str, order: Sequence[int]) -> str:
        self.layers.append(Layer(name, "Permute", [bottom], [name],
                                 {"order": [int(o) for o in order]}))
        return name

    def flatten(self, name: str, bottom: str, axis: int = 1) -> str:
        self.layers.append(Layer(name, "Flatten", [bottom], [name],
                                 {"axis": axis}))
        return name

    def reshape(self, name: str, bottom: str, shape: Sequence[int]) -> str:
        self.layers.append(Layer(name, "Reshape", [bottom], [name],
                                 {"shape": [int(d) for d in shape]}))
        return name

    # ---- serialization ----

    def to_prototxt(self) -> str:
        out = [f'name: "{self.name}"']
        out.extend(_layer_prototxt(layer) for layer in self.layers)
        return "\n".join(out) + "\n"

    def to_caffemodel(self) -> bytes:
        return b"".join([_string(1, self.name)] + [
            _message(100, _layer_binary(layer)) for layer in self.layers])


def _conv_param_text(p: Dict) -> str:
    lines = [f"    num_output: {p['num_output']}"]
    if not p.get("bias_term", True):
        lines.append("    bias_term: false")
    if p.get("pad", 0):
        lines.append(f"    pad: {p['pad']}")
    lines.append(f"    kernel_size: {p['kernel_size']}")
    if p.get("group", 1) != 1:
        lines.append(f"    group: {p['group']}")
    if p.get("stride", 1) != 1:
        lines.append(f"    stride: {p['stride']}")
    if p.get("dilation", 1) != 1:
        lines.append(f"    dilation: {p['dilation']}")
    return "\n".join(lines)


def _layer_prototxt(layer: Layer) -> str:
    lines = ["layer {", f'  name: "{layer.name}"', f'  type: "{layer.type}"']
    for b in layer.bottoms:
        lines.append(f'  bottom: "{b}"')
    for t in layer.tops:
        lines.append(f'  top: "{t}"')
    p = layer.params
    if layer.type == "Input":
        dims = " ".join(f"dim: {d}" for d in p["input_shape"])
        lines.append(f"  input_param {{ shape {{ {dims} }} }}")
    elif layer.type == "Convolution":
        lines.append("  convolution_param {")
        lines.append(_conv_param_text(p))
        lines.append("  }")
    elif layer.type == "BatchNorm":
        lines.append("  batch_norm_param { use_global_stats: true "
                     f"eps: {p.get('eps', 1e-5)} }}")
    elif layer.type == "Scale":
        if p.get("bias_term", True):
            lines.append("  scale_param { bias_term: true }")
        else:
            lines.append(f"  scale_param {{ axis: {p.get('axis', 1)} }}")
    elif layer.type == "Power":
        lines.append(
            f"  power_param {{ power: {p.get('power', 1.0)} "
            f"scale: {p.get('scale', 1.0)} shift: {p.get('shift', 0.0)} }}")
    elif layer.type == "Pooling":
        method = "MAX" if p.get("pool", 0) == 0 else "AVE"
        if p.get("global_pooling"):
            lines.append(f"  pooling_param {{ pool: {method} "
                         "global_pooling: true }")
        else:
            extra = f" pad: {p['pad']}" if p.get("pad") else ""
            if p.get("round_mode", 0) == 1:
                extra += " round_mode: FLOOR"
            lines.append(
                f"  pooling_param {{ pool: {method} "
                f"kernel_size: {p['kernel_size']} stride: {p['stride']}"
                f"{extra} }}")
    elif layer.type == "InnerProduct":
        lines.append(f"  inner_product_param {{ num_output: "
                     f"{p['num_output']} }}")
    elif layer.type == "Eltwise":
        op_name = {0: "PROD", 1: "SUM", 2: "MAX"}[p.get("operation", 1)]
        lines.append(f"  eltwise_param {{ operation: {op_name} }}")
    elif layer.type == "Concat":
        lines.append(f"  concat_param {{ axis: {p.get('axis', 1)} }}")
    elif layer.type == "Softmax":
        lines.append(f"  softmax_param {{ axis: {p.get('axis', 1)} }}")
    elif layer.type == "Permute":
        orders = " ".join(f"order: {o}" for o in p["order"])
        lines.append(f"  permute_param {{ {orders} }}")
    elif layer.type == "Flatten":
        lines.append(f"  flatten_param {{ axis: {p.get('axis', 1)} }}")
    elif layer.type == "Reshape":
        dims = " ".join(f"dim: {d}" for d in p["shape"])
        lines.append(f"  reshape_param {{ shape {{ {dims} }} }}")
    elif layer.type == "Normalize":
        lines.append("  norm_param { across_spatial: false "
                     "channel_shared: false }")
    lines.append("}")
    return "\n".join(lines)


def _blob_binary(arr: np.ndarray) -> bytes:
    out = _message(7, _packed_int64(1, arr.shape))  # BlobProto.shape = 7
    return out + _packed_floats(5, arr.reshape(-1))  # BlobProto.data = 5


def _layer_binary(layer: Layer) -> bytes:
    # LayerParameter: name=1, type=2, bottom=3, top=4, blobs=7
    out = [_string(1, layer.name), _string(2, layer.type)]
    out += [_string(3, b) for b in layer.bottoms]
    out += [_string(4, t) for t in layer.tops]
    out += [_message(7, _blob_binary(as_blob(blob))) for blob in layer.blobs]
    p = layer.params
    if layer.type == "Convolution":
        cp = _uint(1, p["num_output"])
        if not p.get("bias_term", True):
            cp += _bool(2, False)
        if p.get("pad", 0):
            cp += _uint(3, p["pad"])
        cp += _uint(4, p["kernel_size"])
        if p.get("group", 1) != 1:
            cp += _uint(5, p["group"])
        if p.get("stride", 1) != 1:
            cp += _uint(6, p["stride"])
        if p.get("dilation", 1) != 1:
            cp += _uint(18, p["dilation"])
        out.append(_message(106, cp))  # convolution_param = 106
    elif layer.type == "BatchNorm":
        bp = _bool(1, True) + _float(3, p.get("eps", 1e-5))
        out.append(_message(139, bp))  # batch_norm_param = 139
    elif layer.type == "Scale":
        if p.get("bias_term", True):
            # scale_param.bias_term = 4
            out.append(_message(142, _bool(4, True)))
        else:
            # ScaleParameter: axis = 1
            out.append(_message(142, _uint(1, p.get("axis", 1))))
    elif layer.type == "Power":
        # PowerParameter: power = 1, scale = 2, shift = 3
        out.append(_message(122, _float(1, p.get("power", 1.0))
                            + _float(2, p.get("scale", 1.0))
                            + _float(3, p.get("shift", 0.0))))
    elif layer.type == "Pooling":
        pp = _uint(1, p.get("pool", 0)) + _uint(2, p.get("kernel_size", 1))
        if p.get("pad", 0):
            pp += _uint(4, p["pad"])
        pp += _uint(3, p.get("stride", 1))
        if p.get("global_pooling"):
            pp += _bool(12, True)
        if p.get("round_mode", 0) == 1:
            pp += _uint(13, 1)  # FLOOR
        out.append(_message(103, pp))  # pooling_param = 103
    elif layer.type == "Normalize":
        # the SSD fork's NormalizeParameter (norm_param = 206 there):
        # across_spatial = 1, channel_shared = 3
        out.append(_message(206, _bool(1, False) + _bool(3, False)))
    elif layer.type == "InnerProduct":
        out.append(_message(117, _uint(1, p["num_output"])))
    elif layer.type == "Eltwise":
        # EltwiseOp enum: PROD = 0, SUM = 1, MAX = 2
        out.append(_message(110, _uint(1, p.get("operation", 1))))
    elif layer.type == "Concat":
        out.append(_message(104, _uint(2, p.get("axis", 1))))
    elif layer.type == "Softmax":
        out.append(_message(125, _uint(1, p.get("axis", 1))))
    elif layer.type == "Reshape":
        # a negative dim as its two's complement in 64 bits (int64 varint)
        out.append(_message(133, _message(1, _packed_int64(
            1, [d if d >= 0 else d + (1 << 64) for d in p["shape"]]))))
    elif layer.type == "Input":
        out.append(_message(147, _message(1, _packed_int64(
            1, p["input_shape"]))))
    return b"".join(out)


# ---------------------------------------------------------------------------
# model-family graph builders (read from the port's modules)
# ---------------------------------------------------------------------------


def _conv_bn(net: CaffeNet, name: str, bottom: str, conv: nn.Conv2d,
             bn: nn.BatchNorm2d) -> str:
    """A bias-free conv and its BN (BatchNorm + Scale), the conv's
    stride, padding, groups and dilation as the module has them."""
    top = net.conv(name, bottom, conv.weight, None, stride=conv.stride[0],
                   pad=conv.padding[0], group=conv.groups,
                   dilation=conv.dilation[0])
    net.batch_norm(name, top, bn.running_mean, bn.running_var, bn.weight,
                   bn.bias, eps=bn.eps)
    return top


def _conv_bn_act(net: CaffeNet, name: str, bottom: str, cba: nn.Module,
                 act: bool = True) -> str:
    """A `layers.ConvBNAct` (`conv`, `bn`), with a ReLU6 if `act`."""
    top = _conv_bn(net, name, bottom, cba.conv, cba.bn)
    if act:
        net.relu6(f"{name}_relu", top)
    return top


def _plain_conv(net: CaffeNet, name: str, bottom: str,
                conv: nn.Conv2d) -> str:
    """A conv with its own bias and no BN (heads, VGG)."""
    return net.conv(name, bottom, conv.weight, conv.bias,
                    stride=conv.stride[0], pad=conv.padding[0],
                    dilation=conv.dilation[0])


def _mnv2_trunk_to_caffe(net: CaffeNet, features: nn.Module, bottom: str,
                         tap_blocks: Sequence[int] = ()):
    """`MobileNetV2Features` (stem, 17 inverted residuals, last conv):
    returns (final top, the tops after each block index in tap_blocks,
    counted from 1)."""
    taps = []
    bottom = _conv_bn_act(net, "stem", bottom, features.stem)
    for i, block in enumerate(features.blocks):
        prefix = f"block{i}"
        x = bottom
        layers = list(block.layers)
        if len(layers) == 3:
            x = _conv_bn_act(net, f"{prefix}_expand", x, layers[0])
        x = _conv_bn_act(net, f"{prefix}_dw", x, layers[-2])
        x = _conv_bn_act(net, f"{prefix}_project", x, layers[-1], act=False)
        if block.use_res_connect:
            x = net.eltwise_sum(f"{prefix}_add", bottom, x)
        bottom = x
        if i + 1 in tap_blocks:
            taps.append(bottom)
    return _conv_bn_act(net, "last_conv", bottom, features.last_conv), taps


def mobilenet_v2_to_caffe(model: nn.Module, num_classes: int = 1000,
                          input_size: int = 224) -> CaffeNet:
    """The mobilenet_v2 classifier (`MobileNetV2`) as a Caffe graph:
    trunk, global AVE pool, InnerProduct, Softmax ("prob")."""
    net = CaffeNet("mobilenet_v2")
    bottom = net.input("data", [1, 3, input_size, input_size])
    bottom, _ = _mnv2_trunk_to_caffe(net, model.features, bottom)
    bottom = net.pool("global_pool", bottom, 1, 1, "AVE",
                      global_pooling=True)
    bottom = net.inner_product("classifier", bottom, model.classifier.weight,
                               model.classifier.bias)
    net.softmax("prob", bottom)
    return net


def _ssd_tail(net: CaffeNet, loc_flats: List[str], conf_flats: List[str],
              num_classes: int) -> None:
    """The classic SSD deploy tail: Concat per head, conf Reshape+Softmax."""
    net.concat("mbox_loc", loc_flats, axis=1)
    conf = net.concat("mbox_conf", conf_flats, axis=1)
    conf = net.reshape("mbox_conf_reshape", conf, [0, -1, num_classes])
    conf = net.softmax("mbox_conf_softmax", conf, axis=2)
    net.flatten("mbox_conf_flatten", conf, axis=1)


def _heads_to_caffe(net: CaffeNet, head: nn.Module, sources: Sequence[str],
                    level, num_classes: int) -> None:
    """Each level's regression then classification head, as
    level(name, source top, module) emits it, then Permute + Flatten, and
    the SSD tail."""
    loc_flats, conf_flats = [], []
    for k, src in enumerate(sources):
        for kind, store in (("reg", loc_flats), ("cls", conf_flats)):
            name = f"{kind}{k}"
            t = level(name, src, getattr(head, kind)[k])
            t = net.permute(f"{name}_perm", t, [0, 2, 3, 1])
            store.append(net.flatten(f"{name}_flat", t))
    _ssd_tail(net, loc_flats, conf_flats, num_classes)


def _separable_level(net: CaffeNet):
    """An SSDLite head level: `SeparableConv` (dw ConvBNAct + pw conv), or
    a plain 1x1 conv (the legacy model's last level)."""
    def level(name, src, m):
        if hasattr(m, "dw"):
            src = _conv_bn_act(net, f"{name}_dw", src, m.dw)
            m = m.pw
        return _plain_conv(net, f"{name}_pw", src, m)
    return level


def ssd_lite_mobilenet_v2_to_caffe(model: nn.Module, num_classes: int = 21,
                                   input_size: int = 320) -> CaffeNet:
    """ssd_lite_mobilenet_v2 (its `SSD` module) as an SSD deploy graph:
    trunk (taps after block 13 and the last conv), extras, SSDLite heads,
    per-level Permute + Flatten, Concat over levels, Softmax on the class
    scores."""
    ex = model.extractor
    net = CaffeNet("ssd_lite_mobilenet_v2")
    bottom = net.input("data", [1, 3, input_size, input_size])
    final, taps = _mnv2_trunk_to_caffe(net, ex.trunk, bottom, tap_blocks=[13])
    sources = taps + [final]
    x = final
    for e, block in enumerate(ex.extras):
        prefix = f"extra{e}"
        x = _conv_bn_act(net, f"{prefix}_pw", x, block.pw)
        x = _conv_bn_act(net, f"{prefix}_dw", x, block.dw)
        x = _conv_bn_act(net, f"{prefix}_pw_linear", x, block.pw_linear,
                         act=False)
        sources.append(x)
    _heads_to_caffe(net, model.head, sources, _separable_level(net),
                    num_classes)
    return net


def ssd300_vgg16_to_caffe(model: nn.Module, num_classes: int = 91,
                          input_size: int = 300) -> CaffeNet:
    """SSD300-VGG16 as the classic SSD deploy graph: the VGG trunk with
    floor-mode pools 1/2/4 and a ceil-mode pool3, conv4_3 Normalize, the
    atrous fc6, the extras, plain 3x3 conv heads and the SSD tail."""
    ex = model.extractor
    net = CaffeNet("ssd300_vgg16")
    bottom = net.input("data", [1, 3, input_size, input_size])

    def conv_relu(name):
        nonlocal bottom
        bottom = _plain_conv(net, name, bottom, getattr(ex, name))
        bottom = net.relu(f"{name}_relu", bottom)

    for n in ("conv1_1", "conv1_2"):
        conv_relu(n)
    bottom = net.pool("pool1", bottom, 2, 2, ceil_mode=False)
    for n in ("conv2_1", "conv2_2"):
        conv_relu(n)
    bottom = net.pool("pool2", bottom, 2, 2, ceil_mode=False)
    for n in ("conv3_1", "conv3_2", "conv3_3"):
        conv_relu(n)
    bottom = net.pool("pool3", bottom, 2, 2, ceil_mode=True)
    for n in ("conv4_1", "conv4_2", "conv4_3"):
        conv_relu(n)
    conv4_3 = bottom
    sources = [net.normalize("conv4_3_norm", conv4_3, ex.scale_weight)]

    bottom = net.pool("pool4", conv4_3, 2, 2, ceil_mode=False)
    for n in ("conv5_1", "conv5_2", "conv5_3"):
        conv_relu(n)
    bottom = net.pool("pool5", bottom, 3, 1, pad=1)
    conv_relu("fc6")
    conv_relu("fc7")
    sources.append(bottom)
    for a, b in (("conv8_1", "conv8_2"), ("conv9_1", "conv9_2"),
                 ("conv10_1", "conv10_2"), ("conv11_1", "conv11_2")):
        conv_relu(a)
        conv_relu(b)
        sources.append(bottom)

    _heads_to_caffe(
        net, model.head, sources,
        lambda name, src, m: _plain_conv(net, f"{name}_conv", src, m),
        num_classes)
    return net


def _hsigmoid(net: CaffeNet, name: str, bottom: str) -> str:
    """hard_sigmoid(x) = clip(x+3, 0, 6)/6, decomposed exactly into stock
    Power/ReLU layers: relu(x+3) -> 6-y -> relu -> (6-y)/6."""
    t = net.power(f"{name}_shift3", bottom, shift=3.0)
    t = net.relu(f"{name}_relu_lo", t)
    t = net.power(f"{name}_flip", t, scale=-1.0, shift=6.0)
    t = net.relu(f"{name}_relu_hi", t)
    return net.power(f"{name}_norm", t, scale=-1.0 / 6.0, shift=1.0)


def _hswish(net: CaffeNet, name: str, bottom: str) -> str:
    """hard_swish(x) = x * hard_sigmoid(x) (elementwise, same shape)."""
    gate = _hsigmoid(net, f"{name}_hsig", bottom)
    return net.eltwise_prod(f"{name}_prod", bottom, gate)


def _act_to_caffe(net: CaffeNet, name: str, bottom: str, hswish: bool
                  ) -> str:
    if hswish:
        return _hswish(net, name, bottom)
    return net.relu(f"{name}_relu", bottom)


def _se_to_caffe(net: CaffeNet, name: str, bottom: str, se: nn.Module) -> str:
    """`layers.SqueezeExcitation` as the SENet deploy pattern: global AVE
    pool -> 1x1 convs -> hard-sigmoid -> Flatten -> two-bottom Scale
    (axis 0)."""
    s = net.pool(f"{name}_pool", bottom, 1, 1, "AVE", global_pooling=True)
    s = _plain_conv(net, f"{name}_fc1", s, se.fc1)
    s = net.relu(f"{name}_fc1_relu", s)
    s = _plain_conv(net, f"{name}_fc2", s, se.fc2)
    s = _hsigmoid(net, f"{name}_gate", s)
    s = net.flatten(f"{name}_flat", s)
    return net.scale_bottoms(f"{name}_scale", bottom, s, axis=0)


def _mnv3_trunk_to_caffe(net: CaffeNet, trunk: nn.Module, bottom: str):
    """`MobileNetV3Features` with the C4 split: returns (final top, [the
    C4 tap: the expand 1x1 of the last strided block])."""
    taps = []
    bottom = _conv_bn(net, "stem", bottom, trunk.stem.conv, trunk.stem.bn)
    bottom = _act_to_caffe(net, "stem", bottom, True)
    for i, (cfg, block) in enumerate(zip(trunk.configs, trunk.blocks)):
        prefix = f"block{i}"
        x = bottom
        if block.expand_conv is not None:
            x = _conv_bn(net, f"{prefix}_expand", x, block.expand_conv.conv,
                         block.expand_conv.bn)
            x = _act_to_caffe(net, f"{prefix}_expand", x, cfg.use_hs)
        if i == trunk.c4_block_index:
            taps.append(x)
        x = _conv_bn(net, f"{prefix}_dw", x, block.depthwise.conv,
                     block.depthwise.bn)
        x = _act_to_caffe(net, f"{prefix}_dw", x, cfg.use_hs)
        if block.se is not None:
            x = _se_to_caffe(net, f"{prefix}_se", x, block.se)
        x = _conv_bn(net, f"{prefix}_project", x, block.project.conv,
                     block.project.bn)
        if block.use_res_connect:
            x = net.eltwise_sum(f"{prefix}_add", bottom, x)
        bottom = x
    bottom = _conv_bn(net, "last_conv", bottom, trunk.last_conv.conv,
                      trunk.last_conv.bn)
    return _act_to_caffe(net, "last_conv", bottom, True), taps


def ssdlite320_mobilenet_v3_large_to_caffe(
        model: nn.Module, num_classes: int = 91,
        input_size: int = 320) -> CaffeNet:
    """The flagship (its `SSD` module) as a Caffe deploy graph:
    MobileNetV3-Large trunk (C4 split), 4 SSDLite extras, depthwise-
    separable heads. hard-swish/hard-sigmoid are decomposed exactly into
    stock Power/ReLU/Eltwise layers; SE uses the two-bottom Scale."""
    ex = model.extractor
    net = CaffeNet("ssdlite320_mobilenet_v3_large")
    bottom = net.input("data", [1, 3, input_size, input_size])
    final, taps = _mnv3_trunk_to_caffe(net, ex.trunk, bottom)
    sources = taps + [final]
    x = final
    for e, block in enumerate(ex.extras):
        prefix = f"extra{e}"
        x = _conv_bn_act(net, f"{prefix}_proj", x, block.proj)
        x = _conv_bn_act(net, f"{prefix}_dw", x, block.dw)
        x = _conv_bn_act(net, f"{prefix}_expand", x, block.expand)
        sources.append(x)
    _heads_to_caffe(net, model.head, sources, _separable_level(net),
                    num_classes)
    return net


def _pelee_basic(net: CaffeNet, name: str, bottom: str,
                 m: nn.Module) -> str:
    """`peleenet.BasicConv2d`: conv + BN + ReLU if it has one."""
    top = _conv_bn(net, name, bottom, m.conv, m.norm)
    if m.activation:
        net.relu(f"{name}_relu", top)
    return top


def pelee304_to_caffe(model: nn.Module, num_classes: int = 21,
                      input_size: int = 304) -> CaffeNet:
    """Pelee-SSD 304 (its `SSD` module) as a Caffe deploy graph, the
    architecture's native format: two-way stem, two-branch dense layers,
    ceil-mode AVE transition pools, 6 extra convs, per-source ResBlocks,
    1x1 heads."""
    ex = model.extractor
    trunk = ex.trunk
    net = CaffeNet("pelee304")
    bottom = net.input("data", [1, 3, input_size, input_size])

    stem = trunk.stemblock
    out = _pelee_basic(net, "stem1", bottom, stem.stem1)
    b2 = _pelee_basic(net, "stem2a", out, stem.stem2a)
    b2 = _pelee_basic(net, "stem2b", b2, stem.stem2b)
    b1 = net.pool("stem_pool", out, 2, 2, "MAX", ceil_mode=True)
    x = net.concat("stem_concat", [b1, b2])
    x = _pelee_basic(net, "stem3", x, stem.stem3)

    sources = []
    last = len(trunk.block_config) - 1
    for i, num_layers in enumerate(trunk.block_config):
        for j in range(num_layers):
            name = f"denseblock{i + 1}_layer{j + 1}"
            d = getattr(trunk, name)
            b1 = _pelee_basic(net, f"{name}_b1a", x, d.branch1a)
            b1 = _pelee_basic(net, f"{name}_b1b", b1, d.branch1b)
            b2 = _pelee_basic(net, f"{name}_b2a", x, d.branch2a)
            b2 = _pelee_basic(net, f"{name}_b2b", b2, d.branch2b)
            b2 = _pelee_basic(net, f"{name}_b2c", b2, d.branch2c)
            x = net.concat(f"{name}_concat", [x, b1, b2])
        x = _pelee_basic(net, f"transition{i + 1}", x,
                         getattr(trunk, f"transition{i + 1}"))
        if i == 2:
            sources.append(x)  # the transition3 tap
        if i != last:
            x = net.pool(f"transition{i + 1}_pool", x, 2, 2, "AVE",
                         ceil_mode=True)
    sources.append(x)  # transition4, the trunk's output

    for k, block in enumerate(ex.extras):
        x = _pelee_basic(net, f"extras_{k}", x, block)
        if k % 2 == 1:
            sources.append(x)

    refined = []
    for k, (src, rb) in enumerate(zip(sources, ex.resblock)):
        def conv_relu(part, btm):
            t = _plain_conv(net, f"res{k}_{part}", btm,
                            getattr(rb, part).conv)
            return net.relu(f"res{k}_{part}_relu", t)

        o1 = conv_relu("res1a", src)
        o1 = conv_relu("res1b", o1)
        o1 = conv_relu("res1c", o1)
        o2 = conv_relu("res2a", src)
        refined.append(net.eltwise_sum(f"res{k}_add", o1, o2))

    _heads_to_caffe(
        net, model.head, refined,
        lambda name, src, m: _plain_conv(net, f"{name}_conv", src, m),
        num_classes)
    return net


BUILDERS = {
    "mobilenet_v2": mobilenet_v2_to_caffe,
    "ssd_lite_mobilenet_v2": ssd_lite_mobilenet_v2_to_caffe,
    "ssd300_vgg16": ssd300_vgg16_to_caffe,
    "ssdlite320_mobilenet_v3_large": ssdlite320_mobilenet_v3_large_to_caffe,
    "pelee304": pelee304_to_caffe,
}


def write_caffe(net: CaffeNet, prototxt_path: str,
                caffemodel_path: str) -> None:
    """Write the net's prototxt and caffemodel."""
    with open(prototxt_path, "w") as f:
        f.write(net.to_prototxt())
    with open(caffemodel_path, "wb") as f:
        f.write(net.to_caffemodel())


def export_caffe(model_name: str, model: nn.Module, prototxt_path: str,
                 caffemodel_path: str, **kwargs: Any) -> CaffeNet:
    """Build the family's hand-built graph from `model` (a classifier, or
    a detector's `SSD` module) and write its files; returns the net."""
    if model_name not in BUILDERS:
        raise ValueError(
            f"Caffe export supports {sorted(BUILDERS)}; the torch.export "
            "program (export/program.py) covers every detector and the "
            "generic route (export/tracing.py) every model.")
    net = BUILDERS[model_name](model, **kwargs)
    write_caffe(net, prototxt_path, caffemodel_path)
    return net
