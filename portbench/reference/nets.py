"""The detectors' forward passes in plain PyTorch (NCHW inside, NHWC in).

`build(config)` returns a `Net` for a configuration file's `arch`:

  * "ssdlite_mobilenet_v3_large": MobileNetV3-Large with the reduced tail,
    tapped after the expand 1x1 of its last strided block (C4, 672 x
    20^2 at 320) and at its last 1x1 conv (480 x 10^2), four SSDLite extra
    blocks (512, 256, 256, 128), and a depthwise-separable head. Every BN
    has eps 1e-3 and momentum 0.03.
  * "ssd_vgg16": VGG16 (configuration D) through conv5_3 with pool3 in
    ceil mode, conv4_3 L2-normalised by a learned scale, pool5 3x3 s1,
    the atrous fc6 and fc7, the extras conv8 ... conv11, and plain 3x3
    heads. No BN.

Any other `arch` is a file of its own, `reference/archs/<arch>.py` under
`ARCHS`, loaded by path as a metric's reader is. It imports nothing but
`torch` and this package (`from reference import nets`): nothing of the
program, of the JAX package or of JAX. It defines

    build(config, anchors_per_location, num_classes) -> Net

called inside `build`'s device context, and makes its layers of `Conv`,
`BN` and `Head` (with `Net` around them), so that `set_precision`, the
benchmark's seeded weights (init rules by module name), `Net.grid_sizes`
and the FLOP count work on it unchanged. So a configuration with a new
architecture enters as new files only.

Train-mode BN normalises by the batch's biased variance, E[x^2] - E[x]^2
clamped at 0, and moves its running statistics by running = (1 - m) *
running + m * batch with that same variance: the rule the configuration
states (the program's BN follows it too).

Precision: `set_precision(net, p)` makes every conv compute on its input
and weight rounded first, the product accumulated in float32 as the
tensor cores do: "tf32" rounds them to TF32 (10 mantissa bits, to
nearest), the control of a float32 configuration; "fp8" to float8 e4m3
under one scale per tensor (the largest magnitude to 448), the control
of a bfloat16 one; "bf16" to bfloat16, a witness of what that precision
alone moves; "bf16_out" rounds the conv's output (bias added) to
bfloat16 too, as a bfloat16 conv of the program gives it, so that the
head outputs the loss ranks are bfloat16 values. The gradient passes the
rounding straight through.
"""

from __future__ import annotations

import functools
import importlib.util
import os
from types import ModuleType
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_FP8_MAX = 448.0
# where `build` finds the file of an arch it has no branch for
ARCHS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "archs")


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0.0).clamp(max=6.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 under a per-tensor scale, back in float32."""
    scale = _FP8_MAX / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


_ROUND = {"tf32": _tf32, "bf16": _bf16, "bf16_out": _bf16, "fp8": _fp8}


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to `precision`; the gradient of the rounding is 1."""
    return x + (_ROUND[precision](x.detach()) - x.detach())


class Conv(nn.Module):
    """A conv with optional bias and symmetric padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = -1, dilation: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = (k - 1) // 2 * dilation if padding < 0 else padding
        self.precision = "fp32"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.precision != "fp32":
            x, w = rounded(x, self.precision), rounded(w, self.precision)
        y = F.conv2d(x, w, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return rounded(y, "bf16") if self.precision == "bf16_out" else y


class BN(nn.Module):
    """BatchNorm2d with the configuration's train-mode rule (see above)."""

    def __init__(self, c: int, eps: float = 1e-3, momentum: float = 0.03):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps, self.momentum = eps, momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            n = x.numel() // x.shape[1]
            mean = x.sum((0, 2, 3)) / n
            var = ((x * x).sum((0, 2, 3)) / n - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, act=relu6):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, groups=groups, bias=False)
        self.bn = BN(cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class SE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        s = make_divisible(c // 4, 8)
        self.fc1 = Conv(c, s, 1)
        self.fc2 = Conv(s, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, k: int, exp: int, cout: int, se: bool,
                 hs: bool, stride: int):
        super().__init__()
        act = hard_swish if hs else torch.relu
        self.expand_conv = (ConvBNAct(cin, exp, 1, act=act) if exp != cin
                            else None)
        self.depthwise = ConvBNAct(exp, exp, k, stride, groups=exp, act=act)
        self.se = SE(exp) if se else None
        self.project = ConvBNAct(exp, cout, 1, act=None)
        self.residual = stride == 1 and cin == cout

    def expand(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.expand_conv is None else self.expand_conv(x)

    def rest(self, x: torch.Tensor) -> torch.Tensor:
        y = self.depthwise(x)
        if self.se is not None:
            y = self.se(y)
        return self.project(y)


# MobileNetV3-Large with the reduced tail: (in, kernel, expanded, out, SE,
# hard-swish, stride)
_V3_LARGE = (
    (16, 3, 16, 16, False, False, 1), (16, 3, 64, 24, False, False, 2),
    (24, 3, 72, 24, False, False, 1), (24, 5, 72, 40, True, False, 2),
    (40, 5, 120, 40, True, False, 1), (40, 5, 120, 40, True, False, 1),
    (40, 3, 240, 80, False, True, 2), (80, 3, 200, 80, False, True, 1),
    (80, 3, 184, 80, False, True, 1), (80, 3, 184, 80, False, True, 1),
    (80, 3, 480, 112, True, True, 1), (112, 3, 672, 112, True, True, 1),
    (112, 5, 672, 80, True, True, 2), (80, 5, 480, 80, True, True, 1),
    (80, 5, 480, 80, True, True, 1))


class Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBNAct(3, 16, 3, 2, act=hard_swish)
        self.blocks = nn.ModuleList(InvertedResidual(*row) for row in _V3_LARGE)
        self.last_conv = ConvBNAct(80, 480, 1, act=hard_swish)
        self.c4 = max(i for i, row in enumerate(_V3_LARGE) if row[6] > 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        out = []
        for i, block in enumerate(self.blocks):
            e = block.expand(x)
            if i == self.c4:
                out.append(e)
            y = block.rest(e)
            x = x + y if block.residual else y
        out.append(self.last_conv(x))
        return out


class ExtraBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        mid = cout // 2
        self.proj = ConvBNAct(cin, mid, 1)
        self.dw = ConvBNAct(mid, mid, 3, 2, groups=mid)
        self.expand = ConvBNAct(mid, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(self.dw(self.proj(x)))


class SSDLiteExtractor(nn.Module):
    out_channels = (672, 480, 512, 256, 256, 128)

    def __init__(self):
        super().__init__()
        self.trunk = Trunk()
        self.extras = nn.ModuleList(
            ExtraBlock(i, o) for i, o in zip(self.out_channels[1:-1],
                                             self.out_channels[2:]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = self.trunk(x)
        x = out[-1]
        for block in self.extras:
            x = block(x)
            out.append(x)
        return out


class SeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dw = ConvBNAct(cin, cin, 3, groups=cin)
        self.pw = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


# (name, in, out, kernel, stride, padding) after fc7
_VGG_EXTRAS = (("conv8_1", 1024, 256, 1, 1, 0), ("conv8_2", 256, 512, 3, 2, 1),
               ("conv9_1", 512, 128, 1, 1, 0), ("conv9_2", 128, 256, 3, 2, 1),
               ("conv10_1", 256, 128, 1, 1, 0), ("conv10_2", 128, 256, 3, 1, 0),
               ("conv11_1", 256, 128, 1, 1, 0), ("conv11_2", 128, 256, 3, 1, 0))
_VGG_TRUNK = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))


class VGGExtractor(nn.Module):
    out_channels = (512, 1024, 512, 256, 256, 256)

    def __init__(self):
        super().__init__()
        c = 3
        for blk, n, out in _VGG_TRUNK:
            for i in range(1, n + 1):
                self.add_module(f"conv{blk}_{i}", Conv(c, out, 3, padding=1))
                c = out
        self.scale_weight = nn.Parameter(torch.full((512,), 20.0))
        self.fc6 = Conv(512, 1024, 3, padding=6, dilation=6)
        self.fc7 = Conv(1024, 1024, 1, padding=0)
        for name, ci, co, k, s, p in _VGG_EXTRAS:
            self.add_module(name, Conv(ci, co, k, s, padding=p))

    def _block(self, x: torch.Tensor, blk: int, n: int) -> torch.Tensor:
        for i in range(1, n + 1):
            x = torch.relu(getattr(self, f"conv{blk}_{i}")(x))
        return x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(self._block(x, 1, 2), 2, 2)
        x = F.max_pool2d(self._block(x, 2, 2), 2, 2)
        x = F.max_pool2d(self._block(x, 3, 3), 2, 2, ceil_mode=True)
        x = self._block(x, 4, 3)
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        out = [self.scale_weight[None, :, None, None] * x
               / norm.clamp(min=1e-12)]
        x = self._block(F.max_pool2d(x, 2, 2), 5, 3)
        x = F.max_pool2d(x, 3, 1, padding=1)
        x = torch.relu(self.fc7(torch.relu(self.fc6(x))))
        out.append(x)
        for i in range(0, len(_VGG_EXTRAS), 2):
            x = torch.relu(getattr(self, _VGG_EXTRAS[i][0])(x))
            x = torch.relu(getattr(self, _VGG_EXTRAS[i + 1][0])(x))
            out.append(x)
        return out


class Head(nn.Module):
    def __init__(self, make, in_channels: Sequence[int],
                 anchors: Sequence[int], num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.cls = nn.ModuleList(make(c, a * num_classes)
                                 for c, a in zip(in_channels, anchors))
        self.reg = nn.ModuleList(make(c, a * 4)
                                 for c, a in zip(in_channels, anchors))

    @staticmethod
    def _flat(outs: List[torch.Tensor], k: int) -> torch.Tensor:
        return torch.cat([o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, k)
                          for o in outs], dim=1)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        cls = [m(f) for m, f in zip(self.cls, feats)]
        reg = [m(f) for m, f in zip(self.reg, feats)]
        return {"cls_logits": self._flat(cls, self.num_classes),
                "bbox_regression": self._flat(reg, 4)}


class Net(nn.Module):
    """extractor + head; NHWC images in, {'cls_logits': (B, A, C),
    'bbox_regression': (B, A, 4)} out."""

    def __init__(self, extractor: nn.Module, head: nn.Module):
        super().__init__()
        self.extractor, self.head = extractor, head

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.head(self.extractor(images.permute(0, 3, 1, 2)))

    def grid_sizes(self, size: Tuple[int, int]) -> List[Tuple[int, int]]:
        """(H, W) of each feature map, from a forward on the meta device."""
        meta = {k: v.to("meta") for k, v in self.extractor.state_dict().items()}
        x = torch.empty((1, 3, *size), device="meta")
        with torch.no_grad():
            outs = torch.func.functional_call(self.extractor, meta, (x,))
        return [tuple(int(d) for d in o.shape[2:]) for o in outs]


def anchors_per_location(aspect_ratios: Sequence[Sequence[float]]) -> List[int]:
    return [2 + 2 * len(r) for r in aspect_ratios]


def build(config: dict, device="cpu") -> Net:
    """The reference net of a configuration file's `arch`, its parameters
    uninitialised (the benchmark fills them)."""
    a = anchors_per_location(config["aspect_ratios"])
    c = config["num_classes"]
    with torch.device(device):
        if config["arch"] == "ssdlite_mobilenet_v3_large":
            ext = SSDLiteExtractor()
            head = Head(SeparableConv, ext.out_channels, a, c)
        elif config["arch"] == "ssd_vgg16":
            ext = VGGExtractor()
            head = Head(lambda ci, co: Conv(ci, co, 3, padding=1),
                        ext.out_channels, a, c)
        else:
            return arch_file(config["arch"]).build(config, a, c)
        return Net(ext, head)


def arch_file(arch: str) -> ModuleType:
    """`ARCHS/<arch>.py` as a module (see the module doc)."""
    path = os.path.join(ARCHS, f"{arch}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no reference for arch {arch!r}: no branch in "
                         f"nets.build and no file {path}")
    return _load(path)


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ModuleType:
    """The file at `path`, executed once a process."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        f"portbench_arch_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_precision(net: nn.Module, precision: str) -> nn.Module:
    """"fp32", "tf32", "bf16" or "fp8" for every conv of the net (see the
    module doc)."""
    if precision != "fp32" and precision not in _ROUND:
        raise ValueError(f"precision {precision!r}")
    for m in net.modules():
        if isinstance(m, Conv):
            m.precision = precision
    return net
