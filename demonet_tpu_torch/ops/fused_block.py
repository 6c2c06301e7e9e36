"""Fused inverted-residual block, inference (counterpart of
demonet_tpu/ops/fused_block.py).

`fused_inverted_residual` is the wrapper of the hand-written CUDA kernel
`csrc/fused_block.cu`, which replaces the TPU kernel
demonet_tpu/ops/fused_block.py::fused_inverted_residual: 1x1 expand +
folded BN + act, 3x3 depthwise (stride 1 or 2) + folded BN + act, 1x1
project + folded BN, and the residual when stride is 1 and CI == CO, with
the expanded map kept on chip. On a CUDA tensor it launches the kernel; on
a CPU tensor it runs `fused_inverted_residual_plain`, the same block as a
sequence of `F.conv2d` calls on the folded weights.

Layout: NCHW, (B, CI, H, W) in and (B, CO, H / stride, W / stride) out,
as the port's trunk takes it (the JAX version is NHWC).

Eligible blocks, as in the JAX package: a 3x3 depthwise conv, no
squeeze-excite, relu, relu6 or hard-swish: MobileNetV3-Large blocks 0-2
and every MobileNetV2 block. Like the JAX kernel, it is not wired into the
model (`models/mobilenetv3.py` runs the unfused modules): it is kept, with
its tests, as the starting point for fusing the early blocks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from demonet_tpu_torch.models.layers import (
    ConvBNAct,
    InvertedResidualV3,
    hard_swish,
    relu6,
)
from demonet_tpu_torch.ops import _build

Folded = Dict[str, torch.Tensor]

_ACTS = {"relu": 0, "relu6": 1, "hswish": 2}


@torch.no_grad()
def fold_conv_bn(layer: ConvBNAct) -> Folded:
    """A ConvBNAct's conv and eval-mode BN as one conv with a bias:
    y = conv(x, w * s) + (beta - mean * s), s = gamma / sqrt(var + eps),
    with the BN's own eps (1e-3 on the MobileNetV3 trunk, 1e-5 in
    MobileNetV2 blocks)."""
    bn = layer.bn
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return {"weight": layer.conv.weight * s[:, None, None, None],
            "bias": bn.bias - bn.running_mean * s}


def fold_inverted_residual(block: InvertedResidualV3) -> Dict:
    """The folded weights and options of an eligible block, as keyword
    arguments of `fused_inverted_residual`."""
    dw = block.depthwise
    if block.se is not None or dw.conv.kernel_size != (3, 3) \
            or dw.conv.dilation != (1, 1):
        raise ValueError("fused_inverted_residual takes blocks with a 3x3 "
                         "undilated depthwise conv and no squeeze-excite")
    act = {torch.relu: "relu", relu6: "relu6", hard_swish: "hswish"}[dw.act]
    return {"expand": (fold_conv_bn(block.expand_conv)
                       if block.expand_conv is not None else None),
            "depthwise": fold_conv_bn(dw), "project": fold_conv_bn(block.project),
            "stride": dw.conv.stride[0], "act": act}


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "relu6":
        return relu6(x)
    return hard_swish(x)


def fused_inverted_residual_plain(x: torch.Tensor, expand: Optional[Folded],
                                  depthwise: Folded, project: Folded,
                                  stride: int = 1,
                                  act: str = "relu") -> torch.Tensor:
    """The block as F.conv2d calls on the folded weights."""
    y = x if expand is None else _act(
        F.conv2d(x, expand["weight"], expand["bias"]), act)
    y = _act(F.conv2d(y, depthwise["weight"], depthwise["bias"],
                      stride=stride, padding=1, groups=y.shape[1]), act)
    y = F.conv2d(y, project["weight"], project["bias"])
    return x + y if stride == 1 and x.shape[1] == y.shape[1] else y


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("fused_block").fused_inverted_residual
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_inverted_residual(x: torch.Tensor, expand: Optional[Folded],
                            depthwise: Folded, project: Folded,
                            stride: int = 1,
                            act: str = "relu") -> torch.Tensor:
    """Inference forward of one inverted-residual block, fused.

    Args:
      x: (B, CI, H, W) float32.
      expand: folded {'weight': (CE, CI, 1, 1), 'bias': (CE,)}, or None
        when the block has no expand conv (CE == CI).
      depthwise: folded {'weight': (CE, 1, 3, 3), 'bias': (CE,)}.
      project: folded {'weight': (CO, CE, 1, 1), 'bias': (CO,)}, CO <= 128.
      stride: 1 or 2. act: 'relu', 'relu6' or 'hswish'.

    Returns (B, CO, ceil(H / stride), ceil(W / stride)). A CUDA tensor goes
    to the kernel `csrc/fused_block.cu` (and counts one in
    `fused_inverted_residual.launches`); a CPU tensor to
    `fused_inverted_residual_plain`.
    """
    if x.ndim != 4:
        raise ValueError(f"fused_inverted_residual: x {tuple(x.shape)} is "
                         "not (B, CI, H, W)")
    b, ci, h, w = x.shape
    ce = depthwise["weight"].shape[0]
    co = project["weight"].shape[0]
    want = {"depthwise": (ce, 1, 3, 3), "project": (co, ce, 1, 1)}
    if expand is not None:
        want["expand"] = (ce, ci, 1, 1)
    elif ce != ci:
        raise ValueError(f"fused_inverted_residual: no expand conv, but the "
                         f"depthwise conv has {ce} channels and x {ci}")
    given = {"expand": expand, "depthwise": depthwise, "project": project}
    for name, shape in want.items():
        wt, bias = given[name]["weight"], given[name]["bias"]
        if tuple(wt.shape) != shape or tuple(bias.shape) != shape[:1]:
            raise ValueError(f"fused_inverted_residual: {name} weight "
                             f"{tuple(wt.shape)} and bias {tuple(bias.shape)} "
                             f"do not fit {shape}")
    if stride not in (1, 2) or act not in _ACTS:
        raise ValueError(f"fused_inverted_residual: stride {stride} and act "
                         f"{act!r} not in (1, 2) and {sorted(_ACTS)}")
    tensors = [x] + [t for p in given.values() if p is not None
                     for t in (p["weight"], p["bias"])]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_inverted_residual takes float32 tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_inverted_residual: x and the weights are on "
                         "different devices")
    if x.device.type == "cpu":
        return fused_inverted_residual_plain(x, expand, depthwise, project,
                                             stride, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_inverted_residual: no kernel for {x.device}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if co > 128 or wo > 512:
        raise ValueError(f"fused_inverted_residual: CO={co} > 128 or output "
                         f"width {wo} > 512")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_inverted_residual: x and the weights must be "
                         "contiguous")
    out = torch.empty((b, co, ho, wo), dtype=x.dtype, device=x.device)
    # no expand conv: null pointers, and the kernel reads x directly
    we, be = ((expand["weight"].data_ptr(), expand["bias"].data_ptr())
              if expand is not None else (None, None))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            x.data_ptr(), we, be,
            depthwise["weight"].data_ptr(), depthwise["bias"].data_ptr(),
            project["weight"].data_ptr(), project["bias"].data_ptr(),
            out.data_ptr(), b, ci, ce, co, h, w, stride, _ACTS[act],
            int(stride == 1 and ci == co), stream)
    _build.check(code, "fused_inverted_residual")
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0
