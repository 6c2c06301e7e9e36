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

Layout: the logical shape is NCHW, (B, CI, H, W) in and (B, CO, H / stride,
W / stride) out, as the port's trunk takes it. On the card x must be
channels_last in memory (the trunk's own layout there, and the JAX
kernel's NHWC order), and the output is channels_last too; an input in
another memory format raises. On the CPU any layout goes.

Eligible blocks, as in the JAX package: a 3x3 depthwise conv, no
squeeze-excite, relu, relu6 or hard-swish: MobileNetV3-Large blocks 0-2
and every MobileNetV2 block. Like the JAX kernel, it is not wired into the
model (`models/mobilenetv3.py` runs the unfused modules).

The kernel's tiling is chosen here, by `tile_plan`, so that the CPU tests
reach it: an output tile of th x tw pixels per block, expanded channels in
chunks of `ec`. Limits of the kernel, each a ValueError on the card: CO <=
640 (the project's sums of one tile stay in registers), B <= 65,535 (the
grid's second dimension), and an input tile with its halo that fits the
227 KB of shared memory a block may use (CI up to about 1,000).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

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
# shared memory one block may use on the H100, and the most each of two
# blocks on one SM may use (the SM's 228 KB less 1 KB reserved per block)
_SMEM_BYTES = 232_448
_SMEM_TWO_BLOCKS = 115_712
_MAX_CO = 640
_MAX_BATCH = 65_535
_CHUNKS = (32, 24, 16, 8)


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


class Plan(NamedTuple):
    """How the kernel cuts one call: output tiles of th x tw pixels, one
    block each, and the expanded channels in chunks of ec (8, 16, 24 or
    32)."""
    th: int
    tw: int
    ec: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan_layout(ci: int, ce: int, co: int, stride: int, has_expand: bool,
                plan: Plan) -> Dict[str, int]:
    """The sizes csrc/fused_block.cu derives from a plan (the same
    formulas as its make_params; chip_smoke.py checks that both give the
    same shared memory): the input tile with its halo (ih x iw pixels, padded to
    mp_in rows of 16), the chunks, the output tile's 16-row m-tiles, the
    project's split of CO's 8-wide n-tiles over the block's 8 warps (wpm
    warps per m-tile, npw n-tiles each) and the shared memory in bytes
    (input tile, expanded chunk, depthwise output, two weight buffers and
    each tile pixel's source offset)."""
    ih, iw = (plan.th - 1) * stride + 3, (plan.tw - 1) * stride + 3
    mp_in = _ceil(ih * iw, 16) * 16
    n_chunks = _ceil(ce, plan.ec)
    ci8, co8 = _ceil(ci, 8) * 8, _ceil(co, 8) * 8
    kx = ci8 if has_expand else n_chunks * plan.ec
    mt_out = _ceil(plan.th * plan.tw, 16)
    es = plan.ec + 4
    wsz = co8 * es + 10 * plan.ec + (
        plan.ec * (ci8 + 4) + plan.ec if has_expand else 0)
    wpm = max(1, 8 // mt_out)
    npw = _ceil(co8 // 8, wpm)
    floats = (mp_in * (kx + 4) + (mp_in * es if has_expand else 0)
              + mt_out * 16 * es + 2 * wsz + mp_in)
    return {"ih": ih, "iw": iw, "mp_in": mp_in, "n_chunks": n_chunks,
            "kx": kx, "mt_out": mt_out, "wpm": wpm, "npw": npw,
            "smem_bytes": 4 * floats}


@functools.lru_cache(maxsize=None)
def tile_plan(ci: int, ce: int, co: int, h: int, w: int, stride: int,
              has_expand: bool, min_tiles: int = 1) -> Plan:
    """The kernel's plan for a call: the widest output tile (up to 16
    columns; 128 pixels for CO <= 160, 64 for CO <= 320, 32 above, so that
    the project's sums fit in registers) whose shared memory lets two
    blocks share an SM, else one; chunks of ec channels with the least
    padding of CE, and fewer chunks on a tie.

    min_tiles is the tiles per image that give each SM a block (the
    wrapper passes SMs // B). Where that plan cuts an image into fewer (a
    small image), or holds less than half the widest tile's pixels (its
    halo then costs more than a second block on the SM gains: MobileNetV2's
    160 -> 960 -> 320 block on a 10 x 10 image), the plan is the one with
    the least work per SM: rounds of min_tiles tiles times the rows a tile
    computes (input and output m-tiles), the squarest tile on a tie."""
    n_nt = _ceil(co, 8)
    if n_nt * 8 > _MAX_CO:
        raise ValueError(f"fused_inverted_residual: CO={co} > {_MAX_CO}: the "
                         "project's sums of a tile must fit in registers")
    p_max = 128 if n_nt <= 20 else 64 if n_nt <= 40 else 32
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    chunks = sorted(_CHUNKS, key=lambda ec: (_ceil(ce, ec) * (ec + 8), -ec))

    def balanced(n: int, most: int) -> int:
        return _ceil(n, _ceil(n, most))

    # chunks of 8 only where nothing wider fits: 3 barriers a chunk
    wide = [ec for ec in chunks if ec >= min(16, _ceil(ce, 8) * 8)]
    tw0 = balanced(wo, 16)
    th0 = balanced(ho, min(ho, max(1, p_max // tw0)))
    tries = [(tw0, th, _SMEM_TWO_BLOCKS, wide)
             for th in range(th0, max(1, th0 // 2) - 1, -1)]
    for ecs in (wide, chunks):
        tw = tw0
        while True:
            top = min(ho, max(1, p_max // tw))
            tries += [(tw, th, _SMEM_BYTES, ecs) for th in range(top, 0, -1)]
            if tw == 1:
                break
            tw = balanced(wo, tw // 2)
    fits = []
    for tw, th, limit, ecs in tries:
        th = balanced(ho, th)
        for ec in ecs:
            plan = Plan(th, tw, ec)
            lay = plan_layout(ci, ce, co, stride, has_expand, plan)
            if lay["smem_bytes"] <= limit:
                if not fits and _ceil(ho, th) * _ceil(wo, tw) >= min_tiles \
                        and 2 * th * tw >= th0 * tw0:
                    return plan
                fits.append((plan, lay))
                break
    if fits:
        def work(fit):
            plan, lay = fit
            tiles = _ceil(ho, plan.th) * _ceil(wo, plan.tw)
            return (_ceil(tiles, min_tiles) * (lay["mp_in"]
                                               + 16 * lay["mt_out"]),
                    abs(plan.th - plan.tw))
        return min(fits, key=work)[0]
    raise ValueError(f"fused_inverted_residual: CI={ci}: no input tile fits "
                     f"the {_SMEM_BYTES} bytes of shared memory a block may "
                     "use")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("fused_block").fused_inverted_residual
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_inverted_residual(x: torch.Tensor, expand: Optional[Folded],
                            depthwise: Folded, project: Folded,
                            stride: int = 1,
                            act: str = "relu") -> torch.Tensor:
    """Inference forward of one inverted-residual block, fused.

    Args:
      x: (B, CI, H, W) float32; on the card, channels_last in memory.
      expand: folded {'weight': (CE, CI, 1, 1), 'bias': (CE,)}, or None
        when the block has no expand conv (CE == CI).
      depthwise: folded {'weight': (CE, 1, 3, 3), 'bias': (CE,)}.
      project: folded {'weight': (CO, CE, 1, 1), 'bias': (CO,)}.
      stride: 1 or 2. act: 'relu', 'relu6' or 'hswish'.

    Returns (B, CO, ceil(H / stride), ceil(W / stride)). A CUDA tensor goes
    to the kernel `csrc/fused_block.cu` (and counts one in
    `fused_inverted_residual.launches`), its output channels_last; a CPU
    tensor to `fused_inverted_residual_plain`.
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
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_inverted_residual: x must be channels_last in "
                         "memory on the card; pass "
                         "x.contiguous(memory_format=torch.channels_last)")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("fused_inverted_residual: the weights must be "
                         "contiguous")
    if b > _MAX_BATCH:
        raise ValueError(f"fused_inverted_residual: B={b} > {_MAX_BATCH}, the "
                         "grid's second dimension")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = tile_plan(ci, ce, co, h, w, stride, expand is not None,
                     sms // b)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((b, co, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
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
            plan.th, plan.tw, plan.ec, stream)
    _build.check(code, "fused_inverted_residual")
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0
