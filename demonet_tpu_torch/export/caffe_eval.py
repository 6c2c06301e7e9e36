"""An evaluator for the CaffeNet IR (counterpart of
demonet_tpu/export/caffe_eval.py): it runs an exported graph with PyTorch
tensor ops (NCHW) on a device, so an export is checked numerically
against the model's forward, not only decoded.

Caffe itself is not a dependency, so this implements the Caffe semantics
of the layer types the exporter emits: Convolution (group, dilation),
BatchNorm (use_global_stats, with its scale-factor blob) + Scale, ReLU,
ReLU6, Power, Pooling (MAX/AVE, ceil/floor round modes, global),
InnerProduct, Eltwise (SUM/PROD), two-bottom Scale, Concat, Softmax,
Flatten, Permute, Reshape and the SSD fork's Normalize. The order of
operations is the JAX evaluator's. On a CUDA device TF32 is off for the
convolutions and products (`no_tf32`): cuDNN allows it by default.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from demonet_tpu_torch.export.caffe import CaffeNet, Layer
from demonet_tpu_torch.models.builders import resolve_device


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block,
    restored after."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def pool_size(dim: int, kernel: int, stride: int, pad: int,
              ceil: bool) -> int:
    """Caffe's pooled size along one axis (pooling_layer.cpp): the ceil or
    floor round mode, then a window that would start in the padding
    dropped."""
    num = dim + 2 * pad - kernel
    o = (-(-num // stride) if ceil else num // stride) + 1
    if pad > 0 and (o - 1) * stride >= dim + pad:
        o -= 1
    return o


def ave_counts(h: int, w: int, kernel: int, stride: int, pad: int,
               ceil: bool) -> np.ndarray:
    """The divisor of each output of a Caffe AVE pool, (oh, ow): the
    window clipped to the padded bounds (zeros in the padding count, the
    area beyond it does not)."""
    def along(dim):
        start = np.arange(pool_size(dim, kernel, stride, pad, ceil)) * stride
        return np.minimum(start + kernel, dim + 2 * pad) - start
    return np.outer(along(h), along(w))


def _pool(x: torch.Tensor, p: Dict) -> torch.Tensor:
    is_max = p.get("pool", 0) == 0
    if p.get("global_pooling"):
        return (x.amax(dim=(2, 3), keepdim=True) if is_max
                else x.mean(dim=(2, 3), keepdim=True))
    k, s = p["kernel_size"], p.get("stride", 1)
    pad = p.get("pad", 0)
    ceil = p.get("round_mode", 0) == 0
    h, w = x.shape[2:]
    oh, ow = pool_size(h, k, s, pad, ceil), pool_size(w, k, s, pad, ceil)
    # pad (or crop) each axis to the span the windows cover; a window's
    # part beyond the padded bounds is filled with what does not count
    # (-inf for MAX, zeros for AVE, whose divisor leaves it out)
    span_h, span_w = (oh - 1) * s + k, (ow - 1) * s + k
    fill = float("-inf") if is_max else 0.0
    xp = F.pad(x, (pad, span_w - w - pad, pad, span_h - h - pad),
               value=fill)
    windows = xp.unfold(2, k, s).unfold(3, k, s)   # (n, c, oh, ow, k, k)
    if is_max:
        return windows.amax(dim=(4, 5))
    counts = torch.from_numpy(ave_counts(h, w, k, s, pad, ceil)).to(
        device=x.device, dtype=x.dtype)
    return windows.sum(dim=(4, 5)) / counts


def on_device(net: CaffeNet, device) -> CaffeNet:
    """A copy of the net whose blobs are float32 tensors on `device`, so
    that repeated runs there copy no weights."""
    out = CaffeNet(net.name)
    out.output_tops = list(net.output_tops)
    out.layers = [dataclasses.replace(layer, blobs=[
        torch.as_tensor(b, dtype=torch.float32, device=device)
        for b in layer.blobs]) for layer in net.layers]
    return out


def run_caffenet(net: CaffeNet, inputs: Dict[str, object], stop_at: str = "",
                 device: Optional[object] = None
                 ) -> Dict[str, torch.Tensor]:
    """Execute the IR on `device` (`cuda` unless the caller names another;
    with no GPU that raises); returns every blob by top name (NCHW
    activations). `inputs` maps input tops to arrays or tensors."""
    device = resolve_device(device)

    def blob(layer: Layer, i: int) -> torch.Tensor:
        return torch.as_tensor(layer.blobs[i], dtype=torch.float32,
                               device=device)

    blobs: Dict[str, torch.Tensor] = {
        k: torch.as_tensor(v, dtype=torch.float32, device=device)
        for k, v in inputs.items()}
    with no_tf32():
        for layer in net.layers:
            _run_layer(layer, blobs, blob)
            if stop_at and stop_at in layer.tops:
                break
    return blobs


def _run_layer(layer: Layer, blobs: Dict[str, torch.Tensor], blob) -> None:
    t, p, tops = layer.type, layer.params, layer.tops
    x = blobs[layer.bottoms[0]] if layer.bottoms else None
    if t == "Input":
        if tops[0] not in blobs:
            raise KeyError(f"missing input blob {tops[0]!r}")
        return
    if t == "Convolution":
        out = F.conv2d(x, blob(layer, 0),
                       blob(layer, 1) if p.get("bias_term") else None,
                       stride=p.get("stride", 1), padding=p.get("pad", 0),
                       dilation=p.get("dilation", 1), groups=p.get("group", 1))
    elif t == "BatchNorm":
        mean, var, factor = (blob(layer, i) for i in range(3))
        factor = factor[0]    # read on the device: no host sync
        scale = torch.where(factor != 0, 1.0 / factor,
                            torch.zeros_like(factor))
        m = (mean * scale).reshape(1, -1, 1, 1)
        v = (var * scale).reshape(1, -1, 1, 1)
        out = (x - m) / torch.sqrt(v + p.get("eps", 1e-5))
    elif t == "Scale":
        if len(layer.bottoms) == 2:  # two-bottom (SENet) form
            s = blobs[layer.bottoms[1]]
            axis = p.get("axis", 1)
            shape = list(s.shape) + [1] * (x.dim() - axis - s.dim())
            out = x * s.reshape(shape)
        else:
            view = (1, -1) + (1,) * (x.dim() - 2)
            out = x * blob(layer, 0).reshape(view)
            if p.get("bias_term") and len(layer.blobs) > 1:
                out = out + blob(layer, 1).reshape(view)
    elif t == "ReLU":
        out = x.clamp(min=0.0)
    elif t == "ReLU6":
        out = x.clamp(min=0.0).clamp(max=6.0)
    elif t == "Power":
        y = p.get("shift", 0.0) + p.get("scale", 1.0) * x
        power = p.get("power", 1.0)
        out = y if power == 1.0 else torch.pow(y, power)
    elif t == "Pooling":
        out = _pool(x, p)
    elif t == "InnerProduct":
        out = x.reshape(x.shape[0], -1) @ blob(layer, 0).T
        if p.get("bias_term") and len(layer.blobs) > 1:
            out = out + blob(layer, 1)
    elif t == "Eltwise":
        b = blobs[layer.bottoms[1]]
        out = x + b if p.get("operation", 1) == 1 else x * b
    elif t == "Concat":
        out = torch.cat([blobs[b] for b in layer.bottoms],
                        dim=p.get("axis", 1))
    elif t == "Softmax":
        axis = p.get("axis", 1)
        e = torch.exp(x - x.amax(dim=axis, keepdim=True))
        out = e / e.sum(dim=axis, keepdim=True)
    elif t == "Flatten":
        out = x.reshape(tuple(x.shape[:p.get("axis", 1)]) + (-1,))
    elif t == "Permute":
        out = x.permute(*p["order"])
    elif t == "Reshape":
        out = x.reshape([x.shape[i] if d == 0 else d
                         for i, d in enumerate(p["shape"])])
    elif t == "Normalize":
        s = blob(layer, 0).reshape(1, -1, 1, 1)
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-10
        out = x / norm * s
    else:
        raise NotImplementedError(f"layer type {t}")
    blobs[tops[0]] = out
