#!/usr/bin/env python
"""Analytic per-layer roofline report of the PyTorch port: how fast COULD
this model go on an H100. The twin of tools/roofline_report.py.

Walks every leaf module of the port's model and prints, per layer and in
total, the least time the card's two hard limits allow:

  tc_ms   = flops / peak_flops        (tensor-core limit)
  hbm_ms  = bytes / peak_bandwidth    (HBM limit)
  min_ms  = max(tc_ms, hbm_ms)        (roofline floor for that layer)

Two byte models bracket reality:
  * unfused: every leaf reads its inputs and parameters and writes its
    outputs from and to HBM (more traffic than the real program moves);
  * fused floor: every activation written once and read once in the
    whole network, the input read once, parameters read once.
`--mode train` holds the bytes to 3x (read activation and gradient,
write gradient: the standard heuristic).

Flops come from torch.utils.flop_counter.FlopCounterMode over one
forward (and, with `--mode train`, the backward of the heads' sum) on the
`meta` device, per leaf module. FlopCounterMode counts matrix products
and convolutions only (the JAX tool's per-module summary counts every
XLA op), so the tensor-core limit is the limit of the products alone,
which is where it belongs. The backward of a grouped convolution is
counted with its groups (each of the input's and the weight's gradient
costs one forward's products), which FlopCounterMode's own formula
leaves out.

Peaks: the H100 SXM's data sheet, 989 TFLOP/s dense bf16 on the tensor
cores and 3.35 TB/s of HBM3. An fp32 program is held to the same
tensor-core peak, so the dtype headroom shows: TF32 runs at 495 TFLOP/s,
and the port runs its fp32 convolutions with TF32 off.

CPU-safe (the model is built on the meta device; no card is touched):
    python tools/roofline_report_torch.py \
        --model ssdlite320_mobilenet_v3_large --batch 128 --dtype bf16 \
        --mode train --measured MS
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

# repo root importability when run as `python tools/roofline_report_torch.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# H100 SXM data sheet: dense bf16 tensor-core peak; fp32 programs are held
# to the same peak so the dtype headroom shows (TF32: 495 TFLOP/s)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 989e12}
PEAK_BW = 3.35e12
DTYPE_BYTES = {"bf16": 2, "fp32": 4}


def _numel(obj) -> int:
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel()
    if isinstance(obj, dict):
        return sum(_numel(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_numel(v) for v in obj)
    return 0


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kwargs):
    """Each of the input's and the weight's gradient: one forward's
    products, 2 * N * Co * Ho * Wo * (Ci / groups) * kh * kw (the weight's
    shape carries Ci / groups)."""
    spatial = (x_shape if transposed else grad_out_shape)[2:]
    fwd = 2 * grad_out_shape[0] * math.prod(w_shape) * math.prod(spatial)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def leaf_records(model_name, num_classes, batch, dtype, mode):
    """(records, input bytes, flops counted in all): one record per leaf
    module, {'path', 'type', 'flops', 'in_bytes', 'out_bytes',
    'param_bytes'} at the dtype's width.

    A leaf's flops are FlopCounterMode's count of its forward; in train
    mode its backward adds one forward's products for the weight's
    gradient and one for the input's, where the input needs one (the
    counter's attribution of backward ops to modules does not hold). The
    flops counted in all, over the forward and the backward, are
    FlopCounterMode's total, which the leaves' sum must equal."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from demonet_tpu_torch.models.builders import get_model

    det = get_model(model_name, num_classes=num_classes, device="meta",
                    dtype=torch.bfloat16 if dtype == "bf16"
                    else torch.float32)
    model = det.model.train(mode == "train")
    h, w = det.config.size
    x = torch.zeros((batch, h, w, 3), device="meta")
    bpe = DTYPE_BYTES[dtype]
    leaves = {name: m for name, m in model.named_modules()
              if name and not any(True for _ in m.children())}
    seen = {}

    def hook(name):
        def record(mod, args, out):
            got = seen.setdefault(name, [0, 0, False])
            got[0] += _numel(args)
            got[1] += _numel(out)
            got[2] |= any(getattr(a, "requires_grad", False) for a in args)
        return record

    def counter():
        return FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward_flops})

    handles = [m.register_forward_hook(hook(n)) for n, m in leaves.items()]
    forward = counter()
    try:
        with forward:
            out = model(x)
    finally:
        for hd in handles:
            hd.remove()
    counted = float(forward.get_total_flops())
    if mode == "train":
        backward = counter()
        with backward:
            sum(v.float().sum() for v in out.values()).backward()
        counted += float(backward.get_total_flops())
    counts = forward.get_flop_counts()
    root = type(model).__name__
    records = []
    for name, m in leaves.items():
        n_in, n_out, input_grad = seen.get(name, (0, 0, False))
        flops = float(sum(counts.get(f"{root}.{name}", {}).values()))
        if mode == "train":
            flops *= 2 + input_grad
        records.append({
            "path": name, "type": type(m).__name__, "flops": flops,
            "in_bytes": n_in * bpe, "out_bytes": n_out * bpe,
            "param_bytes": sum(p.numel() for p in m.parameters(
                recurse=False)) * bpe})
    return records, x.numel() * bpe, counted


def roofline(records, input_bytes, dtype, mode, measured=None):
    """Per-layer floors and the totals: the tensor-core limit, the HBM
    limits (unfused, fused floor) and speed of light, the larger of the
    tensor-core limit and the fused HBM limit."""
    peak_f = PEAK_FLOPS[dtype]
    scale = 3 if mode == "train" else 1
    layers = []
    for r in records:
        nbytes = (r["in_bytes"] + r["out_bytes"] + r["param_bytes"]) * scale
        tc_ms = r["flops"] / peak_f * 1e3
        hbm_ms = nbytes / PEAK_BW * 1e3
        layers.append({**r, "bytes": nbytes, "tc_ms": tc_ms,
                       "hbm_ms": hbm_ms, "min_ms": max(tc_ms, hbm_ms)})
    flops = sum(r["flops"] for r in records)
    unfused = sum(r["bytes"] for r in layers)
    fused = (2 * sum(r["out_bytes"] for r in records) + input_bytes
             + sum(r["param_bytes"] for r in records)) * scale
    tc_ms = flops / peak_f * 1e3
    hbm_fused_ms = fused / PEAK_BW * 1e3
    floor = max(tc_ms, hbm_fused_ms)
    out = {"flops": flops, "unfused_bytes": unfused, "fused_bytes": fused,
           "tensor_core_ms": tc_ms, "hbm_unfused_ms": unfused / PEAK_BW * 1e3,
           "hbm_fused_ms": hbm_fused_ms,
           "per_layer_floor_sum_ms": sum(r["min_ms"] for r in layers),
           "speed_of_light_ms": floor,
           "bound_by": "operations" if tc_ms >= hbm_fused_ms else "bytes",
           "peak_flops": peak_f, "peak_bytes_per_s": PEAK_BW}
    if measured:
        out.update(measured_ms=measured, measured_over_floor=measured / floor,
                   share_of_speed_of_light=floor / measured)
    layers.sort(key=lambda r: -r["min_ms"])
    return layers, out


def main(args) -> dict:
    records, input_bytes, counted = leaf_records(
        args.model, args.num_classes, args.batch, args.dtype, args.mode)
    layers, tot = roofline(records, input_bytes, args.dtype, args.mode,
                           args.measured)
    print(f"model={args.model} batch={args.batch} dtype={args.dtype} "
          f"mode={args.mode}  ({len(layers)} leaf modules; H100 SXM peaks "
          f"{PEAK_FLOPS[args.dtype] / 1e12:.0f} TFLOP/s, "
          f"{PEAK_BW / 1e12:.2f} TB/s)")
    print(f"{'layer':58s} {'type':10s} {'GFLOP':>8s} {'MB':>8s} "
          f"{'tc_ms':>8s} {'hbm_ms':>8s} {'min_ms':>8s}")
    for r in layers[:args.top]:
        print(f"{r['path'][:58]:58s} {r['type'][:10]:10s} "
              f"{r['flops'] / 1e9:8.2f} {r['bytes'] / 1e6:8.1f} "
              f"{r['tc_ms']:8.4f} {r['hbm_ms']:8.4f} {r['min_ms']:8.4f}")
    print("-" * 112)
    print(f"totals: {tot['flops'] / 1e9:.1f} GFLOP (leaves; "
          f"{counted / 1e9:.1f} counted in all)  unfused "
          f"{tot['unfused_bytes'] / 1e6:.0f} MB / fused-floor "
          f"{tot['fused_bytes'] / 1e6:.0f} MB")
    print(f"tensor-core limit {tot['tensor_core_ms']:.4f} ms | HBM-limit "
          f"unfused {tot['hbm_unfused_ms']:.4f} ms, fused-floor "
          f"{tot['hbm_fused_ms']:.4f} ms | per-layer roofline sum "
          f"{tot['per_layer_floor_sum_ms']:.4f} ms")
    print(f"speed-of-light floor (max of tensor-core, fused HBM): "
          f"{tot['speed_of_light_ms']:.4f} ms")
    if args.measured:
        print(f"measured {args.measured:.2f} ms = "
              f"{tot['measured_over_floor']:.2f}x floor "
              f"({100 * tot['share_of_speed_of_light']:.1f}% of "
              "speed-of-light)")
    out = {"model": args.model, "batch": args.batch, "dtype": args.dtype,
           "mode": args.mode, "leaves": len(layers),
           "flops_counted": counted, **tot}
    print(json.dumps(out), flush=True)
    return out


def get_args_parser():
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Peaks: H100 SXM, 989 TFLOP/s dense bf16 (fp32 programs held "
               "to the same peak so the dtype headroom shows; TF32 is 495 "
               "TFLOP/s, and the port runs its fp32 convolutions with TF32 "
               "off) and 3.35 TB/s HBM3. FlopCounterMode counts matrix "
               "products and convolutions only (the JAX tool's per-module "
               "summary counts every XLA op): the tensor-core limit is that "
               "of the products alone.")
    p.add_argument("--model", default="ssdlite320_mobilenet_v3_large")
    p.add_argument("--num-classes", type=int, default=91)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    p.add_argument("--mode", choices=("infer", "train"), default="infer")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--measured", type=float, default=None,
                   help="a measured step in ms to compare with the floor")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
    sys.exit(0)
