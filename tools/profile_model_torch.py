"""Capture a device profile of the PyTorch port's inference or training
step: the twin of tools/profile_model.py, on demonet_tpu_torch.

The step is called once outside the trace, then `--iters` calls run under
torch.profiler (CPU and CUDA activities, shapes and flops recorded) and
the card is synchronized. The trace is written as
`<logdir>/<model>_<mode>.pt.trace.json.gz` (Chrome trace format, for
Perfetto or chrome://tracing) and its path printed; the profiler's flop
count of each `aten::` op is put on that op's event as `flops` where the
profiler left it out. tools/trace_op_stats_torch.py summarizes it.

    python tools/profile_model_torch.py --mode predict --batch-size 64 \
        --logdir runs/trace
    python tools/trace_op_stats_torch.py runs/trace --iters 5

The trained serving configuration (trained weights, real val frames):

    python tools/profile_model_torch.py --mode predict --batch-size 128 \
        --impl fused --npz-weights bench_assets/ssdlite320_shapes_trained.npz \
        --frames bench_assets/val_images_320.npz --logdir runs/serve
    python tools/profile_model_torch.py --mode train --batch-size 32 \
        --bf16 --logdir runs/train --device cpu   # on the CPU

On the GPU by default; without one and without `--device cpu` it raises.
The last line printed is one JSON object: the trace's path, the step, the
launches of each hand-written kernel over the traced calls (the
wrappers' own counts), and under `spans` the program's own spans over
those calls (`demonet_tpu_torch/utils/spans.py`'s `summary()`: each
span's calls and its host, device and self device ms a call).
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import sys

import numpy as np

# repo root importability when run as `python tools/profile_model_torch.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_bench_images(path, batch):
    """npz of JPEG bytes -> (batch, H, W, 3) float32 in [0, 1], the frames
    repeated up to `batch`. The port's own copy of
    tools/export_bench_images.py's loader."""
    from PIL import Image

    with np.load(path, allow_pickle=False) as z:
        blobs = [z[k] for k in sorted(z.files)]
    imgs = []
    for blob in blobs:
        img = Image.open(io.BytesIO(blob.tobytes())).convert("RGB")
        imgs.append(np.asarray(img, np.float32) / 255.0)
    arr = np.stack(imgs)
    reps = -(-batch // len(arr))
    return np.tile(arr, (reps, 1, 1, 1))[:batch]


def frame_size(path):
    """(H, W) of the first frame of a frames npz, from its JPEG header."""
    from PIL import Image

    with np.load(path, allow_pickle=False) as z:
        blob = z[sorted(z.files)[0]]
    w, h = Image.open(io.BytesIO(blob.tobytes())).size
    return h, w


def kernel_counters():
    """The hand-written kernels' wrappers, each counting its launches."""
    from demonet_tpu_torch.ops.fused_block import fused_inverted_residual
    from demonet_tpu_torch.ops.gather import gather_rows_batch
    from demonet_tpu_torch.ops.nms import nms_keep_batch
    from demonet_tpu_torch.ops.topk import topk_sparse

    return {"nms_keep_batch": nms_keep_batch,
            "gather_rows_batch": gather_rows_batch,
            "topk_sparse": topk_sparse,
            "fused_inverted_residual": fused_inverted_residual}


def build_step(args):
    """(device, run): `run()` makes one call of the step the flags ask for
    and returns what it returns."""
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_lr_schedule,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step
    from demonet_tpu_torch.models.builders import get_model, resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model_kw = {"lane_pack": True} if args.lane_pack else {}
    det = get_model(args.model, num_classes=args.num_classes, device=device,
                    dtype=dtype, **model_kw)
    h, w = det.config.size
    if args.frames:
        fh, fw = frame_size(args.frames)
        if (fh, fw) != (h, w):
            raise ValueError(
                f"--frames {args.frames} holds {fh}x{fw} frames and "
                f"{args.model} takes {h}x{w} ones; the tool resizes nothing")
    if args.npz_weights:
        from demonet_tpu_torch.utils.checkpoints import load_npz_variables
        from demonet_tpu_torch.utils.weights import load_jax_variables

        load_jax_variables(det.model, load_npz_variables(args.npz_weights))
    b = args.batch_size
    if args.frames:
        images = load_bench_images(args.frames, b)
    else:
        images = np.random.RandomState(0).rand(b, h, w, 3).astype(np.float32)

    if args.mode == "predict":
        step = make_predict_step(det, impl=args.impl)
        images = torch.from_numpy(images).to(device)
        return device, lambda: step(det.model, images, None)

    tx = make_optimizer(make_lr_schedule(0.02, 100))
    state = create_train_state(det, tx)
    tstep = make_train_step(det)
    batch = {
        "images": images,
        "gt_boxes": np.tile(np.float32([[[20, 20, 120, 120]]]), (b, 1, 1)),
        "gt_labels": np.ones((b, 1), np.int64),
        "gt_valid": np.ones((b, 1), bool),
    }
    if not args.host_batch:
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def run():
        _, m = tstep(state, batch)
        return m

    return device, run


def op_flops(prof):
    """{(name, External id): flops} of the traced ops that carry a flop
    count, from the profiler's Kineto events (whose correlation id is the
    trace's External id of a host op)."""
    return {(e.name(), e.correlation_id()): int(e.flops())
            for e in prof.profiler.kineto_results.events() if e.flops()}


def write_trace(prof, path):
    """The Chrome trace of `prof` as `path` (gzip), each host op's flop
    count on its event as `flops` where the profiler left it out; returns
    the number of events that carry flops."""
    flops = op_flops(prof)
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        data = json.load(f)
    os.remove(raw)
    n = 0
    for e in data["traceEvents"]:
        if e.get("cat") != "cpu_op":
            continue
        a = e.setdefault("args", {})
        got = flops.get((e.get("name"), a.get("External id")))
        if got and not a.get("flops"):
            a["flops"] = got
        n += bool(a.get("flops"))
    text = json.dumps(data, separators=(",", ":"))   # one write: fast
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(text.encode())
    return n


def trace_step(run, device, args):
    """Call `run` once, trace `args.iters` calls and write the trace; returns
    {'trace', 'model', 'mode', ..., 'events_with_flops', 'launches',
    'spans'}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from demonet_tpu_torch.utils import spans

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    run()   # the kernels' builds and cuDNN's choices outside the trace
    sync()
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    spans.reset()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=True,
                 with_flops=True) as prof:
        for _ in range(args.iters):
            run()
        sync()
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    span_ms = spans.summary()

    os.makedirs(args.logdir, exist_ok=True)
    path = os.path.join(args.logdir,
                        f"{args.model}_{args.mode}.pt.trace.json.gz")
    n_flops = write_trace(prof, path)
    return {"trace": path, "model": args.model, "mode": args.mode,
            "batch_size": args.batch_size, "bf16": args.bf16,
            "impl": args.impl, "host_batch": args.host_batch,
            "device": str(device), "iters": args.iters,
            "events_with_flops": n_flops, "launches": launches,
            "spans": span_ms}


def main(args):
    """Trace the step; returns trace_step's dict, also printed as the
    last line."""
    device, run = build_step(args)
    out = trace_step(run, device, args)
    print(f"trace written to {out['trace']}")
    print(json.dumps(out), flush=True)
    return out


def get_args_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="ssdlite320_mobilenet_v3_large")
    p.add_argument("--num-classes", type=int, default=91)
    p.add_argument("--mode", choices=["predict", "train"], default="predict")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--lane-pack", dest="lane_pack", action="store_true",
                   help="build the model in the lane-packed layout "
                        "(get_model(..., lane_pack=True))")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--logdir", default="runs/demonet_trace")
    p.add_argument("--impl", default="reference",
                   choices=["reference", "fused"],
                   help="postprocess impl for --mode predict")
    p.add_argument("--npz-weights", default="",
                   help="trained-weights npz (the bench-asset layout) "
                        "instead of the seeded init")
    p.add_argument("--frames", default="",
                   help="frames npz (tools/export_bench_images.py) instead "
                        "of random input")
    p.add_argument("--host-batch", dest="host_batch", action="store_true",
                   help="--mode train: hand the step its batch as numpy "
                        "arrays in host memory, as the train CLI's loader "
                        "does (the step copies it to the device)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises with no GPU) or 'cpu'")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
    sys.exit(0)
