#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

The main paths are flagship inference and flagship training of
ssdlite320_mobilenet_v3_large (91 classes, 320x320, fp32 and, since the
bf16 phases, bf16 compute), from the
trained weights of bench_assets/ssdlite320_shapes_trained.npz loaded by
`load_jax_variables`: predict through `make_predict_step` in each of its
serving modes (the reference postprocess, the fused serving postprocess
(impl="fused") and the chunk-skipping top-k (topk_impl="sparse_pallas")),
and the train step and epoch loop (`make_train_step`, `train_one_epoch`,
checkpoints); and the same predict modes and train step of the four
other detector families (ssd300_vgg16, ssd512_vgg16,
ssd_lite_mobilenet_v2, pelee304) at full width and their own sizes, from
seeded random weights. Beside them runs the fused inverted-residual
kernel over blocks 0-2 of the trained trunk, which the model does not
wire in. The training path reaches none of the kernels, as in the JAX
package. The script prints one JSON line per phase:

  device       card, power limit, torch/CUDA versions; TF32 turned off;
               `probe`: whether cv2 and PIL import, and their versions
  build        nvcc of csrc/*.cu, one process per source, all started
               together, and ptxas's report
  kernel_*     each hand-written kernel against its plain PyTorch version
               on the main paths' inputs and shapes at B = 32, and edge
               cases: NMS over P = 32 * 90 problems of K = 300 and over
               P = 32 class-offset problems of K = 1,024 and 2,048 (trained
               and random weights, and random weights' best candidates with
               none invalid), each in the launch shape the wrapper
               picks by K (the reference shape in the tiled launch too,
               called past the wrapper), edge cases at their own K and
               padded to K = 576, and chains and IoU-at-threshold pairs
               across the mask's 64-bit word boundaries at K = 63 ...
               1,024 (block launch up to 512, tiled above); row
               gathers 3,234 -> 27,000 and 27,000 -> 300 rows, and
               3,234 -> R and R -> 300 rows; the sparse top-k over
               P = 32 * 90 rows of A = 3,234 (trained, random weights,
               synthetic, and dense edge rows: ties at the k-th value,
               k - 1, k and k + 1 live entries, one exponent bin), with
               the rows of each kernel branch; `kernel_topk_long`: the
               top-k's long-row launch on P = 32 * 90 rows of A = 8,732
               and 24,732 (empty, within and over the slots, dense, ties
               at the k-th value, k - 1 / k / k + 1 live, one exponent
               bin, live scores in the 28-score tail), its launches
               counted and the plain version never run on a CUDA tensor;
               the fused block on blocks
               0-2 of the trained trunk, fed its channels_last
               activations as they are, and on MobileNetV3-Small's and
               MobileNetV2's blocks (random weights, b32, CO up to 320,
               the block without an expand conv); an NCHW input must
               raise. Bit-equal (the fused block: within its tolerance)
               or fail
  main_path_*  4 requests of 32 images per mode; launch counts reset just
               before and read just after, or fail; the fused path's
               branch per batch; each mode's detections against the
               reference postprocess on the same head outputs
  reference    the card's head outputs against the CPU's on 2 images, and
               the postprocess through the kernels against the plain
               versions on the same head outputs, bit-equal
  e2e          predict img/s at b32 and b128 for each postprocess mode,
               with a forward/postprocess split, and the cost of the fused
               path's host read
  trace_b128   where the device time of a b128 predict goes, per mode
  families     one line per other detector family (family_detectors:
               seeded random weights; the BN families' statistics
               calibrated and class head scaled so scores cross 0.5):
               its three predict modes, 2 requests of 32 each, counts
               reset before and read after (K1, K2, K3 in its register or
               long-row launch: the VGG rows, A = 8,732 and 24,732, take
               the long one), each mode bit-equal to the reference
               postprocess on the same head outputs; head outputs on the
               card against the CPU (B = 2, 1e-3, before the class head
               is scaled); K3 (k = 400), K1 (K = 400) and K2 on the
               model's own rows against their plain versions, bit-equal,
               and timed (the final gather of K2 also at 3x the
               iterations, with the L2 warm and flushed before each
               call); closed-loop img/s at b32 and b128 with the
               forward/postprocess split (and the forward with cuDNN's
               benchmark mode, beside the default heuristics; VGG's
               atrous fc6 conv timed alone), a trace of the reference
               mode at each batch; one train
               step (ssd512 at b8, the others at b32: ms, peak memory, a
               finite loss; card against CPU loss terms at B = 2 for
               ssd300, the MobileNetV2 and the Pelee model)
  train_check  two train steps from the trained weights on 4 frames with
               their rectangles as gt, on the card and on the CPU: loss
               terms, every parameter and BN statistic after step 2, the
               matching and the hard-negative masks of each step
  train_e2e    closed-loop train steps at b32 and b128: ms per step, img/s,
               peak memory, forward/loss/backward/optimizer by CUDA events,
               steps_per_call = 4 against single steps; every timed step
               with synchronising CUDA calls made errors
  trace_train_b128  where the device time of a b128 train step goes
  train_loop   train_one_epoch over 8 batches of 32; checkpoint save and
               load, the resumed state's next step bit-equal to the
               continued one's; predict after training bit-equal to a
               fresh model in eval mode
  cli_synthetic  the train CLI (`demonet_tpu_torch.train.main`) in
               process: one epoch of 64 synthetic frames at b32 from the
               trained npz with a checkpoint, then --test-only --resume
               (equal COCO summaries), --postprocess fused and -j 2 (equal
               summary; the loader's -j 2 batches bit-equal to -j 0's),
               with cv2 and PIL unimportable; then --model ssd300_vgg16
               (seeded random weights, frames resized to 300x300 by cv2):
               an epoch and its evaluation; K1 and K2 launches counted
               over each evaluation (reset before, read after, > 0 or
               fail); epoch and eval img/s; the step's pageable copy
  entry_points the entry points a user reaches first: the trained
               npz as a reference .pth through `hub.load` (detections
               bit-equal to the npz model's on the 4 batches); the predict
               CLI on 8 JPEG frames in both --postprocess modes (K1 and
               K2 per image, the modes' detections equal); the public
               nms_mask, nms and batched_nms on CUDA tensors at N =
               1,000, 8,192 and one flagship image's 3,234 boxes (K1 once
               a call, bit-equal to their plain twin on the card and, up
               to N = 4,096, on the CPU; K1 alone timed beside its plain
               version and bound); eval_voc on 64 JPEG frames with a
               random ssd_lite_mobilenet_v2 .pth, the card's APs within
               1e-3 of the CPU's; --pretrained from an empty and then a
               warm weights cache (the --npz-weights summary); the native
               JPEG loader against the Python loader, where g++ and
               <jpeglib.h> are there; the CLIs' printing goes to
               chiprun_out/entry_points.log. K1's long launch (N above
               8,192) at N = 8,193, 16,384 and 20,000, bit-equal to the
               plain version on a CPU copy, timed, with its scratch
               bytes; the public calls at 20,000, K1 once each, against
               the plain keep (nms_mask, nms) and the CPU's batched_nms
  bf16_serving the flagship with bf16 compute from the trained npz: the
               head outputs and a trunk conv's input and output bf16 (no
               quiet float32); 4 requests of 32 per mode with the float32
               paths' launch counts; each mode's detections equal to the
               reference postprocess's on the same bf16 heads; K1, K2, K3
               bit-equal to their plain versions on the bf16 path's
               (float32, cast) inputs; heads against the CPU's bf16 model
               and the card's float32 one, in bf16 ulps of their scale;
               forward ms in both dtypes, postprocess ms and img/s per
               mode at b32 and b128; a trace of a bf16 b128 batch
  bf16_train   the flagship's bf16 step at b32 and b128 (ms, peak memory,
               split, a b128 trace); loss terms at B = 4 on the card and
               the CPU; remat at b128: ms and peak memory with and
               without, and 2 steps with it bit-equal to 2 without under
               cuDNN's deterministic algorithms, the BN statistics moved
  bf16_families  the four other detectors in bf16 (family_detectors'
               weights): one counted request of 32 per mode, detections
               equal to the reference postprocess's; forward ms in both
               dtypes and img/s per mode at b32 and b128; VGG's top
               kernels in a bf16 forward; one bf16 train step each
  bf16_cli     the train CLI with --bf16: an epoch of 64 synthetic frames
               with a checkpoint, --test-only --resume with --bf16 (the
               same summary) and without it
  distributed  the data-parallel mesh (parallel/, make_train_step(mesh=),
               evaluate(mesh=)): world size 1 over NCCL in this process
               (two mesh steps at b32 bit-equal to two plain steps; the
               mesh predict step bit-equal in the reference and sparse
               top-k modes, K1/K2/K3 counted); two spawned ranks on the
               one card, over NCCL where a probe pair finds that it takes
               two ranks on one device, else over gloo with CUDA tensors
               (16 rows each of the b32 batch: loss terms and state after
               2 steps against the single-process steps, the ranks bit-
               equal; a sharded evaluation of 64 synthetic frames, every
               image merged once, AP against the single-process one, K1,
               K2, K3 counted per rank); the train CLI under
               `torch.distributed.run --nproc_per_node 1` (NCCL), an epoch
               and --test-only --resume to the same summary; ms per step
               at world 1 and 2 (16 rows a rank), the gradient bucket's
               all-reduce ms and bytes; the ranks' and the CLI's printing
               go to chiprun_out/distributed*.log
  export       the torch.export artifacts (demonet_tpu_torch/export/),
               each exported, saved, loaded back and run: the trained
               flagship in the reference and fused modes at b1 and b32 on
               the e2e frames (4 requests), detections bit-equal to the
               eager predict step, K1 and K2 launched inside the program
               1 and 2 times a batch and K3 never, the fused program's
               branch per batch (the K of its NMS launch); export s,
               artifact MB, ms per batch of the artifact beside the eager
               step, in turns; the random-weight flagship's fused program
               (the fallback); the raw heads at b1; the four other
               detectors in the reference mode at b1; bf16 at b32
  caffe        the Caffe export (demonet_tpu_torch/export/caffe.py,
               caffe_eval.py, tracing.py): the five hand-built families
               at full width and size (the trained flagship, the others
               seeded random weights with drawn BN statistics), each
               exported from the card's module and byte-equal to the
               export of a CPU copy, its graph run by run_caffenet on the
               card against the forward there (2e-4 / 2e-5, the softmaxed
               mbox_conf_softmax and the flat mbox_loc); every name of the
               registry through trace_to_caffe, against the forward at the
               CLI's --verify tolerances (5e-3 / 1e-4); the export CLI's
               --format caffe --generic --verify on the card; export and
               trace s, MB, the evaluator's ms, max abs errors; no kernel
               launched
  cpp_runner   the detector run from C++ with no Python
               (demonet_tpu_torch/export/aoti.py, csrc/aoti_runner.cc,
               csrc/aoti_ops.cc): the runner and the ops library that
               registers K1 and K2 from C++ built with g++ against the
               wheel's libtorch (the ops library linked to K1's and K2's
               nvcc libraries); the trained flagship packaged by
               AOTInductor at b1 in the reference and fused modes; the
               runner on each over the first e2e frame, 50 timed calls,
               its dumped outputs bit-equal to the Python call of the same
               package, its own counts of K1 (and its launch shape) and K2
               launched in every call, the detections against the eager
               step and against the same postprocess with K1 and K2 in
               their plain versions (bit-equal or within scores 1e-5,
               boxes 1e-3 px); every child exited before the timings;
               p50/best/mean ms of the runner, the Python package call,
               the export phase's b1 program and the eager step; and
               dump_hlo(stage="optimized") on the card naming a Triton
               kernel
  launch_floor the device time of a one-float fill, the shortest kernel

then `previous_design` (K1's, K3's and K4's times before their
redesign: constants, not measured in this run), the `kernels` line (time,
bound, plain and library time of each kernel, all from this run; K4 timed
with the L2 flushed before each call; and launch_floor_ms), the card line
from nvidia-smi, and
the last line {"ok": true, "device": {...}}. Any failed check raises, and
the exit code is not 0. Without a CUDA device it exits with 2 before
printing anything.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

_T0 = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))
_NPZ = os.path.join(_HERE, "bench_assets", "ssdlite320_shapes_trained.npz")
_LOG = os.path.join(_HERE, "chiprun_out", "chip_smoke.jsonl")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
_HBM_BYTES_PER_S = 3.35e12
_FP32_OPS_PER_S = 67e12
_TF32_OPS_PER_S = 495e12
# f32 operations per IoU test in csrc/nms.cu: 2 min, 2 max, 2 sub, 2 clamp,
# mul, add, sub, max, div, compare
_OPS_PER_IOU = 14
# the sparse top-k's arguments on the main path (detection.py)
_TOPK_K, _TOPK_SLOTS = 300, 8
# K3's long-row launch: the anchor counts of ssd300_vgg16 and ssd512_vgg16
_TOPK_LONG_A = (8732, 24732)
# K1's, K3's and K4's times before their redesign (ms, torch.profiler
# device time, b32: NMS with one block per problem and a barrier per kept
# candidate, top-k sorting each dense row whole, the fused block with one
# expanded channel at a time in NCHW, on a warm L2), measured by earlier
# versions of this script on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md §6). Constants: printed on their own line, never in the
# `kernels` line
_PREVIOUS_MS = {"nms_trained": 0.0358, "nms_random": 0.1473,
           "nms_fused_K1024": 0.2791, "nms_fused_K2048": 0.3464,
           "topk_trained": 0.1293, "topk_random": 0.6857,
           "fused_block_0": 0.2989, "fused_block_1": 0.8593,
           "fused_block_2": 0.4004}
# the fused block against its plain version: |kernel - plain| <= atol +
# rtol * |plain|. Both sum the same fp32 products in another order (the
# kernel's tensor-core sums, cuDNN with TF32 off in the plain version),
# over at most 960 terms per sum, and the kernel's split of each product
# into TF32 terms drops a_lo * b_lo (about 2^-22 of it); with O(1)
# activations 1e-4 leaves a wide margin over both.
_BLOCK_ATOL = _BLOCK_RTOL = 1e-4
# the L2 flush before each timed K4 call: zeroing 128 MB, over 2x the L2
_FLUSH_BYTES = 128 << 20
# cycles the card sleeps before a timed loop, so that the host queues the
# whole loop first and host time never shows as gaps (~0.1 s)
_QUEUE_SLEEP_CYCLES = 200_000_000


def emit(obj):
    """One JSON line to stdout, and to chiprun_out/chip_smoke.jsonl, whole
    (a long output may be cut to its end where it is read back), with the
    seconds since the script started as `t_s` (on stdout too, but for the
    last line, which stays exactly the contract's)."""
    line = dict(obj, t_s=time.perf_counter() - _T0)
    last = set(obj) == {"ok", "device"}
    print(json.dumps(obj if last else line), flush=True)
    os.makedirs(os.path.dirname(_LOG), exist_ok=True)
    with open(_LOG, "a") as fh:
        fh.write(json.dumps(line) + "\n")


def cuda_ms(fn, iters, warmup=2):
    """Mean time of fn() in ms, by CUDA events around `iters` calls: the
    device time, or the host's issue time where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e):
    return getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0)


def device_ms(fn, iters, flush=None):
    """Device time of one call of fn() in ms, from a torch.profiler trace
    of `iters` calls (each after flush(), if given) queued behind a sleep
    on the card: the kernels of the sleep (and of the flush, a fill) left
    out by name, each other kernel's mean time times its launches per
    call, so that a trace that drops an event still reads right. None if
    the trace holds no kernel of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    untimed = ("spin_kernel",) + (("FillFunctor",) if flush else ())
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(_QUEUE_SLEEP_CYCLES)
        for _ in range(iters):
            if flush:
                flush()
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if _dev_us(e) and not any(n in e.key for n in untimed)]
    if not kernels:
        return None
    return sum(_dev_us(e) / e.count * max(1, round(e.count / iters))
               for e in kernels) / 1e3


def timed(fn, iters, warmup=2, traces=3):
    """{'ms': device time (event time if none of `traces` profiler traces
    held a kernel of fn), 'event_ms': CUDA-event time}. The profiler on
    the card's machine drops a short kernel from a trace now and then,
    and the event time of a kernel shorter than a call's host time is the
    host's issue rate (a K2 gather of 0.0014 ms on the device has read
    0.0377 ms so), so a trace is taken again before the events stand
    in."""
    ev = cuda_ms(fn, iters, warmup)
    dev = None
    for _ in range(traces):
        dev = device_ms(fn, iters)
        if dev is not None:
            break
    return {"ms": dev if dev is not None else ev, "event_ms": ev,
            "ms_from": "profiler" if dev is not None else "events"}


def trace_calls(fn, n=3):
    """Where the device time of fn() goes: n closed-loop calls under
    torch.profiler, {'wall_ms', 'device_busy_ms', 'device_idle_share',
    'top_kernels_ms'} per call (the ten kernels with the most device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    per_kernel = sorted((_dev_us(e) / n / 1e3, e.key[:60])
                        for e in prof.key_averages())[::-1]
    busy_ms = sum(t for t, _ in per_kernel)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
            else None,
            "top_kernels_ms": [[k, t] for t, k in per_kernel[:10]]}


def shapes_images(rng, b, size=320, max_gt=8):
    """Noise backgrounds with 1-4 filled rectangles: the kind of frame the
    trained 'shapes' weights detect things in, and the rectangles as
    ground truth. Returns (images (b, size, size, 3) uint8, {'gt_boxes':
    (b, max_gt, 4) xyxy float32, 'gt_labels': (b, max_gt) int32, 1-6 by
    the fill colour as in bench_assets/val_gt_320.npz, 'gt_valid': (b,
    max_gt) bool}), padded to max_gt. The labels take no draw of their
    own, so the images are those of earlier versions of this script."""
    import numpy as np

    imgs = rng.integers(0, 60, (b, size, size, 3)).astype(np.uint8)
    gt = {"gt_boxes": np.zeros((b, max_gt, 4), np.float32),
          "gt_labels": np.zeros((b, max_gt), np.int32),
          "gt_valid": np.zeros((b, max_gt), bool)}
    for i, img in enumerate(imgs):
        for j in range(int(rng.integers(1, 5))):
            bw, bh = rng.integers(size // 8, size // 2, 2)
            x0, y0 = rng.integers(0, size - bw), rng.integers(0, size - bh)
            colour = rng.integers(40, 256, 3)
            img[y0:y0 + bh, x0:x0 + bw] = colour
            gt["gt_boxes"][i, j] = [x0, y0, x0 + bw, y0 + bh]
            gt["gt_labels"][i, j] = 1 + int(colour.sum()) % 6
            gt["gt_valid"][i, j] = True
    return imgs, gt


def head_to_candidates(det, outputs):
    """The main path's postprocess up to the NMS: scores, boxes, the
    per-(image, class) candidates with the gather indices that made them,
    and the foreground score rows the top-k takes."""
    import torch

    from demonet_tpu_torch.models import detection

    cfg = det.config
    anchors = torch.as_tensor(det.anchors, device=det.device)
    scores, boxes = detection._scores_and_boxes(
        outputs["cls_logits"], outputs["bbox_regression"], anchors, cfg)
    b, a, c = scores.shape
    k = min(cfg.topk_candidates, a)
    fg = scores[..., 1:].transpose(1, 2).contiguous()
    _, top_idx = detection._sorted_topk(fg, k)
    cand_boxes, cand_sc = detection._select_candidates(
        scores, boxes, cfg, "exact", "auto")
    return {
        "scores": scores, "fg": fg,
        "boxes": boxes, "top_idx": top_idx.reshape(b, -1).to(torch.int32),
        "cand_boxes": cand_boxes.reshape(b * (c - 1), k, 4).contiguous(),
        "cand_sc": cand_sc.reshape(b * (c - 1), k).contiguous(),
    }


def fused_shapes(det, cand, r):
    """The fused path's kernel inputs at capacity r: the class-offset NMS
    problem per image, the candidate gather (3,234 -> r rows: the r best
    live entries' anchors) and the final gather (r -> 300 rows)."""
    import torch

    from demonet_tpu_torch.models import detection

    scores, all_boxes = cand["scores"], cand["boxes"]
    b, a, _ = scores.shape
    off, nms_sc, boxes, _ = detection._fused_candidates(
        scores, all_boxes, det.config,
        detection._fused_sizes(scores.shape, det.config), r, "auto")
    order = torch.sort(cand["fg"].reshape(b, -1), dim=1, descending=True,
                       stable=True)[1][:, :r]
    cand_idx = (order % a).to(torch.int32).contiguous()
    final_idx = detection._sorted_topk(nms_sc, 300)[1].to(
        torch.int32).contiguous()
    return {"nms": (off.contiguous(), nms_sc.contiguous()),
            "candidate": (all_boxes.contiguous(), cand_idx),
            "final": (boxes.contiguous(), final_idx)}


def dense_fused_problem(cand, r, offset):
    """A fused-path NMS problem with every candidate valid: each image's r
    best (class, anchor) scores, uncapped, sorted, their boxes shifted by
    class * offset as detection.py's class-offset boxes are."""
    import torch

    scores, all_boxes = cand["scores"], cand["boxes"]
    b, a, _ = scores.shape
    fg = scores[..., 1:].transpose(1, 2).reshape(b, -1)
    sc, flat = torch.sort(fg, dim=1, descending=True, stable=True)
    sc, flat = sc[:, :r].contiguous(), flat[:, :r]
    boxes = torch.gather(all_boxes, 1, (flat % a)[..., None].expand(-1, -1, 4))
    boxes = boxes + ((flat // a) * offset).to(boxes.dtype)[..., None]
    return boxes.contiguous(), sc


def nms_work(keep, scores, thr):
    """Bytes and IoU tests the greedy NMS needs on these inputs: every
    score read, the boxes of valid candidates read, the mask written; a
    kept candidate tested against every earlier kept one, a suppressed
    valid one at least once."""
    valid = scores > thr
    n_valid = int(valid.sum())
    kept = keep.sum(dim=1).double()
    pairs = float((kept * (kept - 1) / 2).sum()) + (n_valid - float(kept.sum()))
    nbytes = scores.numel() * 4 + n_valid * 16 + keep.numel()
    ops = pairs * _OPS_PER_IOU + n_valid * 3  # + the area of each valid box
    return nbytes, ops


def gather_bytes(table, idx, out_numel):
    """Distinct rows read (16 B each), indices read, output written."""
    import torch

    b, n, _ = table.shape
    flat = idx.long() + n * torch.arange(b, device=idx.device)[:, None]
    rows = int(torch.unique(flat).numel())
    return rows * 16 + idx.numel() * 4 + out_numel * 4


def gather_row(table, idx, iters=200):
    """K2 on (table, idx) timed against its plain version and
    torch.gather, with its byte bound: a row of the `kernels` line."""
    import torch

    from demonet_tpu_torch.ops.gather import (
        gather_rows_batch,
        gather_rows_batch_plain,
    )

    idx64 = idx.long()[..., None].expand(-1, -1, 4)
    nbytes = gather_bytes(table, idx, idx.numel() * 4)
    k_t = timed(lambda: gather_rows_batch(table, idx), iters)
    p_t = timed(lambda: gather_rows_batch_plain(table, idx), iters)
    l_t = timed(lambda: torch.gather(table, 1, idx64), iters)
    return {"table": list(table.shape), "idx": list(idx.shape),
            "ms": k_t["ms"], "plain_ms": p_t["ms"],
            "library_ms": l_t["ms"], "bound_ms": bound(nbytes, 0)[0],
            "bound_by": "bytes", "bytes": nbytes,
            "event_ms": k_t["event_ms"], "ms_from": k_t["ms_from"]}


def topk_work(rows, k, thresh):
    """Bytes and operations the sparse top-k needs on these rows: every
    score read and compared with thresh once, (score, index) written for
    each output slot, and a comparison sort of each row's live entries
    (L log2 L comparisons for L live)."""
    import torch

    live = (rows > thresh).sum(dim=-1).double()
    sort_ops = float((live * torch.log2(live.clamp(min=1.0))).sum())
    nbytes = rows.numel() * 4 + rows.numel() // rows.shape[-1] * k * 8
    return nbytes, rows.numel() + sort_ops


def block_work(x, folded, out):
    """Bytes and operations of one fused block: x read, out written and
    the folded weights read once; the 1x1 products (2 per multiply-add of
    the expand and project convs), and the rest in fp32: 2 per multiply-add
    of the depthwise conv, 1 per bias add, activation and residual add
    (hard-swish counted as 1, as its cheapest form is not the point)."""
    b, ci, h, w = x.shape
    _, co, ho, wo = out.shape
    ce = folded["depthwise"]["weight"].shape[0]
    weights = sum(t.numel() for name in ("expand", "depthwise", "project")
                  if folded[name] is not None
                  for t in folded[name].values())
    nbytes = (x.numel() + out.numel() + weights) * 4
    products = b * ho * wo * co * 2 * ce
    rest = b * ho * wo * ce * (2 * 9 + 2) + b * ho * wo * co * 2
    if folded["expand"] is not None:
        products += b * h * w * ce * 2 * ci
        rest += b * h * w * ce * 2
    return nbytes, products, rest


def bound(nbytes, ops):
    t_bytes = nbytes / _HBM_BYTES_PER_S * 1e3
    t_ops = ops / _FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def block_bound(nbytes, products, rest):
    """K4's bound: the largest of the bytes at the memory rate, the 1x1
    products counted 3 times (the fp32-accurate split into TF32 terms) at
    the dense TF32 rate, and the rest at the fp32 rate; beside it the fp32
    FMA bound of earlier versions (every operation at the fp32 rate)."""
    t_bytes = nbytes / _HBM_BYTES_PER_S * 1e3
    t_ops = max(3 * products / _TF32_OPS_PER_S, rest / _FP32_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_fma_ms": bound(nbytes, products + rest)[0],
            "bytes": nbytes, "products": products, "rest_ops": rest}


def gather_retimed(table, idx, iters=150):
    """K2 timed again on (table, idx), at 3x gather_row's 50 iterations
    in the families phase: with the L2 as the loop leaves it, and with it
    flushed before each call (cold_timed), to tell a slow timer from a
    slow kernel."""
    import torch

    from demonet_tpu_torch.ops.gather import gather_rows_batch

    flush = torch.empty(_FLUSH_BYTES // 4, device=table.device)
    warm = timed(lambda: gather_rows_batch(table, idx), iters)
    cold = cold_timed(lambda: gather_rows_batch(table, idx), iters,
                      flush.zero_)
    return {"iters": iters, "warm": warm, "l2_flushed": cold}


def cold_timed(fn, iters, flush):
    """{'ms': device time of fn() with the L2 flushed before each call
    (device_ms, the flush left out by name), 'event_ms': CUDA events
    around fn() alone, the loop queued behind a sleep on the card so host
    time does not count}. Where the trace holds none of fn's kernels, or
    reads more than 10 % off the events (it has read one of two identical
    calls at half their time), 'ms' is the event time."""
    import torch

    dev = device_ms(fn, iters, flush)
    marks = []
    torch.cuda._sleep(_QUEUE_SLEEP_CYCLES)
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    ev = sum(s.elapsed_time(e) for s, e in marks) / iters
    use_dev = dev is not None and abs(dev - ev) <= 0.1 * ev
    return {"ms": dev if use_dev else ev, "event_ms": ev, "profiler_ms": dev,
            "ms_from": "profiler" if use_dev else "events",
            "l2": "flushed before each call"}


def ptxas_usage(log):
    """Registers and spill bytes per kernel instance from ptxas -v, keyed
    by the template arguments of fused_block_kernel<npw, min_blocks,
    expand>."""
    import re

    usage, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", m.group(1))
            entry = (f"<{t.group(1)},{t.group(2)},{t.group(3)}>" if t
                     else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if entry and m:
            usage.setdefault(entry, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if entry and m:
            usage.setdefault(entry, {})["registers"] = int(m.group(1))
    return usage


def contract_blocks():
    """Eligible blocks beyond the trained trunk's 0-2, at a 320x320 image:
    (name, CI, CE, CO, H, W, stride, act). MobileNetV3-Small's 16 -> 72 ->
    24 (stride 2) and 24 -> 88 -> 24 (relu), and MobileNetV2's 17 blocks
    (relu6; demonet_tpu/models/mobilenetv2.py's table), the first without
    an expand conv."""
    blocks = [("v3s_1", 16, 72, 24, 80, 80, 2, "relu"),
              ("v3s_2", 24, 88, 24, 40, 40, 1, "relu")]
    c, hw = 32, 160
    for t, oc, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                        (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                        (6, 320, 1, 1)):
        for r in range(n):
            st = s if r == 0 else 1
            blocks.append((f"v2_{len(blocks) - 1}", c, c * t, oc, hw, hw, st,
                           "relu6"))
            hw, c = (hw - 1) // st + 1, oc
    return blocks


def random_block(ci, ce, co, stride, act, dev, seed):
    """The port's unfused block with seeded random weights: convs at
    He-like scale (1/sqrt(fan_in)) and BN statistics near the identity, so
    that the folded weights keep that scale and outputs stay O(1); BN eps
    1e-5 as in MobileNetV2. Eval mode, channels_last, on dev."""
    import torch

    from demonet_tpu_torch.models.layers import (
        InvertedResidualV3,
        hard_swish,
        relu6,
    )

    blk = InvertedResidualV3(ci, ce, co, 3, stride)
    fn = {"relu": torch.relu, "relu6": relu6, "hswish": hard_swish}[act]
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in (blk.expand_conv, blk.depthwise, blk.project):
            if layer is None:
                continue
            wt = layer.conv.weight
            fan_in = wt.shape[1] * wt.shape[2] * wt.shape[3]
            wt.copy_(torch.randn(wt.shape, generator=gen) / fan_in ** 0.5)
            n = wt.shape[0]
            layer.bn.eps = 1e-5
            layer.bn.weight.copy_(0.5 + torch.rand(n, generator=gen))
            layer.bn.bias.copy_(0.1 * torch.randn(n, generator=gen))
            layer.bn.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            layer.bn.running_var.copy_(0.5 + torch.rand(n, generator=gen))
            if layer.act is not None:
                layer.act = fn
    return blk.eval().to(dev).to(memory_format=torch.channels_last)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


# the largest |kernel - plain| seen by each bit-equality check, by key
# (a kernel's name, or name/shape), for the `kernels` line
_MAX_ERR = {}


def record_err(keys, got, want):
    """Keeps the largest |got - want| over the entries (0 where they are
    equal, infinities included) under each key; returns it."""
    import torch

    g, w = got.to(torch.float64), want.to(torch.float64)
    diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    for key in keys:
        _MAX_ERR[key] = max(_MAX_ERR.get(key, 0.0), err)
    return err


def synthetic_topk_rows(p, a, thresh, live_chunks, levels=None, seed=0,
                        device="cpu"):
    """(p, a) scores below thresh except in live_chunks[r] chunks of row r
    (chosen at random), each holding 1-6 live entries; with `levels`, live
    values are drawn from those few values, so keys tie across chunks.
    Drawn on `device`."""
    import torch

    with torch.device(device):
        return _synthetic_topk_rows(p, a, thresh, live_chunks.to(device),
                                    levels, torch.Generator(
                                        device).manual_seed(seed))


def _synthetic_topk_rows(p, a, thresh, live_chunks, levels, gen):
    import torch

    n_chunks = -(-a // 128)
    x = torch.rand((p, a), generator=gen) * (thresh * 0.9)
    rank = torch.argsort(torch.rand((p, n_chunks), generator=gen), dim=1)
    chunk_live = rank < live_chunks[:, None]                  # (p, n_chunks)
    col = torch.arange(a)
    in_live = chunk_live[:, col // 128]                        # (p, a)
    hot = in_live & (torch.rand((p, a), generator=gen) < 4.0 / 128)
    # one sure entry per live chunk, at a random lane inside the row
    width = torch.clamp(a - torch.arange(n_chunks) * 128, max=128)
    lane = (torch.rand((p, n_chunks), generator=gen) * width).long()
    sure = (torch.arange(n_chunks) * 128 + lane).clamp(max=a - 1)
    rows_i, chunks_i = torch.nonzero(chunk_live, as_tuple=True)
    hot[rows_i, sure[rows_i, chunks_i]] = True
    if levels is None:
        vals = thresh * 2 + torch.rand((p, a), generator=gen) * 0.9
    else:
        lv = torch.tensor(levels, dtype=torch.float32)
        vals = lv[torch.randint(0, len(levels), (p, a), generator=gen)]
    return torch.where(hot, vals, x)


def live_chunk_counts(rows, thresh):
    import torch
    import torch.nn.functional as F

    p, a = rows.shape
    n_chunks = -(-a // 128)
    live = F.pad(rows > thresh, (0, n_chunks * 128 - a))
    return live.reshape(p, n_chunks, 128).any(dim=2).sum(dim=1)


def topk_branches(rows, thresh, k, slots):
    """Rows per branch of csrc/topk.cu: empty (no live chunk), compact (at
    most `slots` live chunks), select (more); of the select rows, those
    with at most k live entries skip the radix passes."""
    chunks = live_chunk_counts(rows, thresh)
    live = (rows > thresh).sum(dim=1)
    sel = chunks > slots
    return {"rows": rows.shape[0], "rows_empty": int((chunks == 0).sum()),
            "rows_compact": int(((chunks > 0) & ~sel).sum()),
            "rows_select": int(sel.sum()),
            "rows_select_radix": int((sel & (live > k)).sum()),
            "live_chunks_max": int(chunks.max()),
            "live_entries_max": int(live.max())}


def spread_topk_rows(p, a, thresh, k, case, seed, device="cpu"):
    """Edge rows for the select branch, every row's live entries spread
    over all chunks: `tie_at_kth` (40 entries above one value held by
    600), `live_k_minus_1`/`live_k`/`live_k_plus_1` (that many live),
    `one_exponent_bin` (every score in [0.5, 0.5 + 2**-8)). Drawn on
    `device`."""
    import torch

    with torch.device(device):
        return _spread_topk_rows(p, a, thresh, k, case,
                                 torch.Generator(device).manual_seed(seed))


def _spread_topk_rows(p, a, thresh, k, case, gen):
    import torch

    x = torch.rand((p, a), generator=gen) * (thresh * 0.9)
    n_chunks = -(-a // 128)
    if case == "one_exponent_bin":
        ulps = torch.randint(0, 2**15, (p, a), generator=gen,
                             dtype=torch.int32)
        half = torch.tensor(0.5).view(torch.int32)
        return (half + ulps).view(torch.float32)
    n = {"tie_at_kth": 640, "live_k_minus_1": k - 1, "live_k": k,
         "live_k_plus_1": k + 1}[case]
    # the live columns of each row: one at a random lane of every chunk,
    # in chunk order, then the others in random order
    first = (torch.arange(n_chunks) * 128 + torch.randint(
        0, 128, (p, n_chunks), generator=gen)).clamp(max=a - 1)
    order = torch.rand((p, a), generator=gen) + 1.0
    order.scatter_(1, first, torch.arange(n_chunks).expand(p, -1) / n_chunks)
    cols = torch.argsort(order, dim=1)[:, :n]
    if case == "tie_at_kth":
        vals = torch.full((p, n), 0.5)
        vals[:, :40] = 0.75 + torch.rand((p, 40), generator=gen) * 0.2
    else:
        vals = thresh * 2 + torch.rand((p, n), generator=gen) * 0.9
        vals[:, : n // 4] = vals[:, :1]        # a run of ties
    return x.scatter_(1, cols, vals)


def long_topk_cases(p, a, thresh, k, slots, device="cpu"):
    """Rows of every kind for K3's long-row launch, {name: (p, a) rows
    drawn on `device`}: empty, at most `slots` live chunks, more, a third
    of each of 0 / slots / slots + 1, ties across chunks, fully dense,
    the select branch's edge rows (spread_topk_rows), and live scores in
    the tail past the last full chunk (alone: compact; with live entries
    spread over the row: select)."""
    import torch

    gen = torch.Generator().manual_seed(a)
    n_chunks = -(-a // 128)

    def rows(live_chunks, seed, levels=None):
        return synthetic_topk_rows(p, a, thresh, live_chunks, levels, seed,
                                   device)

    cases = {
        "empty": rows(torch.zeros(p, dtype=torch.long), 1),
        "within_slots": rows(
            torch.randint(1, slots + 1, (p,), generator=gen), 2),
        "over_slots": rows(
            torch.randint(slots + 1, n_chunks + 1, (p,), generator=gen), 3),
        "chunks_0_8_9": rows(
            torch.tensor([0, slots, slots + 1]).repeat(p // 3 + 1)[:p], 4),
        "ties_across_chunks": rows(
            torch.randint(1, 2 * slots, (p,), generator=gen), 5,
            levels=(0.25, 0.5, 0.75)),
    }
    for seed, case in enumerate(("tie_at_kth", "live_k_minus_1", "live_k",
                                 "live_k_plus_1", "one_exponent_bin")):
        cases[case] = spread_topk_rows(p, a, thresh, k, case, 6 + seed,
                                       device)
    dgen = torch.Generator(device).manual_seed(a)
    with torch.device(device):
        cases["dense"] = thresh * 2 + torch.rand((p, a), generator=dgen) * 0.9
        tail = torch.rand((p, a), generator=dgen) * (thresh * 0.9)
        tail0 = a // 128 * 128
        tail[:, tail0:] = thresh * 2 + torch.rand(
            (p, a - tail0), generator=dgen) * 0.9
        tail[p // 2:, ::61] = thresh * 2 + torch.rand(
            (p - p // 2, tail[:, ::61].shape[1]), generator=dgen) * 0.9
    cases["tail_live"] = tail
    return cases


def topk_long(dev, time_it):
    """kernel_topk_long: K3's long-row launch against topk_sparse_plain,
    bit-equal on every entry, over P = 32 * 90 rows of each A in
    _TOPK_LONG_A, on rows of every kind (long_topk_cases); the kernel
    branch each case's rows take; the long-row launches counted, and the
    plain version never run on a CUDA tensor. Returns the timings of
    sparse and dense rows at each A (time_it(rows) -> a row of the
    `kernels` line)."""
    import torch

    from demonet_tpu_torch.ops import topk as topk_mod

    p, st = 32 * 90, 0.001
    plain = topk_mod.topk_sparse_plain
    on_cuda = []

    def watched_plain(scores, *args):
        if scores.is_cuda:
            on_cuda.append(tuple(scores.shape))
        return plain(scores, *args)

    timings = {}
    for a in _TOPK_LONG_A:
        cases = long_topk_cases(p, a, st, _TOPK_K, _TOPK_SLOTS, dev)
        topk_mod.topk_sparse.long_launches = 0
        branches = {}
        for name, rows in cases.items():
            topk_mod.topk_sparse_plain = watched_plain
            try:
                k_sc, k_idx = topk_mod.topk_sparse(rows, _TOPK_K, st,
                                                   _TOPK_SLOTS)
            finally:
                topk_mod.topk_sparse_plain = plain
            p_sc, p_idx = plain(rows, _TOPK_K, st)
            torch.cuda.synchronize()
            record_err(("topk_sparse_long", f"topk_sparse_long/A{a}"), k_sc,
                       p_sc)
            check(torch.equal(k_sc.view(torch.int32), p_sc.view(torch.int32))
                  and torch.equal(k_idx, p_idx),
                  f"top-k long-row launch != plain at A={a} on {name} "
                  f"({int((k_idx != p_idx).sum())} indices differ)")
            branches[name] = topk_branches(rows, st, _TOPK_K, _TOPK_SLOTS)
        launches = topk_mod.topk_sparse.long_launches
        check(launches == len(cases) and not on_cuda,
              f"A={a}: {launches} long-row launches for {len(cases)} cases, "
              f"plain version run on CUDA tensors {on_cuda}")
        half = p - p // 2
        spread = ("tie_at_kth", "live_k_minus_1", "live_k", "live_k_plus_1",
                  "one_exponent_bin")
        check(branches["empty"]["rows_empty"] == p
              and branches["within_slots"]["rows_compact"] == p
              and branches["over_slots"]["rows_select"] == p
              and branches["chunks_0_8_9"]["rows_select"] == p // 3
              and branches["dense"]["rows_select_radix"] == p
              and all(branches[c]["rows_select"] == p for c in spread)
              and all(branches[c]["rows_select_radix"] == (
                  p if c in ("tie_at_kth", "live_k_plus_1",
                             "one_exponent_bin") else 0) for c in spread)
              and branches["tail_live"]["rows_compact"] == p // 2
              and branches["tail_live"]["rows_select"] == half,
              f"A={a}: the cases do not cover every branch: {branches}")
        emit({"phase": "kernel_topk_long", "shape": [p, a], "k": _TOPK_K,
              "slots": _TOPK_SLOTS, "bit_equal": True,
              "max_abs_err": _MAX_ERR[f"topk_sparse_long/A{a}"],
              "long_row_launches": launches,
              "plain_runs_on_cuda_tensors": len(on_cuda),
              "tail_scores": a % 128, "branches": branches})
        timings[f"A{a}"] = {"sparse_within_slots": time_it(
            cases["within_slots"]), "dense": time_it(cases["dense"]),
            "branches": {"sparse_within_slots": branches["within_slots"],
                         "dense": branches["dense"]}}
        del cases
    return timings


def word_boundary_problems(k, seed=11):
    """Three NMS problems of K candidates: random boxes in [0, 100]^2, and
    at each mark m (64, and 512 and 576 where K allows: across 64-bit mask
    word boundaries, in the tiled launch above K = 512) an identical-box
    chain m - 3, m - 2, m and a pair m - 1, m + 1 at IoU 0.5 exactly, each
    mark's boxes apart from the others'. Problem 0 is valid throughout, 1
    and 2 have shorter valid prefixes. Returns boxes, scores and marks."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    centers = torch.rand((3, k, 2), generator=gen) * 100
    wh = torch.rand((3, k, 2), generator=gen) * 40 + 2
    boxes = torch.cat([centers - wh / 2, centers + wh / 2], dim=-1)
    scores = torch.sort(torch.rand((3, k), generator=gen), dim=1,
                        descending=True)[0]
    marks = [min(64, k - 2)] + [m for m in (512, 576) if m + 1 < k]
    for n, m in enumerate(marks):
        d = 100.0 * n
        for c in (m - 3, m - 2, m):
            boxes[:, c] = torch.tensor([1000.0 + d, 1000.0, 1010.0 + d, 1010.0])
        boxes[:, m - 1] = torch.tensor([2000.0 + d, 0.0, 2002.0 + d, 1.0])
        if m + 1 < k:
            boxes[:, m + 1] = torch.tensor([2000.0 + d, 0.0, 2001.0 + d, 1.0])
    scores[1, marks[-1] + 2:] = -1e30
    scores[2, k // 2:] = -1e30
    return boxes, scores, marks


def check_fused_block(name, x, folded, unfused_out=None):
    """K4 against its plain version on x (channels_last), within the
    stated tolerance, and its output channels_last; its plan's shared
    memory the same by the kernel's formulas and by plan_layout's; the
    error summary."""
    import ctypes

    import torch

    from demonet_tpu_torch.ops import _build
    from demonet_tpu_torch.ops.fused_block import (
        fused_inverted_residual,
        fused_inverted_residual_plain,
        plan_layout,
        tile_plan,
    )

    with torch.inference_mode():
        got = fused_inverted_residual(x, **folded)
        want = fused_inverted_residual_plain(x, **folded)
    torch.cuda.synchronize()
    b, ci, h, w = x.shape
    ce, co = folded["depthwise"]["weight"].shape[0], got.shape[1]
    s, has_expand = folded["stride"], folded["expand"] is not None
    plan = tile_plan(ci, ce, co, h, w, s, has_expand, min_tiles(b))
    smem = plan_layout(ci, ce, co, s, has_expand, plan)["smem_bytes"]
    smem_c = _build.load("fused_block").fused_inverted_residual_smem(
        *(ctypes.c_int(v) for v in (ci, ce, co, h, w, s, int(has_expand),
                                    *plan)))
    check(smem_c == smem, f"fused block {name}, plan {plan}: the kernel "
          f"asks for {smem_c} bytes of shared memory, plan_layout {smem}")
    diff = (got - want).abs()
    big = want.abs() >= 1e-2
    err = {"block": name, "x": list(x.shape), "out": list(got.shape),
           "ce": ce, "stride": s, "act": folded["act"], "plan": list(plan),
           "smem_bytes": smem, "max_abs_err": float(diff.max()),
           "max_rel_err_where_abs_ge_1e-2": float(
               (diff[big] / want.abs()[big]).max()) if big.any() else 0.0,
           "max_share_of_tolerance": float(
               (diff / (_BLOCK_ATOL + _BLOCK_RTOL * want.abs())).max()),
           "max_abs_out": float(want.abs().max())}
    if unfused_out is not None:
        err["max_abs_err_vs_unfused_module"] = float(
            (got - unfused_out).abs().max())
    check(bool(torch.isfinite(got).all())
          and bool((diff <= _BLOCK_ATOL + _BLOCK_RTOL * want.abs()).all()),
          f"fused block kernel != plain beyond tolerance: {err}")
    check(got.is_contiguous(memory_format=torch.channels_last),
          f"fused block output on {name} is not channels_last")
    return err


def min_tiles(b):
    """The tiles an image must give for a batch of b to put a block on
    each SM, as the wrapper asks tile_plan for them."""
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count // b



# -- training ---------------------------------------------------------------
# the recipe's SGD (demonet_tpu/engine/state.py): lr 0.02, momentum 0.9,
# weight decay 1e-4
_TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD = 0.02, 0.9, 1e-4
# train_check, card against the CPU port after steps 1-2 from the trained
# weights on B = 4 frames: both run the same fp32 step, summing in another
# order (cuDNN with TF32 off against the CPU's kernels). The BN layers of
# the 1x1 and 2x2 extra maps hold 4-16 values per channel, which makes the
# float32 gradients of the early trunk differ by up to ~2 % between such
# runs (the CPU tests measure 1.7e-2 between the port's float32 and
# float64 steps at B = 2); lr 0.02 turns that into ~1e-4 in the weights.
_TRAIN_LOSS_RTOL = 1e-4
_TRAIN_STATE_ATOL = _TRAIN_STATE_RTOL = 2e-3
_TRAIN_PHASES = ("forward", "loss", "backward", "optimizer")


def train_batch(seed, b, device):
    """A seeded batch of shapes frames (uint8) with their ground truth, as
    the train step takes it, on `device`."""
    import numpy as np
    import torch

    imgs, gt = shapes_images(np.random.default_rng(seed), b)
    batch = {"images": imgs, **gt}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def trained_detector(device, seed=0, dtype=None):
    """ssdlite320_mobilenet_v3_large with the trained npz's weights, in
    the compute dtype asked for (float32 by default)."""
    import numpy as np
    import torch

    from demonet_tpu_torch.models.builders import (
        ssdlite320_mobilenet_v3_large,
    )
    from demonet_tpu_torch.utils.weights import load_jax_variables

    det = ssdlite320_mobilenet_v3_large(num_classes=91, device=device,
                                        seed=seed,
                                        dtype=dtype or torch.float32)
    with np.load(_NPZ) as z:
        load_jax_variables(det.model, {k: z[k] for k in z.files})
    return det


def train_logits(det, images):
    """The class logits a train step's forward gives on these images: a
    train-mode forward without gradients, the BN statistics it moves put
    back as they were."""
    import torch

    from demonet_tpu_torch.models.detection import preprocess

    model = det.model
    saved = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        logits = model.train()(preprocess(images, det.config,
                                          resize=False))["cls_logits"]
        for n, b in model.named_buffers():
            b.copy_(saved[n])
    return logits


def cut_margins(ce, fg, ratio):
    """Per image, the CE gap at the hard-negative cut: the last kept
    negative's CE minus the first dropped one's (inf where nothing is
    cut)."""
    import torch

    neg = torch.where(fg, float("-inf"), ce).double()
    ranked = torch.sort(neg, dim=1, descending=True, stable=True).values
    out = []
    for i in range(ce.shape[0]):
        k = int(ratio * int(fg[i].sum()))
        if k == 0 or k >= ce.shape[1]:
            out.append(float("inf"))
        else:
            out.append(float(ranked[i, k - 1] - ranked[i, k]))
    return out


@contextlib.contextmanager
def sync_errors():
    """Any synchronising CUDA call inside the block raises (set_sync_debug
    _mode('error')): a train step must never wait for the device."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms inside the block, so
    that two runs of the same step can be compared bit for bit."""
    import torch

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def train_check():
    """Steps 1 and 2 from the trained weights on 4 frames, on the card and
    on the CPU: loss terms, every parameter and BN statistic after step 2,
    the matching and the hard-negative masks of each step, and the card's
    mining of the CPU's logits against the CPU's. Emits the comparison,
    then fails on any miss.

    The mask is a cut through ~3,000 negatives per image whose CE crowds
    near 0 under trained weights, so neighbours at the cut lie 1e-5-1e-4
    apart, not far above the two devices' difference in CE. The frames
    (seed 2) are those of 40 seeds whose narrowest gap at the cut is the
    widest on the CPU (7.5e-5 at step 1, 9.4e-5 at step 2); each step's
    gaps are printed."""
    import torch

    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step
    from demonet_tpu_torch.models.losses import (
        classification_terms,
        match_batch,
    )

    runs = {}
    for where in ("cuda", "cpu"):
        det = trained_detector(where)
        cfg = det.config
        b = train_batch(2, 4, det.device)
        anchors = torch.as_tensor(det.anchors, device=det.device)
        matched = match_batch(anchors, b["gt_boxes"], b["gt_valid"],
                              cfg.iou_thresh)
        state = create_train_state(det, make_optimizer(
            _TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD))
        step = make_train_step(det)
        steps = []
        for _ in range(2):
            logits = train_logits(det, b["images"])
            ce, fg, bg = classification_terms(logits, matched,
                                              b["gt_labels"],
                                              cfg.neg_to_pos_ratio)
            state, m = step(state, b)
            steps.append({"metrics": {k: float(v) for k, v in m.items()},
                          "bg": bg.cpu(), "logits": logits.cpu(),
                          "margins": cut_margins(ce.cpu(), fg.cpu(),
                                                 cfg.neg_to_pos_ratio)})
        runs[where] = {"matched": matched.cpu(), "steps": steps,
                       "labels": b["gt_labels"].cpu(),
                       "state": {n: v.detach().cpu() for n, v in
                                 det.model.state_dict().items()
                                 if not n.endswith("num_batches_tracked")}}
    card, cpu = runs["cuda"], runs["cpu"]
    misses = []
    loss_rel = []
    for k, (g, w) in enumerate(zip(card["steps"], cpu["steps"])):
        rel = {key: abs(g["metrics"][key] - w["metrics"][key])
               / abs(w["metrics"][key]) for key in w["metrics"]}
        loss_rel.append(rel)
        if max(rel.values()) > _TRAIN_LOSS_RTOL:
            misses.append(f"step {k + 1} loss terms {rel}")
        if not torch.equal(g["bg"], w["bg"]):
            misses.append(
                f"step {k + 1} hard negatives: "
                f"{int((g['bg'] != w['bg']).sum())} anchors differ; CE "
                f"margin at the cut per image, card {g['margins']}, CPU "
                f"{w['margins']}")
    matched_equal = torch.equal(card["matched"], cpu["matched"])
    if not matched_equal:
        misses.append("matched_idxs differ")
    same_logits = []
    for k, w in enumerate(cpu["steps"]):
        _, _, bg_card = classification_terms(
            w["logits"].cuda(), cpu["matched"].cuda(),
            cpu["labels"].cuda(), cfg.neg_to_pos_ratio)
        same_logits.append(torch.equal(bg_card.cpu(), w["bg"]))
        if not same_logits[-1]:
            misses.append(f"step {k + 1}: the card's mining of the CPU's "
                          "logits differs from the CPU's")
    logit_err = [float((g["logits"] - w["logits"]).abs().max())
                 for g, w in zip(card["steps"], cpu["steps"])]
    worst_abs, worst_share, worst_name = 0.0, 0.0, None
    for name, want in cpu["state"].items():
        diff = (card["state"][name] - want).abs()
        share = float((diff / (_TRAIN_STATE_ATOL + _TRAIN_STATE_RTOL
                               * want.abs())).max())
        worst_abs = max(worst_abs, float(diff.max()))
        if share > worst_share:
            worst_share, worst_name = share, name
    if worst_share > 1.0:
        misses.append(f"{worst_name} after step 2: {worst_share} of the "
                      "tolerance")
    emit({"phase": "train_check", "batch": 4, "weights": "trained npz",
          "lr": _TRAIN_LR, "momentum": _TRAIN_MOMENTUM,
          "weight_decay": _TRAIN_WD,
          "loss_card": [s["metrics"] for s in card["steps"]],
          "loss_cpu": [s["metrics"] for s in cpu["steps"]],
          "loss_rel_err": loss_rel, "loss_rtol": _TRAIN_LOSS_RTOL,
          "matched_idxs_equal": matched_equal,
          "foreground_anchors": int((cpu["matched"] >= 0).sum()),
          "hard_negatives_equal": [torch.equal(g["bg"], w["bg"]) for g, w in
                                   zip(card["steps"], cpu["steps"])],
          "hard_negatives_same_logits_equal": same_logits,
          "logits_max_abs_err": logit_err,
          "ce_gap_at_cut_min": {
              "card": [min(s["margins"]) for s in card["steps"]],
              "cpu": [min(s["margins"]) for s in cpu["steps"]]},
          "state_max_abs_err": worst_abs,
          "state_max_share_of_tolerance": worst_share,
          "state_worst": worst_name,
          "state_tolerance": {"atol": _TRAIN_STATE_ATOL,
                              "rtol": _TRAIN_STATE_RTOL},
          "entries_compared": len(cpu["state"]), "misses": misses})
    check(not misses, f"train_check: {misses}")


def train_e2e(launch_counts):
    """Closed-loop train steps at b32 and b128 from the trained weights:
    ms per step, img/s, peak memory, the split by CUDA events, and
    steps_per_call = 4 against single steps; every timed step under
    sync_errors. Then the b128 trace. The kernels' counts over the timed
    steps come back as launch_counts() reads them."""
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step

    out = {}
    for bs, iters in ((32, 20), (128, 10)):
        det = trained_detector("cuda")
        state = create_train_state(det, make_optimizer(
            _TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD))
        step = make_train_step(det)
        batch = train_batch(1000 + bs, bs, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        counts_before = launch_counts()
        per_step = []
        for _ in range(iters):     # closed loop: one step, then the next
            t0 = time.perf_counter()
            with sync_errors():
                step(state, batch)
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3)
        split = {p: [] for p in _TRAIN_PHASES}
        for _ in range(5):
            marks = {"start": torch.cuda.Event(enable_timing=True)}

            def on_phase(name, marks=marks):
                marks[name] = torch.cuda.Event(enable_timing=True)
                marks[name].record()

            marks["start"].record()
            with sync_errors():
                step(state, batch, on_phase=on_phase)
            torch.cuda.synchronize()
            prev = "start"
            for p in _TRAIN_PHASES:
                split[p].append(marks[prev].elapsed_time(marks[p]))
                prev = p
        multi = make_train_step(det, steps_per_call=4)
        stacked = {k: torch.stack([v] * 4) for k, v in batch.items()}
        per_call = {"single_x4": [], "steps_per_call_4": []}
        for _ in range(3):
            for name in ("single_x4", "steps_per_call_4"):
                t0 = time.perf_counter()
                with sync_errors():
                    if name == "single_x4":
                        for _ in range(4):
                            step(state, batch)
                    else:
                        multi(state, stacked)
                torch.cuda.synchronize()
                per_call[name].append((time.perf_counter() - t0) * 1e3 / 4)
        counts_after = launch_counts()
        q1, med, q3 = np.percentile(per_step, [25, 50, 75])
        out[f"b{bs}"] = {
            "ms_per_step_median": med, "ms_per_step_q1_q3": [q1, q3],
            "n": iters, "img_per_s": bs / med * 1e3,
            "split_ms_median": {p: float(np.median(v))
                                for p, v in split.items()},
            "split_n": 5,
            "ms_per_step_single_vs_steps_per_call_4": {
                k: float(np.median(v)) for k, v in per_call.items()},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "kernel_launches_in_timed_steps": {
                k: counts_after[k] - counts_before[k] for k in counts_after},
            "last_loss": float(step(state, batch)[1]["loss"])}
        check(np.isfinite(out[f"b{bs}"]["last_loss"]),
              f"train_e2e b{bs}: loss is not finite")
    emit({"phase": "train_e2e", "weights": "trained npz",
          "images": "shapes, seeded, with their boxes as gt",
          "sync_debug_mode": "error in every timed step", **out})

    # where the device time of a b128 train step goes
    tr = trace_calls(lambda: step(state, batch))
    emit({"phase": "trace_train_b128", "wall_ms_per_step": tr["wall_ms"],
          "device_busy_ms_per_step": tr["device_busy_ms"],
          "device_idle_share": tr["device_idle_share"],
          "top_kernels_ms": tr["top_kernels_ms"]})
    return out


class _Rows:
    """A metrics writer that keeps the rows."""

    def __init__(self):
        self.rows = []

    def write(self, step, metrics):
        self.rows.append({"step": step, **metrics})


def train_loop():
    """train_one_epoch over 8 batches of 32 (print_freq 4); a checkpoint
    saved and loaded into a fresh state, whose next step must equal the
    next step of the state that went on, bit for bit; then predict on the
    trained model, which the step left in train mode, against a fresh
    model in eval mode with the same weights, bit for bit."""
    import tempfile

    import numpy as np
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_lr_schedule,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import (
        make_train_step,
        train_one_epoch,
    )
    from demonet_tpu_torch.models.builders import (
        ssdlite320_mobilenet_v3_large,
    )
    from demonet_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )

    det = trained_detector("cuda")
    schedule = make_lr_schedule(_TRAIN_LR, steps_per_epoch=8)
    recipe = make_optimizer(schedule, _TRAIN_MOMENTUM, _TRAIN_WD)
    state = create_train_state(det, recipe)
    step = make_train_step(det)
    loader = [train_batch(2000 + i, 32, "cuda") for i in range(8)]
    rows = _Rows()
    t0 = time.perf_counter()
    state = train_one_epoch(step, state, loader, 0, print_freq=4,
                            lr_schedule=schedule, metrics_writer=rows)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = [r["loss"] for r in rows.rows]
    check(state.step == 8 and len(losses) == 8
          and all(np.isfinite(losses)), f"train_one_epoch: {rows.rows}")

    nxt = train_batch(3000, 32, "cuda")
    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        path = save_checkpoint(tmp, state, epoch=0)
        fresh = ssdlite320_mobilenet_v3_large(num_classes=91, seed=1)
        resumed, epoch, _ = load_checkpoint(
            path, create_train_state(fresh, recipe))
        ckpt_mb = os.path.getsize(os.path.join(path, "state.pt")) / 2**20
    check(epoch == 0 and resumed.step == 8, "load_checkpoint")
    with cudnn_deterministic():
        state, m_cont = step(state, nxt)
        resumed, m_res = make_train_step(fresh)(resumed, nxt)
        torch.cuda.synchronize()
    same_metrics = all(torch.equal(m_cont[k], m_res[k]) for k in m_cont)
    theirs = fresh.model.state_dict()
    differ = [n for n, v in det.model.state_dict().items()
              if not torch.equal(v, theirs[n])]
    check(same_metrics and not differ,
          f"resumed step != continued step: metrics equal {same_metrics}, "
          f"{len(differ)} entries differ, e.g. {differ[:3]}")

    check(det.model.training, "the train step left the model in eval mode")
    images = train_batch(4000, 32, "cuda")["images"]
    eval_twin = ssdlite320_mobilenet_v3_large(num_classes=91, seed=2)
    eval_twin.model.load_state_dict(det.model.state_dict())
    with cudnn_deterministic():
        got = make_predict_step(det)(det.model, images)
        want = make_predict_step(eval_twin)(eval_twin.model.eval(), images)
        torch.cuda.synchronize()
    check(all(torch.equal(got[k], want[k]) for k in want)
          and not det.model.training,
          "predict after training != a fresh model in eval mode")
    emit({"phase": "train_loop", "batches": 8, "batch": 32,
          "print_freq": 4, "losses": losses,
          "lr": [r["lr"] for r in rows.rows], "epoch_seconds": epoch_s,
          "checkpoint_mb": ckpt_mb,
          "resume_next_step_bit_equal": True,
          "resume_loss": float(m_res["loss"]),
          "predict_after_training_bit_equal_to_eval_model": True,
          "valid_detections": int(got["valid"].sum())})


# -- the other detector families ----------------------------------------------
# the registry's four other detectors, at full width and their own sizes
_FAMILIES = ("ssd300_vgg16", "ssd512_vgg16", "ssd_lite_mobilenet_v2",
             "pelee304")
# the class head's gain on the BN families (peak_class_head says why)
_HEAD_GAIN = 5.0
# the train step's batch per family: ssd512's b8 fits what b32 costs the
# others; the card-against-CPU loss check at B = 2 runs for the families
# whose CPU step takes seconds
_FAMILY_TRAIN_BATCH = {"ssd300_vgg16": 32, "ssd512_vgg16": 8,
                       "ssd_lite_mobilenet_v2": 32, "pelee304": 32}
# the SGD rate per family: the VGG SSDs at the SSD paper's 1e-3 (from
# random weights the recipe's 0.02 takes ssd300's loss from 31 to 1.3e6 in
# one step and to nan in the next, on the CPU), the others at the recipe's
_FAMILY_TRAIN_LR = {"ssd300_vgg16": 1e-3, "ssd512_vgg16": 1e-3,
                    "ssd_lite_mobilenet_v2": _TRAIN_LR, "pelee304": _TRAIN_LR}
_FAMILY_TRAIN_CPU = ("ssd300_vgg16", "ssd_lite_mobilenet_v2", "pelee304")
# predict modes of every family: the JAX package's mode names
_FAMILY_MODES = {"reference": {}, "fused": {"impl": "fused"},
                 "sparse_topk": {"topk_impl": "sparse"}}
# the counted requests (per mode) and their batch, the closed-loop (batch,
# batches) runs, and the calls timed per forward after one warm-up: few,
# as a VGG model's fp32 forward takes 0.1-0.9 s a batch on the H100 and
# the whole script has its time limit
_FAMILY_REQUESTS, _FAMILY_BATCH = 2, 32
_FAMILY_E2E = ((32, 2), (128, 2))
_FAMILY_FORWARD_ITERS = 1


def family_detectors(name, seed=0):
    """(card detector, CPU detector) of the registry's `name` at full
    width and size, with the same seeded random weights, in eval mode.

    A random MobileNetV2 or PeleeNet in eval mode has BN statistics (0,
    1) that match none of its activations, which shrink through the
    trunk (the MobileNetV2 model's logits spread by 3.5e-8 on the CPU):
    so these two get running statistics calibrated on 4 seeded frames,
    one train-mode forward at momentum 1, which keeps that batch's
    statistics. VGG has no BN."""
    import copy

    import numpy as np
    import torch

    from demonet_tpu_torch.models.builders import get_model
    from demonet_tpu_torch.models.detection import Detector, preprocess
    from demonet_tpu_torch.models.layers import BatchNorm

    cpu = get_model(name, device="cpu", seed=seed)
    bns = [m for m in cpu.model.modules() if isinstance(m, BatchNorm)]
    if bns:
        frames = shapes_images(np.random.default_rng(seed), 4,
                               cpu.config.size[0])[0]
        momenta = [m.momentum for m in bns]
        for m in bns:
            m.momentum = 1.0
        with torch.no_grad():
            cpu.model.train()(preprocess(torch.from_numpy(frames),
                                         cpu.config, resize=False))
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        cpu.model.eval()
    card = Detector(copy.deepcopy(cpu.model).to("cuda"), cpu.config,
                    cpu.anchors)
    return card, cpu


def peak_class_head(det):
    """The class head's last convs times _HEAD_GAIN, on a BN family: even
    calibrated, its random head spreads the logits by 0.4-0.6, so every
    softmax score sits near 1/21, below the models' 0.5 threshold, and
    nothing would reach NMS; x5 puts 0.8-2.5 % of them above it (500-1,500
    an image, on the CPU), as a trained head's peaks do. VGG's random
    scores cross its 0.01 threshold at 41-45 % of the entries as they
    are; its head is left alone. Returns whether the head was scaled."""
    import torch

    from demonet_tpu_torch.models.layers import BatchNorm

    if not any(isinstance(m, BatchNorm) for m in det.model.modules()):
        return False
    with torch.no_grad():
        for m in det.model.head.cls:
            conv = getattr(m, "pw", m)
            conv.weight.mul_(_HEAD_GAIN)
            conv.bias.mul_(_HEAD_GAIN)
    return True


def family_batch(seed, b, size, device):
    """A seeded train batch of shapes frames at `size` with their boxes."""
    import numpy as np
    import torch

    imgs, gt = shapes_images(np.random.default_rng(seed), b, size)
    return {k: torch.from_numpy(v).to(device)
            for k, v in {"images": imgs, **gt}.items()}


def family_train(name):
    """One family's train step on the card: closed-loop ms per step at its
    batch, peak memory, a finite loss; for _FAMILY_TRAIN_CPU, the loss
    terms of one step at B = 2 on the card and on the CPU from the same
    weights, within the flagship's tolerance."""
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step
    from demonet_tpu_torch.models.builders import get_model

    bs, lr = _FAMILY_TRAIN_BATCH[name], _FAMILY_TRAIN_LR[name]
    det = get_model(name, seed=0)
    size = det.config.size[0]
    state = create_train_state(det, make_optimizer(
        lr, _TRAIN_MOMENTUM, _TRAIN_WD))
    step = make_train_step(det)
    batch = family_batch(5000, bs, size, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    per_step, losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        with sync_errors():
            state, m = step(state, batch)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"{name} train step: loss {losses}")
    q1, med, q3 = np.percentile(per_step, [25, 50, 75])
    out = {"batch": bs, "lr": lr, "ms_per_step_median": med,
           "ms_per_step_q1_q3": [q1, q3], "n": len(per_step),
           "img_per_s": bs / med * 1e3, "losses": losses,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state, step, det
    if name in _FAMILY_TRAIN_CPU:
        terms = {}
        for where in ("cuda", "cpu"):
            d = get_model(name, device=where, seed=1)
            st = create_train_state(d, make_optimizer(
                lr, _TRAIN_MOMENTUM, _TRAIN_WD))
            _, m = make_train_step(d)(st, family_batch(5001, 2, size, where))
            terms[where] = {k: float(v) for k, v in m.items()}
        rel = {k: abs(terms["cuda"][k] - terms["cpu"][k]) / abs(terms["cpu"][k])
               for k in terms["cpu"]}
        check(max(rel.values()) <= _TRAIN_LOSS_RTOL,
              f"{name}: card against CPU loss terms at B = 2: {terms}")
        out["card_vs_cpu_b2"] = {"loss_card": terms["cuda"],
                                 "loss_cpu": terms["cpu"],
                                 "loss_rel_err": rel,
                                 "loss_rtol": _TRAIN_LOSS_RTOL}
    return out


def families(reset_counts, read_counts):
    """families: the four other detectors on the card, each with seeded
    random weights at full width and its own size (family_detectors):

      * predict through `make_predict_step` in the three modes, 2 requests
        of 32, counts reset just before and read just after each mode
        (K1 NMS, K2 gathers, K3 in its register and long-row launches),
        every mode's padded detections bit-equal to the reference
        postprocess's on the same head outputs; then closed-loop img/s at
        b32 and b128 with the forward / postprocess split;
      * the head outputs on the card against the CPU's, 2 frames, 1e-3;
      * K3 (k = 400: the long-row launch on the VGG rows, the register
        launch on the others) and K1 (K = 400) and K2 on the rows the
        model gave, bit-equal to their plain versions, and timed;
      * one train step per family (family_train).

    Returns {'launches_by_path', 'kernels': per kernel name, the rows of
    the family shapes for the `kernels` line}."""
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models import detection
    from demonet_tpu_torch.models.detection import (
        _NEG_INF,
        postprocess_detections,
        preprocess,
    )
    from demonet_tpu_torch.ops.gather import (
        gather_rows_batch,
        gather_rows_batch_plain,
    )
    from demonet_tpu_torch.ops.nms import (
        launch_shape,
        nms_keep_batch,
        nms_keep_batch_plain,
    )
    from demonet_tpu_torch.ops.topk import (
        MAX_ROW,
        topk_sparse,
        topk_sparse_plain,
    )

    b, thr = _FAMILY_BATCH, _NEG_INF / 2
    launches_by_path = {}
    kernels = {"nms_keep_batch": {}, "gather_rows_batch": {},
               "topk_sparse": {}, "topk_sparse_long": {}}
    branches = detection._postprocess_fused.branches
    for fi, name in enumerate(_FAMILIES):
        torch.cuda.reset_peak_memory_stats()
        t_mark, seconds = time.perf_counter(), {}

        def lap(what):
            nonlocal t_mark
            now = time.perf_counter()
            seconds[what] = now - t_mark
            t_mark = now

        det, cpu = family_detectors(name)
        cfg, size = det.config, det.config.size[0]

        # -- the card against the CPU, before the head is scaled ----------
        rng = np.random.default_rng(100 + fi)
        x2 = torch.from_numpy(shapes_images(rng, 2, size)[0])
        with torch.inference_mode():
            on_card = det.model(preprocess(x2.cuda(), cfg, resize=False))
            on_cpu = cpu.model(preprocess(x2, cfg, resize=False))
        head_err = {key: float((on_card[key].cpu() - on_cpu[key]).abs().max())
                    for key in on_cpu}
        check(all(e <= 1e-3 for e in head_err.values()),
              f"{name}: card against CPU head outputs {head_err}")
        del cpu, on_card, on_cpu
        peaked = peak_class_head(det)
        d, k, c = cfg.detections_per_img, cfg.topk_candidates, cfg.num_classes
        anchors = torch.as_tensor(det.anchors, device="cuda")
        a = anchors.shape[0]
        long_rows = a > MAX_ROW
        n = _FAMILY_REQUESTS
        xs = [torch.from_numpy(shapes_images(rng, b, size)[0]).cuda()
              for _ in range(n)]
        sizes = torch.tensor([[480, 640]] * b, dtype=torch.int32,
                             device="cuda")

        # -- predict, mode by mode, counted -------------------------------
        paths = {}
        for mode, kw in _FAMILY_MODES.items():
            step = make_predict_step(det, **kw)
            step(det.model, xs[0], sizes)
            torch.cuda.synchronize()
            reset_counts()
            dets = [step(det.model, x, sizes) for x in xs]
            torch.cuda.synchronize()
            counts = read_counts()
            taken = dict(branches)
            sparse = mode == "sparse_topk"
            want = {"nms_keep_batch": n, "gather_rows_batch": 2 * n,
                    "topk_sparse": n if sparse else 0,
                    "fused_inverted_residual": 0,
                    "topk_sparse_long": n if sparse and long_rows else 0}
            check(counts == want and (mode != "fused"
                                      or sum(taken.values()) == n),
                  f"{name} {mode}: launches {counts}, want {want}; "
                  f"branches {taken}")
            launches_by_path[f"{name}/{mode}"] = counts
            n_valid = []
            for dd in dets:
                v = dd["valid"]
                check(dd["boxes"].shape == (b, d, 4)
                      and dd["labels"].dtype == torch.int32
                      and bool(torch.isfinite(dd["boxes"]).all())
                      and bool((dd["scores"][v] > cfg.score_thresh).all())
                      and bool((dd["labels"][v] >= 1).all())
                      and bool((dd["labels"][v] < c).all()),
                      f"{name} {mode}: detections")
                n_valid.append(int(v.sum()))
            same = True
            for x in xs:
                with torch.inference_mode():
                    o = det.model(preprocess(x, cfg, resize=False))
                    args = (o["cls_logits"], o["bbox_regression"], anchors,
                            cfg, sizes)
                    ref = postprocess_detections(*args)
                    got = postprocess_detections(*args, **kw)
                same &= all(torch.equal(got[key], ref[key]) for key in ref)
            check(same, f"{name} {mode}: detections != the reference "
                  "postprocess's on the same head outputs")
            paths[mode] = {"launches": counts,
                           "k3_register_launches": counts["topk_sparse"]
                           - counts["topk_sparse_long"],
                           "valid_detections": n_valid,
                           "bit_equal_to_reference_postprocess": True,
                           **({"branches": taken} if mode == "fused"
                              else {})}

        lap("predict_modes_checked")

        # -- the kernels on the model's own rows ---------------------------
        with torch.inference_mode():
            out = det.model(preprocess(xs[0], cfg, resize=False))
            cand = head_to_candidates(det, out)
        rows = cand["fg"].reshape(-1, a)                  # (B x (C-1), A)
        p = rows.shape[0]
        slots = max(8, -(-k // 128))
        key3 = "topk_sparse_long" if long_rows else "topk_sparse"
        k_sc, k_idx = topk_sparse(rows, k, cfg.score_thresh, slots)
        p_sc, p_idx = topk_sparse_plain(rows, k, cfg.score_thresh)
        torch.cuda.synchronize()
        record_err(("topk_sparse", key3, f"{key3}/{name}"), k_sc, p_sc)
        check(torch.equal(k_sc.view(torch.int32), p_sc.view(torch.int32))
              and torch.equal(k_idx, p_idx),
              f"{name}: K3 != plain on the model's rows")
        nb, ns = cand["cand_boxes"], cand["cand_sc"]
        keep = nms_keep_batch(nb, ns, cfg.nms_thresh, thr)
        p_keep = nms_keep_batch_plain(nb, ns, cfg.nms_thresh, thr)
        torch.cuda.synchronize()
        record_err(("nms_keep_batch", f"nms_keep_batch/{name}"), keep, p_keep)
        check(torch.equal(keep, p_keep), f"{name}: K1 != plain at K={k}")
        final_idx = torch.sort(ns.reshape(b, -1), dim=-1, descending=True,
                               stable=True)[1][:, :d].to(torch.int32)
        g_cases = {"candidate": (cand["boxes"].contiguous(), cand["top_idx"]),
                   "final": (nb.reshape(b, -1, 4).contiguous(),
                             final_idx.contiguous())}
        for gname, (table, idx) in g_cases.items():
            got = gather_rows_batch(table, idx)
            ref = gather_rows_batch_plain(table, idx)
            torch.cuda.synchronize()
            record_err(("gather_rows_batch", f"gather_rows_batch/{name}"),
                       got, ref)
            check(torch.equal(got, ref), f"{name}: K2 != plain ({gname})")

        # -- their times ---------------------------------------------------
        def launches_of(kernel, name=name):
            return sum(v[kernel] for pth, v in launches_by_path.items()
                       if pth.startswith(name + "/"))

        nbytes, ops = topk_work(rows, k, cfg.score_thresh)
        bms, by = bound(nbytes, ops)
        t_k = timed(lambda: topk_sparse(rows, k, cfg.score_thresh, slots), 20)
        t_p = timed(lambda: topk_sparse_plain(rows, k, cfg.score_thresh), 5)
        t_l = timed(lambda: torch.topk(rows, k, dim=-1), 10)
        kernels[key3][name] = {
            "shape": [p, a], "k": k, "slots": slots,
            "launch": "topk_sparse_long" if long_rows else "register",
            "ms": t_k["ms"], "plain_ms": t_p["ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": t_l["ms"],
            "library": f"torch.topk(k={k}) on the same rows",
            "launches": launches_of("topk_sparse_long" if long_rows
                                    else "topk_sparse"),
            "max_abs_err": _MAX_ERR[f"{key3}/{name}"],
            "branches": topk_branches(rows, cfg.score_thresh, k, slots),
            "bytes": nbytes, "ops": ops, "event_ms": t_k["event_ms"],
            "ms_from": t_k["ms_from"]}
        nbytes, ops = nms_work(keep, ns, thr)
        bms, by = bound(nbytes, ops)
        t_k = timed(lambda: nms_keep_batch(nb, ns, cfg.nms_thresh, thr), 20)
        t_p = timed(lambda: nms_keep_batch_plain(nb, ns, cfg.nms_thresh, thr),
                    2, 1)
        kernels["nms_keep_batch"][name] = {
            "shape": list(ns.shape), "launch": launch_shape(k),
            "ms": t_k["ms"], "plain_ms": t_p["ms"], "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "launches": launches_of("nms_keep_batch"),
            "max_abs_err": _MAX_ERR[f"nms_keep_batch/{name}"],
            "valid": int((ns > thr).sum()), "kept": int(keep.sum()),
            "bytes": nbytes, "ops": ops, "event_ms": t_k["event_ms"],
            "ms_from": t_k["ms_from"]}
        calls = {gname: gather_row(table, idx, 50)
                 for gname, (table, idx) in g_cases.items()}
        calls["final"]["retimed"] = gather_retimed(*g_cases["final"])
        kernels["gather_rows_batch"][name] = {
            **{key: sum(cl[key] for cl in calls.values())
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": "bytes", "launches": launches_of("gather_rows_batch"),
            "max_abs_err": _MAX_ERR[f"gather_rows_batch/{name}"],
            "per_predict": "candidate + final gather", "calls": calls}
        del out, cand, rows
        lap("kernels_checked_and_timed")

        # -- closed-loop img/s ---------------------------------------------
        e2e, traces, fc6_ms = {}, {}, {}
        for bs, iters in _FAMILY_E2E:
            x = torch.from_numpy(shapes_images(np.random.default_rng(bs), bs,
                                               size)[0]).cuda()
            sz = torch.tensor([[480, 640]] * bs, dtype=torch.int32,
                              device="cuda")
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: det.model(
                    preprocess(x, cfg, resize=False)),
                    _FAMILY_FORWARD_ITERS, 1)
                # the same forward with cuDNN choosing its algorithms by
                # timing them (benchmark mode) instead of by heuristics
                torch.backends.cudnn.benchmark = True
                try:
                    fwd_bench_ms = cuda_ms(lambda: det.model(
                        preprocess(x, cfg, resize=False)),
                        _FAMILY_FORWARD_ITERS, 1)
                finally:
                    torch.backends.cudnn.benchmark = False
                fc6 = getattr(det.model.extractor, "fc6", None)
                if fc6 is not None:   # VGG's atrous conv, timed alone
                    seen = []
                    hook = fc6.register_forward_pre_hook(
                        lambda m, args: seen.append(args[0]))
                o = det.model(preprocess(x, cfg, resize=False))
                if fc6 is not None:
                    hook.remove()
                    fc6_ms[f"b{bs}"] = cuda_ms(lambda: fc6(seen[0]),
                                               _FAMILY_FORWARD_ITERS, 1)
                    del seen
            for mode, kw in _FAMILY_MODES.items():
                step = make_predict_step(det, **kw)
                step(det.model, x, sz)
                torch.cuda.synchronize()
                branches.clear()
                per_batch = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    step(det.model, x, sz)
                    torch.cuda.synchronize()
                    per_batch.append((time.perf_counter() - t0) * 1e3)
                q1, med, q3 = np.percentile(per_batch, [25, 50, 75])
                taken = dict(branches)
                with torch.inference_mode():
                    post_ms = cuda_ms(lambda: postprocess_detections(
                        o["cls_logits"], o["bbox_regression"], anchors, cfg,
                        sz, **kw), 3, 1)
                if mode == "reference":   # where a batch's time goes
                    traces[f"b{bs}"] = trace_calls(
                        lambda: step(det.model, x, sz), 1)
                e2e[f"{mode}_b{bs}"] = {
                    "img_per_s": bs / med * 1e3, "ms_per_batch_median": med,
                    "ms_per_batch_q1_q3": [q1, q3], "n": iters,
                    "forward_ms": fwd_ms,
                    "forward_ms_cudnn_benchmark": fwd_bench_ms,
                    "postprocess_ms": post_ms,
                    **({"branches": taken} if mode == "fused" else {})}
            del o, x
            lap(f"e2e_b{bs}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del det
        torch.cuda.empty_cache()
        train = family_train(name)
        lap("train")
        emit({"phase": "families", "model": name, "size": [size, size],
              "classes": c, "anchors": a, "topk_candidates": k,
              "detections_per_img": d, "score_thresh": cfg.score_thresh,
              "weights": "seeded random" + (
                  f"; BN statistics calibrated, class head x{_HEAD_GAIN} "
                  "after the card-against-CPU check" if peaked else ""),
              "paths": paths, "head_max_abs_err_vs_cpu": head_err,
              "head_limit": 1e-3, "e2e": e2e,
              "trace_reference": traces,
              **({"fc6_forward_ms": fc6_ms} if fc6_ms else {}),
              "predict_peak_mem_gib": peak,
              "train": train, "seconds": seconds})
    return {"launches_by_path": launches_by_path, "kernels": kernels}


# -- the train CLI ------------------------------------------------------------
# `python -m demonet_tpu_torch.train` in process: 64 synthetic frames at the
# network size (320x320), batch 32, from the trained npz
_CLI_FRAMES, _CLI_BATCH = 64, 32
# a postprocess score threshold at which the resumed model's rows are
# sparse enough for the fused path's tiers
_CLI_FUSED_THRESH = "0.05"
# the CLI's own printing (MetricLogger lines, COCO summaries) goes here
_CLI_LOG = os.path.join(_HERE, "chiprun_out", "cli_synthetic.log")
_CLI_ARGS = ("--dataset", "synthetic", "--synthetic-size", str(_CLI_FRAMES),
             "--batch-size", str(_CLI_BATCH), "--num-classes", "91",
             "--npz-weights", _NPZ, "--print-freq", "1")
# the same frames through another family: ssd300_vgg16, seeded random
# weights, the synthetic set's 7 classes
_CLI_VGG_ARGS = ("--dataset", "synthetic", "--synthetic-size",
                 str(_CLI_FRAMES), "--batch-size", str(_CLI_BATCH),
                 "--print-freq", "1")


@contextlib.contextmanager
def without_modules(scratch, *names):
    """Imports of these top-level modules fail inside the block (and work
    again after it), in this process and in the spawn processes started
    in it: stand-ins that raise ImportError, written under `scratch`, go
    first on sys.path, which a spawn child takes from its parent. Shows
    that a path, its loader workers included, runs without them. With no
    names it changes nothing (the stand-ins of an earlier block stay off
    sys.path)."""
    if not names:
        yield
        return
    blocker = os.path.join(scratch, "blocked_modules")
    os.makedirs(blocker, exist_ok=True)
    for n in names:
        with open(os.path.join(blocker, f"{n}.py"), "w") as f:
            f.write(f"raise ImportError('{n} is blocked in this run')\n")
    saved = {n: sys.modules.get(n) for n in names}
    for n in names:
        sys.modules[n] = None
    sys.path.insert(0, blocker)
    try:
        yield
    finally:
        sys.path.remove(blocker)
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def module_versions(*names):
    """{name: version, or None where it does not import}."""
    import importlib

    out = {}
    for n in names:
        try:
            out[n] = getattr(importlib.import_module(n), "__version__", "?")
        except ImportError:
            out[n] = None
    return out


def cli_synthetic(reset_counts, read_counts):
    """cli_synthetic: the port's train CLI (`demonet_tpu_torch.train.main`)
    on the card, in process, under cudnn.deterministic, with cv2 and PIL
    made unimportable in the process and its loader workers (synthetic
    frames at the network size with hflip need neither): one epoch with a
    checkpoint, then --test-only --resume of that checkpoint (the two COCO
    summaries must be equal), then --postprocess fused and -j 2. The
    kernel counts and the fused path's branches are reset before each
    evaluation and read after it: K1 (NMS) and K2 (row gather) must have
    launched. At the default score threshold (0.001) the resumed model's
    rows are dense and the fused path may take its fallback; at
    --score-thresh 0.05 every batch must take a fused tier, with the
    summary of the reference postprocess at that threshold. -j 2 must
    give the batches of -j 0 (the worker pool against the prefetch
    thread, on the training loader with the ssd augmentation where cv2 is
    present). Also the cost of the step's copy of a b32 batch from
    pageable host memory."""
    import tempfile

    import numpy as np
    import torch

    from demonet_tpu_torch import train as cli
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.data.presets import (
        DetectionPresetEval,
        DetectionPresetTrain,
    )
    from demonet_tpu_torch.data.synthetic import SyntheticDetection
    from demonet_tpu_torch.engine import evaluate as ev_mod
    from demonet_tpu_torch.engine import train as train_mod
    from demonet_tpu_torch.models import detection

    spans = {"train": [], "eval": []}
    eval_counts, eval_branches, augmentation = [], [], []
    branches = detection._postprocess_fused.branches
    run_evaluate, run_epoch = ev_mod.evaluate, train_mod.train_one_epoch

    def timed_epoch(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(*args, **kwargs)
        torch.cuda.synchronize()
        spans["train"].append(time.perf_counter() - t0)
        return out

    def counted_evaluate(*args, **kwargs):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = run_evaluate(*args, **kwargs)
        torch.cuda.synchronize()
        spans["eval"].append(time.perf_counter() - t0)
        eval_counts.append(read_counts())
        eval_branches.append(dict(branches))
        return out

    def run(*argv, base=_CLI_ARGS, blocked=("cv2", "PIL")):
        args = cli.get_args_parser().parse_args([*base, *argv])
        augmentation.append(args.data_augmentation)
        spans["eval"].clear()
        eval_counts.clear()
        eval_branches.clear()
        ev_mod.evaluate, train_mod.train_one_epoch = (counted_evaluate,
                                                      timed_epoch)
        try:
            with cudnn_deterministic(), without_modules(tmp, *blocked), \
                    open(_CLI_LOG, "a") as log, \
                    contextlib.redirect_stdout(log):
                print(f"== {' '.join(argv)}", flush=True)
                ev = cli.main(args)
        finally:
            ev_mod.evaluate, train_mod.train_one_epoch = (run_evaluate,
                                                          run_epoch)
        counts = eval_counts[-1]
        check(ev is not None and ev.stats is not None
              and bool(np.isfinite(ev.stats).all()),
              f"CLI {argv}: no finite COCO summary")
        check(counts["nms_keep_batch"] > 0 and counts["gather_rows_batch"] > 0,
              f"CLI {argv}: the evaluation launched {counts}, want K1 and K2")
        return ev, counts, spans["eval"][-1], eval_branches[-1]

    os.makedirs(os.path.dirname(_CLI_LOG), exist_ok=True)
    if os.path.exists(_CLI_LOG):
        os.remove(_CLI_LOG)
    n_batches = _CLI_FRAMES // _CLI_BATCH
    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        trained, c_train, s_eval, _ = run("--epochs", "1", "--output-dir",
                                          tmp)
        ckpt = os.path.join(tmp, "checkpoint_0")
        check(os.path.exists(os.path.join(ckpt, "state.pt")),
              "the CLI wrote no checkpoint")
        resume = ("--test-only", "--resume", ckpt, "--output-dir", tmp)
        resumed, c_resumed, s_resumed, _ = run(*resume)
        check(np.array_equal(resumed.stats, trained.stats),
              f"--test-only --resume summary {resumed.stats.tolist()} != "
              f"the training run's {trained.stats.tolist()}")
        fused, c_fused, s_fused, b_fused = run(*resume, "--postprocess",
                                               "fused")
        check(np.array_equal(fused.stats, resumed.stats)
              and sum(b_fused.values()) == n_batches,
              f"--postprocess fused: summary {fused.stats.tolist()}, "
              f"branches {b_fused}")
        thresh = ("--score-thresh", _CLI_FUSED_THRESH)
        ref_t, c_ref_t, s_ref_t, b_ref_t = run(*resume, *thresh)
        fused_t, c_fused_t, s_fused_t, b_fused_t = run(
            *resume, *thresh, "--postprocess", "fused")
        check(not b_ref_t and sum(b_fused_t.values()) == n_batches
              and all(k.startswith("tier_") for k in b_fused_t),
              f"at --score-thresh {_CLI_FUSED_THRESH} the fused evaluation "
              f"took {b_fused_t}: want a fused tier on every batch")
        check(np.array_equal(fused_t.stats, ref_t.stats),
              f"--postprocess fused summary {fused_t.stats.tolist()} != "
              f"the reference's {ref_t.stats.tolist()} at --score-thresh "
              f"{_CLI_FUSED_THRESH}")
        pooled, c_pooled, s_pooled, _ = run(*resume, "-j", "2")
        check(np.array_equal(pooled.stats, resumed.stats),
              "-j 2 evaluation summary != -j 0")
        # another family: ssd300_vgg16 from seeded random weights, its
        # 300x300 frames resized from the synthetic 320x320 by cv2
        vgg, c_vgg, s_vgg, _ = run(
            "--model", "ssd300_vgg16", "--epochs", "1", "--output-dir",
            os.path.join(tmp, "vgg"), base=_CLI_VGG_ARGS, blocked=())

    # -j 2 against -j 0 on the training loader, batch for batch
    policy = "ssd" if module_versions("cv2")["cv2"] else "hflip"
    ds = SyntheticDetection(n=_CLI_FRAMES, seed=0,
                            transforms=DetectionPresetTrain(policy))
    kw = dict(batch_size=_CLI_BATCH, image_size=(320, 320), shuffle=True,
              drop_last=True, max_gt=100, seed=0)
    serial = [dict(b) for b in DetectionLoader(ds, **kw)]
    t0 = time.perf_counter()
    pooled_b = [dict(b) for b in DetectionLoader(ds, num_workers=2, **kw)]
    pool_s = time.perf_counter() - t0
    check(len(serial) == len(pooled_b) == _CLI_FRAMES // _CLI_BATCH and all(
        np.array_equal(a[k], b[k]) for a, b in zip(serial, pooled_b)
        for k in a), f"-j 2 batches != -j 0 batches ({policy})")

    # where an evaluation's time goes: the loader alone (frames drawn on
    # the host, the prefetch thread), and the COCO accumulate and summary
    val = SyntheticDetection(n=_CLI_FRAMES, num_classes=7, seed=1,
                             transforms=DetectionPresetEval())
    t0 = time.perf_counter()
    for _ in DetectionLoader(val, _CLI_BATCH, (320, 320)):
        pass
    val_loader_s = time.perf_counter() - t0
    with open(_CLI_LOG, "a") as log, contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        resumed.accumulate()
        resumed.summarize()
        coco_s = time.perf_counter() - t0

    # the train step's copy of a batch: numpy (pageable) -> device
    copy_ms = {}  # b32 images
    for dtype in ("float32", "uint8"):
        host = serial[0]["images"]
        if dtype == "uint8":
            host = np.clip(np.rint(host * 255.0), 0, 255).astype(np.uint8)
        per = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.as_tensor(host).to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(per))
        copy_ms[dtype] = {"mb": host.nbytes / 1e6, "ms_median": med,
                          "gb_per_s": host.nbytes / med / 1e6}

    names = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
             "AR100", "ARs", "ARm", "ARl")
    summary = dict(zip(names, trained.stats.tolist()))
    emit({"phase": "cli_synthetic", "frames": _CLI_FRAMES,
          "batch": _CLI_BATCH, "augmentation": sorted(set(augmentation)),
          "cv2_and_pil_blocked": "in the CLI's process and its -j 2 "
          "loader workers, for every CLI run",
          "epoch_seconds": spans["train"][0],
          "epoch_img_per_s": _CLI_FRAMES / spans["train"][0],
          "eval_seconds": {"after_training": s_eval, "resumed": s_resumed,
                           "fused": s_fused, "j2": s_pooled},
          "eval_img_per_s": _CLI_FRAMES / s_resumed,
          "eval_split_seconds": {"loader_alone": val_loader_s,
                                 "coco_accumulate_summarize": coco_s},
          "summary": summary, "resume_summary_equal": True,
          "fused_summary": dict(zip(names, fused.stats.tolist())),
          "fused_summary_equal": True, "fused_branches": b_fused,
          "fused_at_score_thresh": {
              "score_thresh": float(_CLI_FUSED_THRESH),
              "branches": b_fused_t, "summary_equal_to_reference": True,
              "summary": dict(zip(names, fused_t.stats.tolist())),
              "eval_seconds": {"reference": s_ref_t, "fused": s_fused_t}},
          "j2_summary_equal": True,
          "eval_launches": {"after_training": c_train, "resumed": c_resumed,
                            "fused": c_fused,
                            "reference_at_thresh": c_ref_t,
                            "fused_at_thresh": c_fused_t, "j2": c_pooled},
          "ssd300_vgg16": {
              "args": " ".join(_CLI_VGG_ARGS), "epoch_seconds":
              spans["train"][-1], "eval_seconds": s_vgg,
              "eval_launches": c_vgg,
              "summary": dict(zip(names, vgg.stats.tolist()))},
          "j2_train_batches_bit_equal": True, "j2_policy": policy,
          "j2_loader_seconds": pool_s,
          "h2d_copy_pageable_b32": copy_ms})


# -- the other entry points ---------------------------------------------------
# the predict CLI's frames, the public NMS's sizes, the eval_voc tree and
# the native decode tree
_ENTRY_FRAMES = 8
_ENTRY_FRAME_HW = (480, 640)
_PUBLIC_NMS_N = (1000, 8192)
# K1's long launch (N > 8,192), the public calls at the largest
_LONG_NMS_N = (8193, 16384, 20000)
_PUBLIC_NMS_IOU = 0.55
_VOC_FRAMES, _VOC_BATCH = 64, 32
_NATIVE_FRAMES = 64
_ENTRY_LOG = os.path.join(_HERE, "chiprun_out", "entry_points.log")
_FLAGSHIP = "ssdlite320_mobilenet_v3_large"


def write_jpegs(folder, n, hw, seed):
    """n seeded shapes frames of size hw as JPEG files; returns (paths,
    the rectangles as (boxes (n, 8, 4), labels (n, 8), valid (n, 8)))."""
    import cv2
    import numpy as np

    h, w = hw
    imgs, gt = shapes_images(np.random.default_rng(seed), n, max(h, w))
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(folder, f"{i:06d}.jpg"))
        check(cv2.imwrite(paths[-1], img[:h, :w]), f"cv2 wrote no {paths[-1]}")
    boxes = gt["gt_boxes"].copy()
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, h)
    valid = gt["gt_valid"] & (boxes[..., 2] - boxes[..., 0] > 1) & (
        boxes[..., 3] - boxes[..., 1] > 1)
    return paths, (boxes, gt["gt_labels"], valid)


def write_voc_annotations(root, names, objects, hw):
    """VOC2007 Annotations/<name>.xml and ImageSets/Main/test.txt;
    objects[i]: [(class name, (x1, y1, x2, y2))]."""
    h, w = hw
    os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets", "Main"), exist_ok=True)
    for name, objs in zip(names, objects):
        body = "".join(
            f"<object><name>{c}</name><difficult>0</difficult><bndbox>"
            f"<xmin>{b[0]:.1f}</xmin><ymin>{b[1]:.1f}</ymin>"
            f"<xmax>{b[2]:.1f}</xmax><ymax>{b[3]:.1f}</ymax></bndbox>"
            "</object>" for c, b in objs)
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height><depth>3</depth></size>{body}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def write_coco_tree(root, n, hw, seed):
    """COCO val2017 layout of n seeded shapes frames (JPEG) with their
    rectangles; returns (image folder, annotation file)."""
    paths, (boxes, labels, valid) = write_jpegs(
        os.path.join(root, "val2017"), n, hw, seed)
    images, anns = [], []
    for i, p in enumerate(paths):
        images.append({"id": i + 1, "file_name": os.path.basename(p),
                       "height": hw[0], "width": hw[1]})
        for b, lab in zip(boxes[i][valid[i]], labels[i][valid[i]]):
            x1, y1, x2, y2 = (float(v) for v in b)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(lab), "iscrowd": 0,
                         "bbox": [x1, y1, x2 - x1, y2 - y1],
                         "area": (x2 - x1) * (y2 - y1)})
    ann_file = os.path.join(root, "instances_val2017.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"shape{c}"} for c in range(1, 7)]}, f)
    return os.path.join(root, "val2017"), ann_file


@contextlib.contextmanager
def plain_nms():
    """Inside the block the public NMS (ops/nms.py) runs the plain
    version of K1 on any device: its plain twin, to time and compare."""
    from demonet_tpu_torch.ops import nms as nms_mod

    wrapper = nms_mod.nms_keep_batch
    nms_mod.nms_keep_batch = nms_mod.nms_keep_batch_plain
    try:
        yield
    finally:
        nms_mod.nms_keep_batch = wrapper


@contextlib.contextmanager
def weights_dir(path):
    """$DEMONET_WEIGHTS_DIR set to path inside the block."""
    saved = os.environ.get("DEMONET_WEIGHTS_DIR")
    os.environ["DEMONET_WEIGHTS_DIR"] = path
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("DEMONET_WEIGHTS_DIR", None)
        else:
            os.environ["DEMONET_WEIGHTS_DIR"] = saved


def save_reference_pth(name, variables, path):
    """JAX-layout variables of `name` as a reference-layout .pth."""
    import torch

    from demonet_tpu_torch.utils.torch_weights import (
        synthesize_torch_state_dict,
    )

    torch.save({k: torch.from_numpy(v) for k, v in
                synthesize_torch_state_dict(name, variables).items()}, path)
    return path


def entry_points(trained, batches, sizes, reset_counts, read_counts):
    """entry_points: the entry points a user reaches first, on the card.

    (a) the trained npz as a reference .pth (synthesize_torch_state_dict),
    loaded by `hub.load` on cuda: detections on the 4 shapes batches
    bit-equal to the npz-loaded model's; (b) the predict CLI on 8 shapes
    frames written as JPEG (480x640), in both --postprocess modes, K1 and
    K2 counted per image, the two modes' detections equal, each image's
    time beside its predict step's alone (synchronized before and after,
    host clock); (c) the public
    nms_mask, nms and batched_nms on CUDA tensors, each launching K1 once,
    bit-equal to their plain twin (the same functions with K1's plain
    version, on the card and on the CPU), at N = 1,000 and 8,192 (seeded
    random boxes) and on one flagship image's 3,234 decoded boxes, timed;
    (d) eval_voc on a VOCdevkit of 64 shapes frames with
    ssd_lite_mobilenet_v2 from a .pth of seeded random weights, on the
    card and on the CPU: the ground truth holds the rectangles and the
    model's own confident detections from a first pass (random weights
    find none of the rectangles), so the card's per-class APs and mAP are
    held within 1e-3 of the CPU's on real matches; the results files written; (e) --pretrained
    with an empty weights cache raises and names the URL; with the
    flagship .pth in the cache under its published name, --test-only
    --pretrained prints "loaded pretrained weights" and gives the COCO
    summary of --npz-weights; (f) the native JPEG loader, where g++ and
    <jpeglib.h> are there: it must build, and over a 64-frame COCO tree
    its batches' sizes and targets equal the Python loader's, its time
    per 64 frames beside the Python loader's, and the largest pixel
    difference between libjpeg + its bilinear resize and PIL + cv2.
    Returns {"launches_by_path", "public_nms"} for the `kernels` line."""
    import io
    import tempfile

    import cv2
    import numpy as np
    import torch

    from demonet_tpu_torch import eval_voc as eval_voc_cli
    from demonet_tpu_torch import hub
    from demonet_tpu_torch import predict as predict_cli
    from demonet_tpu_torch import train as train_cli
    from demonet_tpu_torch.data import native
    from demonet_tpu_torch.data.coco import CocoDetection
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.data.voc import VOC_CLASSES
    from demonet_tpu_torch.engine import evaluate as ev_mod
    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models import detection
    from demonet_tpu_torch.ops.nms import (
        batched_nms,
        launch_shape,
        nms,
        nms_keep_batch,
        nms_keep_batch_plain,
        nms_mask,
        scratch_bytes,
    )
    from demonet_tpu_torch.utils.checkpoints import load_npz_variables
    from demonet_tpu_torch.utils.pretrained import (
        PRETRAINED_URLS,
        cached_weights_path,
    )
    from demonet_tpu_torch.utils import viz
    from demonet_tpu_torch.utils.weights import jax_variables_of

    t0_phase = time.perf_counter()
    split = {}   # seconds of each part of the phase

    def lap(part):
        split[part] = time.perf_counter() - t0_phase - sum(split.values())
    dev = trained.device
    launches = {}
    os.makedirs(os.path.dirname(_ENTRY_LOG), exist_ok=True)
    if os.path.exists(_ENTRY_LOG):
        os.remove(_ENTRY_LOG)

    def counted(path, fn):
        """fn() with every count reset just before and read just after."""
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[f"entry_points/{path}"] = read_counts()
        return out

    def logged(fn):
        """fn()'s printing to the phase's log, and returned."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        with open(_ENTRY_LOG, "a") as log:
            log.write(buf.getvalue())
        return out, buf.getvalue()

    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        # (a) the .pth round trip through hub.load
        pth = save_reference_pth(_FLAGSHIP, load_npz_variables(_NPZ),
                                 os.path.join(tmp, "flagship.pth"))
        step = make_predict_step(trained)
        det = hub.load(_FLAGSHIP, weights=pth, num_classes=91)
        check(det.device == dev, f"hub.load put the model on {det.device}")
        hub_step = make_predict_step(det)
        want = [step(trained.model, x, sizes) for x in batches]
        got = counted("hub_pth", lambda: [hub_step(det.model, x, sizes)
                                          for x in batches])
        for g, w in zip(got, want):
            for k in w:
                check(torch.equal(g[k], w[k]),
                      f"hub.load(.pth) detections differ in {k}")
        check(launches["entry_points/hub_pth"]["nms_keep_batch"] == 4,
              f"hub path launches {launches['entry_points/hub_pth']}")
        lap("hub_pth")

        # (b) the predict CLI on JPEG frames, both modes
        frames, _ = write_jpegs(os.path.join(tmp, "frames"), _ENTRY_FRAMES,
                                _ENTRY_FRAME_HW, seed=41)
        cli_out = {}
        read_image = viz.load_image
        starts = []   # when the CLI began each image (its first read)
        step_ms = []  # the predict step alone, each image, synchronized

        def timed_read(path, size=None, *args, **kwargs):
            if size is None:
                starts.append(time.perf_counter())
            return read_image(path, size, *args, **kwargs)

        def timed_make_step(*args, **kwargs):
            inner = make_predict_step(*args, **kwargs)

            def timed_step(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = inner(*a, **kw)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                return out
            return timed_step

        for mode in ("reference", "fused"):
            args = predict_cli.get_args_parser().parse_args(
                ["--torch-weights", pth, "--images", *frames,
                 "--postprocess", mode, "--output-dir",
                 os.path.join(tmp, f"vis_{mode}")])
            starts.clear()
            step_ms.clear()
            viz.load_image = timed_read
            ev_mod.make_predict_step = timed_make_step
            t0 = time.perf_counter()
            try:
                res, _ = counted(f"predict_cli_{mode}", lambda: logged(
                    lambda: predict_cli.main(args)))
            finally:
                viz.load_image = read_image
                ev_mod.make_predict_step = make_predict_step
            secs = time.perf_counter() - t0
            per_image = np.diff(starts + [t0 + secs]) * 1e3
            check(len(step_ms) == _ENTRY_FRAMES,
                  f"predict CLI ({mode}) ran {len(step_ms)} timed steps")
            c = launches[f"entry_points/predict_cli_{mode}"]
            check(c["nms_keep_batch"] == _ENTRY_FRAMES
                  and c["gather_rows_batch"] == 2 * _ENTRY_FRAMES,
                  f"predict CLI ({mode}) launched {c}: want 1 NMS and 2 "
                  "gathers per image")
            for p in frames:
                vis = cv2.imread(os.path.join(tmp, f"vis_{mode}",
                                              os.path.basename(p)))
                check(vis is not None and vis.shape[:2] == _ENTRY_FRAME_HW,
                      f"predict CLI ({mode}) saved no {_ENTRY_FRAME_HW} "
                      f"image for {p}")
            cli_out[mode] = {
                "detections": res, "seconds": secs,
                "setup_seconds": starts[0] - t0,
                "first_image_ms": float(per_image[0]),
                "ms_per_image_after_first": {
                    "median": float(np.median(per_image[1:])),
                    "min": float(per_image[1:].min()),
                    "max": float(per_image[1:].max())},
                "predict_step_first_ms": step_ms[0],
                "predict_step_ms_after_first": {
                    "median": float(np.median(step_ms[1:])),
                    "min": float(min(step_ms[1:])),
                    "max": float(max(step_ms[1:]))}}
        box_diff = 0.0
        for r, f in zip(cli_out["reference"]["detections"],
                        cli_out["fused"]["detections"]):
            check(np.array_equal(r["labels"], f["labels"])
                  and np.array_equal(r["scores"], f["scores"]),
                  "predict CLI: fused detections != reference")
            if len(r["boxes"]):
                box_diff = max(box_diff,
                               float(np.abs(r["boxes"] - f["boxes"]).max()))
        check(box_diff <= 1e-4, f"predict CLI: fused boxes differ by "
              f"{box_diff}")
        n_dets = [len(r["scores"]) for r in cli_out["reference"]["detections"]]
        check(sum(n_dets) > 0, "predict CLI: no detection above 0.5")
        lap("predict_cli")

        # (c) the public NMS on CUDA tensors
        gen = torch.Generator().manual_seed(43)
        cases = {}
        for n in _PUBLIC_NMS_N:
            xy = torch.rand((n, 2), generator=gen) * 1000
            wh = torch.rand((n, 2), generator=gen) * 90 + 10
            cases[f"random_N{n}"] = (
                torch.cat([xy, xy + wh], 1), torch.rand(n, generator=gen),
                torch.randint(0, 90, (n,), generator=gen))
        with torch.inference_mode():
            o = trained.model(detection.preprocess(batches[0][:1],
                                                   trained.config,
                                                   resize=False))
            sc, bx = detection._scores_and_boxes(
                o["cls_logits"], o["bbox_regression"],
                torch.as_tensor(trained.anchors, device=dev), trained.config)
        fg, lab = sc[0, :, 1:].max(-1)
        cases[f"flagship_N{bx.shape[1]}"] = (bx[0].cpu(), fg.cpu(),
                                             (lab + 1).cpu())
        apis = {
            "nms_mask": lambda b, s, l: nms_mask(b, s, _PUBLIC_NMS_IOU),
            "nms": lambda b, s, l: nms(b, s, _PUBLIC_NMS_IOU, 300),
            "batched_nms": lambda b, s, l: batched_nms(
                b, s, l, _PUBLIC_NMS_IOU, 300),
        }
        on_card = {name: tuple(t.to(dev).contiguous() for t in c)
                   for name, c in cases.items()}
        for name, c in on_card.items():   # warm-up, outside the count
            for fn in apis.values():
                fn(*c)

        def run_public():
            return {(case, api): fn(*c) for case, c in on_card.items()
                    for api, fn in apis.items()}

        kernel_out = counted("public_nms", run_public)
        check(launches["entry_points/public_nms"]["nms_keep_batch"]
              == len(cases) * len(apis),
              f"public NMS launches {launches['entry_points/public_nms']}: "
              "want K1 once per call")
        with plain_nms():
            plain_card = run_public()
        # and on the CPU, up to N = 4,096 (the plain loop's cost grows as
        # N squared on the host)
        plain_cpu = {(case, api): fn(*cases[case])
                     for case in cases for api, fn in apis.items()
                     if cases[case][0].shape[0] <= 4096}
        for key, got in kernel_out.items():
            got = got if isinstance(got, tuple) else (got,)
            for want in (plain_card[key], plain_cpu.get(key, plain_card[key])):
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    record_err(("nms_keep_batch", "nms_keep_batch/public"),
                               g.cpu().float(), w.cpu().float())
                    check(torch.equal(g.cpu(), w.cpu()),
                          f"public {key[1]} on {key[0]}: kernel != plain")

        public = {}
        for name, (b, s, lab) in on_card.items():
            n = b.shape[0]
            order = torch.sort(-s, stable=True)[1]
            b1, s1 = b[order][None].contiguous(), s[order][None].contiguous()
            thr = -1e30
            keep = nms_keep_batch(b1, s1, _PUBLIC_NMS_IOU, thr)
            nbytes, ops = nms_work(keep, s1, thr)
            bms, by = bound(nbytes, ops)
            k_t = timed(lambda: nms_keep_batch(b1, s1, _PUBLIC_NMS_IOU, thr),
                        50)
            # ~12 launches per valid candidate, so the plain version is
            # launch-bound: CUDA events over one call (a profiler trace
            # of its ~10^5 launches costs tens of seconds)
            plain_ms = cuda_ms(lambda: nms_keep_batch_plain(
                b1, s1, _PUBLIC_NMS_IOU, thr), 1, 1 if n <= 4096 else 0)
            api_ms = {api: timed(lambda fn=fn: fn(b, s, lab), 20)["ms"]
                      for api, fn in apis.items()}
            public[name] = {
                "shape": [1, n], "launch": launch_shape(n),
                "ms": k_t["ms"], "plain_ms": plain_ms,
                "plain_ms_from": "events", "bound_ms": bms,
                "bound_by": by, "library_ms": None,
                "library": "none: no PyTorch call (torchvision's nms is "
                           "not in the port)",
                "bytes": nbytes, "ops": ops, "kept": int(keep.sum()),
                "event_ms": k_t["event_ms"], "ms_from": k_t["ms_from"],
                "public_call_ms": api_ms}
        # K1's long launch (N > 8,192): straight, against the plain
        # version on a CPU copy (on the card it issues ~12 launches a
        # sweep step: seconds at these N); then the public calls at the
        # largest N, K1 once each
        gen = torch.Generator().manual_seed(44)
        long_cases = {}
        for n in _LONG_NMS_N:
            xy = torch.rand((n, 2), generator=gen) * 1000
            wh = torch.rand((n, 2), generator=gen) * 90 + 10
            bx_c = torch.cat([xy, xy + wh], 1)
            sc_c = torch.rand(n, generator=gen)
            lab_c = torch.randint(0, 90, (n,), generator=gen)
            order = torch.sort(-sc_c, stable=True)[1]
            b1c, s1c = (bx_c[order][None].contiguous(),
                        sc_c[order][None].contiguous())
            b1, s1 = b1c.to(dev), s1c.to(dev)
            thr = -1e30
            keep = nms_keep_batch(b1, s1, _PUBLIC_NMS_IOU, thr)
            t0 = time.perf_counter()
            want = nms_keep_batch_plain(b1c, s1c, _PUBLIC_NMS_IOU, thr)
            plain_s = time.perf_counter() - t0
            record_err(("nms_keep_batch", "nms_keep_batch/public"),
                       keep.cpu(), want)
            check(torch.equal(keep.cpu(), want),
                  f"K1's {launch_shape(n)} launch at N = {n} != plain")
            nbytes, ops = nms_work(keep, s1, thr)
            bms, by = bound(nbytes, ops)
            k_t = timed(lambda: nms_keep_batch(b1, s1, _PUBLIC_NMS_IOU, thr),
                        10)
            public[f"random_N{n}"] = {
                "shape": [1, n], "launch": launch_shape(n), "ms": k_t["ms"],
                "plain_ms": plain_s * 1e3,
                "plain_ms_from": "host clock, the plain version on a CPU "
                                 "copy",
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "library": "none: no PyTorch call",
                "scratch_bytes": scratch_bytes(1, n),
                "bytes": nbytes, "ops": ops, "kept": int(keep.sum()),
                "event_ms": k_t["event_ms"], "ms_from": k_t["ms_from"]}
            long_cases[n] = (bx_c, sc_c, lab_c, order, want[0])
        bx_c, sc_c, lab_c, order, want = long_cases[max(_LONG_NMS_N)]
        on = tuple(t.to(dev).contiguous() for t in (bx_c, sc_c, lab_c))
        for fn in apis.values():   # warm-up, outside the count
            fn(*on)
        got = counted("public_nms_long", lambda: {
            api: fn(*on) for api, fn in apis.items()})
        check(launches["entry_points/public_nms_long"]["nms_keep_batch"]
              == len(apis), "public NMS at N = "
              f"{max(_LONG_NMS_N)}: launches "
              f"{launches['entry_points/public_nms_long']}, want K1 once "
              "per call")
        # nms_mask against the plain keep in the original order; nms
        # against the kept boxes by score, ties by index; batched_nms
        # against its plain twin on the CPU
        mask_want = torch.zeros_like(want).index_put_((order,), want)
        kept_scores = torch.where(mask_want, sc_c, torch.tensor(-1e30))
        top_sc, top_idx = torch.sort(kept_scores, descending=True,
                                     stable=True)
        nms_valid = top_sc[:300] > -5e29
        nms_want = (torch.where(nms_valid, top_idx[:300],
                                torch.zeros_like(top_idx[:300])), nms_valid)
        batched_want = apis["batched_nms"](bx_c, sc_c, lab_c)  # CPU: plain
        for api, w in (("nms_mask", (mask_want,)), ("nms", nms_want),
                       ("batched_nms", batched_want)):
            g = got[api] if isinstance(got[api], tuple) else (got[api],)
            for gi, wi in zip(g, w):
                record_err(("nms_keep_batch", "nms_keep_batch/public"),
                           gi.cpu().float(), wi.float())
                check(torch.equal(gi.cpu(), wi),
                      f"public {api} at N = {max(_LONG_NMS_N)}: != plain")
        public[f"random_N{max(_LONG_NMS_N)}"]["public_call_ms"] = {
            api: timed(lambda fn=fn: fn(*on), 3)["ms"]
            for api, fn in apis.items()}
        public_err = _MAX_ERR.get("nms_keep_batch/public", 0.0)
        lap("public_nms")

        # (d) eval_voc: ssd_lite_mobilenet_v2 from a .pth of seeded random
        # weights (calibrated BN, x5 class head, as in `families`)
        _, v2_cpu = family_detectors("ssd_lite_mobilenet_v2", seed=5)
        peak_class_head(v2_cpu)
        v2_pth = save_reference_pth(
            "ssd_lite_mobilenet_v2", jax_variables_of(v2_cpu.model),
            os.path.join(tmp, "v2.pth"))
        voc = os.path.join(tmp, "VOCdevkit")
        hw = (240, 320)
        paths, rects = write_jpegs(os.path.join(voc, "VOC2007", "JPEGImages"),
                                   _VOC_FRAMES, hw, seed=47)
        names = [os.path.basename(p)[:-4] for p in paths]
        rect_objs = [[(VOC_CLASSES[int(lab)], box) for box, lab, v in zip(
            *(r[i] for r in rects)) if v] for i in range(len(paths))]
        write_voc_annotations(os.path.join(voc, "VOC2007"), names,
                              rect_objs, hw)

        def run_voc(*extra):
            args = eval_voc_cli.get_args_parser().parse_args(
                ["--data-path", voc, "--torch-weights", v2_pth,
                 "--batch-size", str(_VOC_BATCH), *extra])
            t0 = time.perf_counter()
            ev, _ = logged(lambda: eval_voc_cli.main(args))
            return ev, time.perf_counter() - t0

        first, _ = run_voc()
        # the ground truth: the model's confident detections (up to 3 an
        # image, score > 0.5) beside the rectangles
        gt_objs = []
        for i, objs in enumerate(rect_objs):
            d = first._dets[i]
            top = np.argsort(-d["scores"], kind="stable")[:3]
            gt_objs.append(objs + [(VOC_CLASSES[int(d["labels"][j])],
                                    d["boxes"][j]) for j in top
                                   if d["scores"][j] > 0.5])
        write_voc_annotations(os.path.join(voc, "VOC2007"), names, gt_objs,
                              hw)
        cpu_ev, cpu_s = run_voc("--device", "cpu")
        results = os.path.join(tmp, "voc_results")
        card_ev, card_s = counted("eval_voc", lambda: run_voc(
            "--results-dir", results))
        c = launches["entry_points/eval_voc"]
        n_batches = -(-_VOC_FRAMES // _VOC_BATCH)
        check(c["nms_keep_batch"] == n_batches
              and c["gather_rows_batch"] == 2 * n_batches,
              f"eval_voc launched {c}: want 1 NMS and 2 gathers per batch")
        ap_diff = max(abs(card_ev.aps[k] - cpu_ev.aps[k]) for k in cpu_ev.aps)
        check(ap_diff <= 1e-3, f"eval_voc: the card's APs differ from the "
              f"CPU's by {ap_diff} (limit 1e-3)")
        check(cpu_ev.aps["mAP"] > 0.05, f"eval_voc: the CPU's mAP "
              f"{cpu_ev.aps['mAP']} finds none of its own detections")
        written = sorted(f for f in os.listdir(results)
                         if f.startswith("det_test_"))
        check(len(written) == 20, f"eval_voc wrote {written}")
        n_gt = sum(len(o) for o in gt_objs)
        lap("eval_voc")

        # (e) --pretrained: a cold cache raises, a warm one loads
        test_only = ("--dataset", "synthetic", "--synthetic-size",
                     str(_CLI_FRAMES), "--batch-size", str(_CLI_BATCH),
                     "--num-classes", "91", "--test-only", "--output-dir",
                     os.path.join(tmp, "cli"))
        parse = train_cli.get_args_parser().parse_args
        cache = os.path.join(tmp, "weights_cache")
        os.makedirs(cache)
        with weights_dir(cache):
            try:
                logged(lambda: train_cli.main(parse([*test_only,
                                                     "--pretrained"])))
                raised = "nothing"
            except FileNotFoundError as e:
                raised = str(e)
            check(PRETRAINED_URLS[_FLAGSHIP] in raised,
                  f"--pretrained on an empty cache raised {raised!r}")
            os.replace(pth, cached_weights_path(_FLAGSHIP))
            with cudnn_deterministic():
                warm, printed = counted(
                    "train_cli_pretrained", lambda: logged(
                        lambda: train_cli.main(parse([*test_only,
                                                      "--pretrained"]))))
        check(f"loaded pretrained weights for {_FLAGSHIP}" in printed,
              "--pretrained printed no 'loaded pretrained weights'")
        with cudnn_deterministic():
            npz, _ = logged(lambda: train_cli.main(parse(
                [*test_only, "--npz-weights", _NPZ])))
        check(np.array_equal(warm.stats, npz.stats),
              f"--pretrained summary {warm.stats.tolist()} != --npz-weights "
              f"{npz.stats.tolist()}")
        lap("pretrained")

        # (f) the native JPEG loader (host code)
        tools = native.toolchain()
        if tools["g++"] and tools["jpeglib.h"]:
            check(native.available(), f"the native library did not build: "
                  f"{native.build_error()}")
            img_dir, ann = write_coco_tree(os.path.join(tmp, "coco"),
                                           _NATIVE_FRAMES, _ENTRY_FRAME_HW,
                                           seed=53)
            ds = CocoDetection(img_dir, ann)
            loaded, secs = {}, {}
            for way in ("native", "python"):
                t0 = time.perf_counter()
                loaded[way] = list(DetectionLoader(
                    ds, _CLI_BATCH, (320, 320), prefetch=0,
                    native_decode=way == "native"))
                secs[way] = time.perf_counter() - t0
            pixel = 0.0
            for a, b in zip(loaded["native"], loaded["python"]):
                for k in ("original_sizes", "gt_labels", "gt_valid",
                          "image_ids", "batch_valid"):
                    check(np.array_equal(a[k], b[k]),
                          f"native loader: {k} differs")
                check(np.allclose(a["gt_boxes"], b["gt_boxes"], rtol=0,
                                  atol=1e-4),
                      "native loader: gt_boxes differ")
                pixel = max(pixel, float(np.abs(a["images"]
                                                - b["images"]).max()))
            native_line = {
                "toolchain": tools, "built": native.library_path()[
                    len(_HERE) + 1:],
                "frames": _NATIVE_FRAMES, "frame_hw": list(_ENTRY_FRAME_HW),
                "seconds_per_64_frames": {
                    w: s * 64 / _NATIVE_FRAMES for w, s in secs.items()},
                "sizes_and_targets_equal": True,
                "max_pixel_diff_libjpeg_vs_pil_cv2": pixel}
        else:
            native_line = {"toolchain": tools, "skipped": (
                "the native JPEG library cannot be built here: "
                + ("no g++" if not tools["g++"] else "no <jpeglib.h>")
                + "; the loader's native_decode is optional, as in the "
                "JAX package")}
            print(f"entry_points: native decode not run: "
                  f"{native_line['skipped']}", flush=True)

    lap("native_decode")
    emit({"phase": "entry_points", "seconds": time.perf_counter() - t0_phase,
          "split_seconds": split,
          "hub_pth_roundtrip": {"batches": len(batches),
                                "bit_equal_to_npz_model": True,
                                "launches": launches["entry_points/hub_pth"]},
          "predict_cli": {
              "frames": _ENTRY_FRAMES, "frame_hw": list(_ENTRY_FRAME_HW),
              "detections_above_0.5": n_dets,
              "fused_equals_reference": True,
              "max_box_diff_fused_vs_reference": box_diff,
              **{mode: {**{k: v for k, v in o.items()
                           if k != "detections"},
                        "launches": launches[f"entry_points/predict_cli_{mode}"],
                        "launches_per_image": {
                            k: v / _ENTRY_FRAMES for k, v in launches[
                                f"entry_points/predict_cli_{mode}"].items()}}
                 for mode, o in cli_out.items()}},
          "public_nms": {"iou": _PUBLIC_NMS_IOU, "apis": sorted(apis),
                         "cases": sorted(cases), "bit_equal": True,
                         "max_abs_err": public_err,
                         "launches": launches["entry_points/public_nms"],
                         "k1_alone": public},
          "eval_voc": {
              "frames": _VOC_FRAMES, "batch": _VOC_BATCH, "frame_hw": list(hw),
              "weights": "ssd_lite_mobilenet_v2, seeded random (calibrated "
                         "BN, x5 class head), as a reference .pth",
              "gt_objects": n_gt, "card_map": card_ev.aps["mAP"],
              "cpu_map": cpu_ev.aps["mAP"], "max_ap_diff": ap_diff,
              "card_seconds": card_s, "card_img_per_s": _VOC_FRAMES / card_s,
              "cpu_seconds": cpu_s, "launches": c,
              "results_files": len(written)},
          "pretrained": {"cold_cache_raises": raised[:160],
                         "warm_summary_equal_to_npz_weights": True,
                         "launches": launches[
                             "entry_points/train_cli_pretrained"]},
          "native_decode": native_line})
    return {"launches_by_path": launches, "public_nms": public,
            "public_nms_err": public_err}


# -- bf16 compute and remat ----------------------------------------------------
# a bf16 model's head outputs against the CPU's bf16 model and against the
# card's float32 model: the largest difference in bf16 ulps of the
# output's scale, ulp(s) = 2^(floor(log2 s) - 7). The CPU tests hold the
# port's bf16 models within 1-2 ulps of the JAX package's, as far as the
# JAX bf16 model is from its float32 twin; the trained flagship at 320 is
# deeper, and cuDNN's bf16 convs sum in their own orders
_BF16_HEAD_ULPS_CPU = 8
_BF16_HEAD_ULPS_FP32 = 16
# bf16 train loss terms, card against CPU, one step at B = 4 from the
# trained weights: relative, 2.5 bf16 ulps (the CPU tests find two bf16
# steps 0.2-0.5 % apart in their loss terms at B = 4)
_BF16_LOSS_RTOL = 2e-2
_BF16_MODES = {"reference": {}, "fused": {"impl": "fused"},
               "sparse_topk": {"topk_impl": "sparse_pallas"}}
# (batch, closed-loop batches) of the flagship's and the families' bf16
# serving
_BF16_E2E = ((32, 10), (128, 6))
_BF16_FAMILY_E2E = ((32, 3), (128, 2))


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of max |want|."""
    import math

    g, w = got.float().cpu(), want.float().cpu()
    scale = float(w.abs().max())
    return float((g - w).abs().max()) / 2.0 ** (
        math.floor(math.log2(scale)) - 7)


def step_timing(det, batch, iters, remat=False, lr=_TRAIN_LR):
    """Closed-loop train steps from a fresh SGD state on the card: ms per
    step (median, q1-q3), img/s, peak memory from before the first step,
    the forward/loss/backward/optimizer split by CUDA events (median of
    3), the last loss (finite, or fail); every timed step under
    sync_errors."""
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step

    bs = int(batch["images"].shape[0])
    state = create_train_state(det, make_optimizer(
        lr, _TRAIN_MOMENTUM, _TRAIN_WD))
    step = make_train_step(det, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    per_step = []
    for _ in range(iters):
        t0 = time.perf_counter()
        with sync_errors():
            state, m = step(state, batch)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
    split = {p: [] for p in _TRAIN_PHASES}
    for _ in range(3):
        marks = {"start": torch.cuda.Event(enable_timing=True)}

        def on_phase(name, marks=marks):
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()

        marks["start"].record()
        with sync_errors():
            state, m = step(state, batch, on_phase=on_phase)
        torch.cuda.synchronize()
        prev = "start"
        for p in _TRAIN_PHASES:
            split[p].append(marks[prev].elapsed_time(marks[p]))
            prev = p
    loss = float(m["loss"])
    check(np.isfinite(loss), f"train step (batch {bs}, remat {remat}): "
          f"loss {loss}")
    q1, med, q3 = np.percentile(per_step, [25, 50, 75])
    return {"batch": bs, "remat": remat, "lr": lr, "ms_per_step_median": med,
            "ms_per_step_q1_q3": [q1, q3], "n": iters,
            "img_per_s": bs / med * 1e3,
            "split_ms_median": {p: float(np.median(v))
                                for p, v in split.items()},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "last_loss": loss, "step": step, "state": state}


def bf16_serving(trained, batches, sizes, reset_counts, read_counts):
    """The flagship in bf16 from the trained npz: no quiet float32 (the
    head outputs and a hooked trunk conv's input and output are bf16);
    4 requests of 32 per serving mode, counts reset before and read
    after, as in float32; each mode's detections equal to the reference
    postprocess's on the same bf16 head outputs; K1, K2 and K3 bit-equal
    to their plain versions on the bf16 path's inputs; the card's bf16
    heads against the CPU's bf16 model and the card's float32 one;
    forward and postprocess ms and closed-loop img/s at b32 and b128 in
    both dtypes, and a trace of a bf16 b128 batch. Returns the counts by
    path."""
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models import detection
    from demonet_tpu_torch.models.detection import (
        _NEG_INF,
        postprocess_detections,
        preprocess,
    )
    from demonet_tpu_torch.ops.gather import (
        gather_rows_batch,
        gather_rows_batch_plain,
    )
    from demonet_tpu_torch.ops.nms import (
        nms_keep_batch,
        nms_keep_batch_plain,
    )
    from demonet_tpu_torch.ops.topk import topk_sparse, topk_sparse_plain

    t0_phase = time.perf_counter()
    bf16 = torch.bfloat16
    det = trained_detector("cuda", dtype=bf16)
    cfg, b = det.config, batches[0].shape[0]
    anchors = torch.as_tensor(det.anchors, device="cuda")
    branches = detection._postprocess_fused.branches
    conv = det.model.extractor.trunk.blocks[5].expand_conv.conv
    seen = []
    hook = conv.register_forward_hook(
        lambda m, args, out: seen.append((args[0].dtype, out.dtype)))
    with torch.inference_mode():
        out16 = det.model(preprocess(batches[0], cfg, resize=False))
        out32 = trained.model(preprocess(batches[0], cfg, resize=False))
    hook.remove()
    check(det.dtype == bf16 and seen == [(bf16, bf16)]
          and all(out16[k].dtype == bf16 for k in out16),
          f"the bf16 model ran {seen}, heads "
          f"{[out16[k].dtype for k in out16]}: not bf16")

    # -- the three modes, counted ----------------------------------------
    launches, paths = {}, {}
    want_counts = {mode: {"nms_keep_batch": 4, "gather_rows_batch": 8,
                          "topk_sparse": 4 if mode == "sparse_topk" else 0,
                          "fused_inverted_residual": 0,
                          "topk_sparse_long": 0} for mode in _BF16_MODES}
    for mode, kw in _BF16_MODES.items():
        step = make_predict_step(det, **kw)
        step(det.model, batches[0], sizes)
        torch.cuda.synchronize()
        reset_counts()
        dets, taken = [], []
        for x in batches:
            before = dict(branches)
            dets.append(step(det.model, x, sizes))
            taken.extend(k for k in branches
                         if branches[k] != before.get(k, 0))
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == want_counts[mode]
              and (mode != "fused" or len(taken) == len(batches)),
              f"bf16 {mode}: launches {counts}, want {want_counts[mode]} as "
              f"in float32; branches {taken}")
        launches[f"bf16/flagship/{mode}"] = counts
        worst_box = 0.0
        for x, d in zip(batches, dets):
            check(d["boxes"].dtype == torch.float32
                  and bool(torch.isfinite(d["boxes"]).all()),
                  f"bf16 {mode}: detections")
            with torch.inference_mode():
                o = det.model(preprocess(x, cfg, resize=False))
                args = (o["cls_logits"], o["bbox_regression"], anchors, cfg,
                        sizes)
                ref = postprocess_detections(*args)
                got = postprocess_detections(*args, **kw)
            for key in ("valid", "scores", "labels"):
                check(torch.equal(got[key], ref[key]),
                      f"bf16 {mode}: {key} != the reference postprocess's")
            worst_box = max(worst_box, float(
                (got["boxes"] - ref["boxes"]).abs().max()))
        check(worst_box <= 1e-4, f"bf16 {mode}: boxes differ by {worst_box}")
        paths[mode] = {"launches": counts,
                       "valid_detections": [int(d["valid"].sum())
                                            for d in dets],
                       "max_box_diff_vs_reference": worst_box,
                       **({"branches": taken} if mode == "fused" else {})}

    # -- the kernels on the bf16 path's inputs (float32 after the cast) ---
    thr = _NEG_INF / 2
    with torch.inference_mode():
        cand = head_to_candidates(det, out16)
    nb, ns = cand["cand_boxes"], cand["cand_sc"]
    check(nb.dtype == ns.dtype == torch.float32,
          "the postprocess did not cast to float32")
    keep = nms_keep_batch(nb, ns, cfg.nms_thresh, thr)
    p_keep = nms_keep_batch_plain(nb, ns, cfg.nms_thresh, thr)
    final_idx = torch.sort(ns.reshape(b, -1), dim=-1, descending=True,
                           stable=True)[1][:, :cfg.detections_per_img]
    g_cases = {"candidate": (cand["boxes"].contiguous(), cand["top_idx"]),
               "final": (nb.reshape(b, -1, 4).contiguous(),
                         final_idx.to(torch.int32).contiguous())}
    g_out = {n: (gather_rows_batch(t, i), gather_rows_batch_plain(t, i))
             for n, (t, i) in g_cases.items()}
    rows = cand["fg"].reshape(-1, anchors.shape[0])
    k_sc, k_idx = topk_sparse(rows, _TOPK_K, cfg.score_thresh, _TOPK_SLOTS)
    p_sc, p_idx = topk_sparse_plain(rows, _TOPK_K, cfg.score_thresh)
    torch.cuda.synchronize()
    record_err(("nms_keep_batch", "nms_keep_batch/bf16"), keep, p_keep)
    check(torch.equal(keep, p_keep), "bf16 path: K1 != plain")
    for n, (got, want) in g_out.items():
        record_err(("gather_rows_batch", "gather_rows_batch/bf16"), got, want)
        check(torch.equal(got, want), f"bf16 path: K2 != plain ({n})")
    record_err(("topk_sparse", "topk_sparse/bf16"), k_sc, p_sc)
    check(torch.equal(k_sc, p_sc) and torch.equal(k_idx, p_idx),
          "bf16 path: K3 != plain")

    # -- the card's bf16 heads against the CPU's and the card's float32 ---
    cpu = trained_detector("cpu", dtype=bf16)
    with torch.inference_mode():
        ref = cpu.model(preprocess(batches[0][:2].cpu(), cpu.config,
                                   resize=False))
    vs_cpu = {k: bf16_ulps(out16[k][:2], ref[k]) for k in ref}
    vs_fp32 = {k: bf16_ulps(out16[k], out32[k]) for k in ref}
    check(all(e <= _BF16_HEAD_ULPS_CPU for e in vs_cpu.values())
          and all(e <= _BF16_HEAD_ULPS_FP32 for e in vs_fp32.values()),
          f"bf16 heads: {vs_cpu} ulps from the CPU's (limit "
          f"{_BF16_HEAD_ULPS_CPU}), {vs_fp32} from float32 (limit "
          f"{_BF16_HEAD_ULPS_FP32})")
    del cpu, ref

    # -- time: both dtypes, each mode ---------------------------------------
    e2e = {}
    for bs, iters in _BF16_E2E:
        x = torch.from_numpy(shapes_images(np.random.default_rng(bs),
                                           bs)[0]).cuda()
        sz = torch.tensor([[480, 640]] * bs, dtype=torch.int32,
                          device="cuda")
        with torch.inference_mode():
            fwd = {name: cuda_ms(lambda m=m: m.model(preprocess(
                x, cfg, resize=False)), 5)
                for name, m in (("fp32", trained), ("bf16", det))}
            o = det.model(preprocess(x, cfg, resize=False))
        for mode, kw in _BF16_MODES.items():
            step = make_predict_step(det, **kw)
            for _ in range(2):
                step(det.model, x, sz)
            torch.cuda.synchronize()
            per_batch = []
            for _ in range(iters):
                t0 = time.perf_counter()
                step(det.model, x, sz)
                torch.cuda.synchronize()
                per_batch.append((time.perf_counter() - t0) * 1e3)
            q1, med, q3 = np.percentile(per_batch, [25, 50, 75])
            with torch.inference_mode():
                post_ms = cuda_ms(lambda: postprocess_detections(
                    o["cls_logits"], o["bbox_regression"], anchors, cfg, sz,
                    **kw), 5)
            e2e[f"{mode}_b{bs}"] = {
                "img_per_s": bs / med * 1e3, "ms_per_batch_median": med,
                "ms_per_batch_q1_q3": [q1, q3], "n": iters,
                "forward_ms": fwd["bf16"], "forward_ms_fp32": fwd["fp32"],
                "postprocess_ms": post_ms}
        if bs == 128:
            trace = trace_calls(lambda: make_predict_step(det)(
                det.model, x, sz))
    emit({"phase": "bf16_serving", "weights": "trained npz, bf16 compute",
          "conv_dtypes_seen": [str(t) for t in seen[0]],
          "head_dtypes": {k: str(v.dtype) for k, v in out16.items()},
          "paths": paths,
          "kernels_vs_plain_on_bf16_inputs": "bit-equal (K1 K = 300, K2 "
                                             "candidate and final, K3)",
          "head_ulps_vs_cpu_bf16": vs_cpu,
          "head_ulps_vs_card_fp32": vs_fp32,
          "head_limits_ulps": {"cpu": _BF16_HEAD_ULPS_CPU,
                               "fp32": _BF16_HEAD_ULPS_FP32},
          "e2e": e2e,
          "trace_reference_b128": {
              "wall_ms": trace["wall_ms"],
              "device_busy_ms": trace["device_busy_ms"],
              "device_idle_share": trace["device_idle_share"],
              "top_kernels_ms": trace["top_kernels_ms"]},
          "seconds": time.perf_counter() - t0_phase})
    return launches


def bf16_training():
    """The flagship's bf16 train step from the trained npz: closed-loop
    ms per step, peak memory and split at b32 and b128, and a trace at
    b128; the loss terms of one step at B = 4 on the card and on the CPU
    (bf16 both); then remat at b128: ms per step and peak memory with and
    without it, and under cuDNN's deterministic algorithms two steps with
    it bit-equal to two without (metrics, every parameter and BN
    statistic), the statistics moved by the steps."""
    import torch

    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step

    t0_phase = time.perf_counter()
    bf16 = torch.bfloat16
    timing = {}
    for bs, iters in ((32, 5), (128, 3)):
        det = trained_detector("cuda", dtype=bf16)
        r = step_timing(det, train_batch(1000 + bs, bs, "cuda"), iters)
        if bs == 128:
            b128 = train_batch(1128, 128, "cuda")
            tr = trace_calls(lambda: r["step"](r["state"], b128), 2)
        timing[f"b{bs}"] = {k: v for k, v in r.items()
                            if k not in ("step", "state")}
        del det, r
    terms = {}
    for where in ("cuda", "cpu"):
        d = trained_detector(where, dtype=bf16)
        st = create_train_state(d, make_optimizer(
            _TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD))
        _, m = make_train_step(d)(st, train_batch(2, 4, where))
        terms[where] = {k: float(v) for k, v in m.items()}
    rel = {k: abs(terms["cuda"][k] - terms["cpu"][k]) / abs(terms["cpu"][k])
           for k in terms["cpu"]}
    check(max(rel.values()) <= _BF16_LOSS_RTOL,
          f"bf16 loss terms, card against CPU at B = 4: {terms}")

    # -- remat at b128 -------------------------------------------------------
    remat_timing = {}
    for remat in (False, True):
        det = trained_detector("cuda", dtype=bf16)
        r = step_timing(det, train_batch(1128, 128, "cuda"), 3, remat=remat)
        remat_timing["remat" if remat else "plain"] = {
            k: v for k, v in r.items() if k not in ("step", "state")}
        del det, r
    runs = {}
    batch = train_batch(7128, 128, "cuda")
    for remat in (False, True):
        det = trained_detector("cuda", dtype=bf16)
        before = {n: b.clone() for n, b in det.model.named_buffers()
                  if "running" in n}
        state = create_train_state(det, make_optimizer(
            _TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD))
        step = make_train_step(det, remat=remat)
        metrics = []
        with cudnn_deterministic():
            for _ in range(2):
                state, m = step(state, batch)
                metrics.append({k: v.clone() for k, v in m.items()})
        torch.cuda.synchronize()
        runs[remat] = {"metrics": metrics, "before": before,
                       "state": {n: v.clone() for n, v in
                                 det.model.state_dict().items()}}
        del det, state, step
    plain, rem = runs[False], runs[True]
    metrics_equal = all(torch.equal(a[k], b[k]) for a, b in
                        zip(plain["metrics"], rem["metrics"]) for k in a)
    differ = [n for n, v in rem["state"].items()
              if not torch.equal(v, plain["state"][n])]
    moved = all(not torch.equal(rem["state"][n], v)
                for n, v in rem["before"].items())
    check(metrics_equal and not differ and moved,
          f"remat at b128: metrics equal {metrics_equal}, entries that "
          f"differ {differ[:5]} ({len(differ)}), statistics moved {moved}")
    emit({"phase": "bf16_train", "weights": "trained npz, bf16 compute",
          "lr": _TRAIN_LR, "timing": timing,
          "trace_b128": {"wall_ms": tr["wall_ms"],
                         "device_busy_ms": tr["device_busy_ms"],
                         "device_idle_share": tr["device_idle_share"],
                         "top_kernels_ms": tr["top_kernels_ms"]},
          "loss_card_b4": terms["cuda"], "loss_cpu_b4": terms["cpu"],
          "loss_rel_err": rel, "loss_rtol": _BF16_LOSS_RTOL,
          "remat_b128": remat_timing,
          "remat_vs_plain_2_steps": {
              "cudnn_deterministic": True, "metrics_equal": metrics_equal,
              "state_entries_equal": len(rem["state"]) - len(differ),
              "state_entries": len(rem["state"]),
              "running_statistics_moved": moved,
              "losses": [{k: float(v) for k, v in m.items()}
                         for m in rem["metrics"]]},
          "seconds": time.perf_counter() - t0_phase})
    return timing


def bf16_families(reset_counts, read_counts):
    """The four other families in bf16, each from family_detectors' seeded
    (calibrated) weights with its class head scaled, switched to bf16
    compute: one counted request of 32 per mode (K1, K2, K3 in its launch
    by A), detections equal to the reference postprocess's on the same
    bf16 head outputs; forward ms in float32 and bf16 and closed-loop
    img/s at b32 and b128 per mode; VGG's top device kernels in a bf16
    forward; one train step each (bf16, its family's batch and rate):
    ms, peak memory, a finite loss. Returns the counts by path."""
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models.builders import get_model
    from demonet_tpu_torch.models.detection import (
        postprocess_detections,
        preprocess,
    )
    from demonet_tpu_torch.models.layers import set_compute_dtype
    from demonet_tpu_torch.ops.topk import MAX_ROW

    bf16 = torch.bfloat16
    launches = {}
    for fi, name in enumerate(_FAMILIES):
        t0_phase = time.perf_counter()
        det, cpu = family_detectors(name)
        del cpu
        peak_class_head(det)
        cfg, size = det.config, det.config.size[0]
        anchors = torch.as_tensor(det.anchors, device="cuda")
        long_rows = anchors.shape[0] > MAX_ROW
        rng = np.random.default_rng(300 + fi)
        x = torch.from_numpy(shapes_images(rng, _FAMILY_BATCH, size)[0]).cuda()
        sizes = torch.tensor([[480, 640]] * _FAMILY_BATCH, dtype=torch.int32,
                             device="cuda")
        set_compute_dtype(det.model, bf16)
        paths = {}
        for mode, kw in _FAMILY_MODES.items():
            step = make_predict_step(det, **kw)
            step(det.model, x, sizes)
            torch.cuda.synchronize()
            reset_counts()
            d = step(det.model, x, sizes)
            torch.cuda.synchronize()
            counts = read_counts()
            sparse = mode == "sparse_topk"
            want = {"nms_keep_batch": 1, "gather_rows_batch": 2,
                    "topk_sparse": 1 if sparse else 0,
                    "fused_inverted_residual": 0,
                    "topk_sparse_long": 1 if sparse and long_rows else 0}
            check(counts == want, f"bf16 {name} {mode}: launches {counts}, "
                  f"want {want}")
            launches[f"bf16/{name}/{mode}"] = counts
            with torch.inference_mode():
                o = det.model(preprocess(x, cfg, resize=False))
                args = (o["cls_logits"], o["bbox_regression"], anchors, cfg,
                        sizes)
                ref = postprocess_detections(*args)
                got = postprocess_detections(*args, **kw)
            check(o["cls_logits"].dtype == bf16
                  and all(torch.equal(got[k], ref[k]) for k in ref),
                  f"bf16 {name} {mode}: heads {o['cls_logits'].dtype}, or "
                  "detections != the reference postprocess's")
            paths[mode] = {"launches": counts,
                           "valid_detections": int(d["valid"].sum())}
        e2e, top = {}, None
        for bs, iters in _BF16_FAMILY_E2E:
            xb = torch.from_numpy(shapes_images(np.random.default_rng(bs),
                                                bs, size)[0]).cuda()
            sz = torch.tensor([[480, 640]] * bs, dtype=torch.int32,
                              device="cuda")
            fwd = {}
            for dt, key in ((torch.float32, "fp32"), (bf16, "bf16")):
                set_compute_dtype(det.model, dt)
                with torch.inference_mode():
                    fwd[key] = cuda_ms(lambda: det.model(preprocess(
                        xb, cfg, resize=False)), 2, 1)
            if "vgg" in name and bs == 32:
                with torch.inference_mode():
                    top = trace_calls(lambda: det.model(preprocess(
                        xb, cfg, resize=False)), 2)["top_kernels_ms"][:5]
            for mode, kw in _FAMILY_MODES.items():
                step = make_predict_step(det, **kw)
                step(det.model, xb, sz)
                torch.cuda.synchronize()
                per_batch = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    step(det.model, xb, sz)
                    torch.cuda.synchronize()
                    per_batch.append((time.perf_counter() - t0) * 1e3)
                med = float(np.median(per_batch))
                e2e[f"{mode}_b{bs}"] = {"img_per_s": bs / med * 1e3,
                                        "ms_per_batch_median": med,
                                        "n": iters}
            e2e[f"forward_ms_b{bs}"] = fwd
            del xb
        del det
        torch.cuda.empty_cache()
        tdet = get_model(name, seed=0, dtype=bf16)
        bs = _FAMILY_TRAIN_BATCH[name]
        r = step_timing(tdet, family_batch(5000, bs, size, "cuda"), 3,
                        lr=_FAMILY_TRAIN_LR[name])
        train = {k: v for k, v in r.items() if k not in ("step", "state")}
        del tdet, r
        torch.cuda.empty_cache()
        emit({"phase": "bf16_families", "model": name, "size": [size, size],
              "weights": "seeded random (family_detectors), bf16 compute",
              "paths": paths, "e2e": e2e,
              **({"top_kernels_bf16_forward_b32_ms": top} if top else {}),
              "train": train, "seconds": time.perf_counter() - t0_phase})
    return launches


def bf16_cli():
    """The train CLI with --bf16 from the trained npz on 64 synthetic
    frames at b32: an epoch with a checkpoint and its evaluation, then
    --test-only --resume of that checkpoint with --bf16 (the same COCO
    summary) and without it (the float32 checkpoint in a float32 model:
    a finite summary); the printing goes to cli_synthetic.log."""
    import tempfile

    import numpy as np

    from demonet_tpu_torch import train as cli

    t0_phase = time.perf_counter()

    def run(*argv):
        args = cli.get_args_parser().parse_args([*_CLI_ARGS, *argv])
        with cudnn_deterministic(), open(_CLI_LOG, "a") as log, \
                contextlib.redirect_stdout(log):
            print(f"== {' '.join(argv)}", flush=True)
            t0 = time.perf_counter()
            ev = cli.main(args)
        check(ev is not None and bool(np.isfinite(ev.stats).all()),
              f"CLI {argv}: no finite COCO summary")
        return [float(v) for v in ev.stats], time.perf_counter() - t0

    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        out = os.path.join(tmp, "bf16")
        trained, t_train = run("--bf16", "--epochs", "1", "--output-dir",
                               out)
        ckpt = os.path.join(out, "checkpoint_0")
        resumed16, t16 = run("--bf16", "--test-only", "--resume", ckpt)
        resumed32, t32 = run("--test-only", "--resume", ckpt)
    check(resumed16 == trained,
          f"--bf16 --test-only --resume: {resumed16} != {trained}")
    emit({"phase": "bf16_cli", "frames": _CLI_FRAMES, "batch": _CLI_BATCH,
          "trained_bf16_summary": trained,
          "resumed_bf16_summary": resumed16,
          "resumed_fp32_summary": resumed32,
          "seconds_train_and_eval": t_train,
          "seconds_eval": {"bf16": t16, "fp32": t32},
          "seconds": time.perf_counter() - t0_phase})


# -- data parallelism: torch.distributed ---------------------------------------
# one b32 batch of the training frames, 16 rows a rank at world 2
_DIST_ROWS, _DIST_SEED = 16, 5000
# the sharded evaluation: the train CLI's synthetic frames, 32 a batch
_DIST_FRAMES, _DIST_EVAL_BATCH = 64, 32
_DIST_TIMED_STEPS = 3
# any collective of the phase raises after this long; a rank process that
# outlives _DIST_JOIN_S is killed and fails the phase
_DIST_TIMEOUT_S, _DIST_JOIN_S = 120.0, 300.0
_DIST_AP_ATOL = 1e-3
_DIST_LOG = os.path.join(_HERE, "chiprun_out", "distributed.log")
_SUMMARY_LINE = r"^ Average (Precision|Recall) .* = -?\d+\.\d+$"


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target, args_by_rank):
    """target(*args) in one spawned process per entry of args_by_rank,
    each joined within _DIST_JOIN_S and killed after it; their exit
    codes (None for one that was killed)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_by_rank]
    for p in procs:
        p.start()
    deadline = time.monotonic() + _DIST_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    codes = [None if p.is_alive() else p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    return codes


def _probe_rank(rank, port, out_path):
    """One of two ranks on the one card (both on cuda:0) asking NCCL for
    a group and one all-reduce; writes {'ok', 'error'} and leaves without
    tearing the group down (a failed communicator may not come apart)."""
    os.environ["LOCAL_RANK"] = "0"
    import torch
    import torch.distributed as dist

    from demonet_tpu_torch.parallel import initialize

    out = {"rank": rank}
    try:
        initialize(f"tcp://localhost:{port}", 2, rank, backend="nccl",
                   timeout_s=60.0)
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        out["ok"] = float(t) == 2.0
    except Exception as e:  # the probe's answer: recorded, not raised
        out.update(ok=False, error=f"{type(e).__name__}: {str(e)[:400]}")
    with open(out_path, "w") as f:
        json.dump(out, f)
    sys.stdout.flush()
    os._exit(0)


def step_ms(step, state, rows, n):
    """Median ms of n closed-loop steps, each synchronised (after one
    untimed step)."""
    import numpy as np
    import torch

    times = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def bucket_all_reduce(model, n=10):
    """The train step's gradient bucket alone (every parameter and the two
    loss terms, float32) through one SUM all-reduce: median ms of n
    calls, and its bytes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    params = list(model.parameters())
    flat = torch.zeros(sum(p.numel() for p in params) + 2,
                       device=params[0].device)
    times = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": float(np.median(times[1:])),
            "bytes": flat.numel() * flat.element_size()}


def _dist_rank(rank, backend, port, out_path, log_path):
    """One of two ranks on the one card: two mesh steps on its 16 rows of
    the b32 batch (metrics, and the state after step 2 on the host),
    timed steps and the gradient bucket's all-reduce, and a sharded
    evaluation of the trained weights over its shard of the synthetic
    frames in the sparse top-k mode, with K1, K2 and K3 counted."""
    os.environ["LOCAL_RANK"] = "0"
    import torch
    import torch.distributed as dist

    from demonet_tpu_torch.data.coco_eval import CocoEvaluator
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.data.presets import DetectionPresetEval
    from demonet_tpu_torch.data.synthetic import SyntheticDetection
    from demonet_tpu_torch.engine.evaluate import evaluate, make_predict_step
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step
    from demonet_tpu_torch.ops.gather import gather_rows_batch
    from demonet_tpu_torch.ops.nms import nms_keep_batch
    from demonet_tpu_torch.ops.topk import topk_sparse
    from demonet_tpu_torch.parallel import data_mesh, initialize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"tcp://localhost:{port}", 2, rank, backend=backend,
               timeout_s=_DIST_TIMEOUT_S)
    try:
        mesh = data_mesh([torch.device("cuda", 0)])
        det = trained_detector("cuda")
        state = create_train_state(det, make_optimizer(
            _TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD))
        step = make_train_step(det, mesh=mesh)
        full = train_batch(_DIST_SEED, 2 * _DIST_ROWS, "cuda")
        rows = {k: v[rank * _DIST_ROWS:(rank + 1) * _DIST_ROWS].contiguous()
                for k, v in full.items()}
        metrics = []
        for _ in range(2):
            state, m = step(state, rows)
            metrics.append({k: float(v) for k, v in m.items()})
        after = {k: v.to("cpu", copy=True)
                 for k, v in det.model.state_dict().items()}
        timed_ms = step_ms(step, state, rows, _DIST_TIMED_STEPS)
        bucket = bucket_all_reduce(det.model)

        ev_det = trained_detector("cuda")
        ds = SyntheticDetection(n=_DIST_FRAMES, num_classes=7, seed=1,
                                transforms=DetectionPresetEval())
        loader = DetectionLoader(ds, _DIST_EVAL_BATCH, image_size=(320, 320),
                                 num_shards=2, shard_index=rank)
        kernels = (nms_keep_batch, gather_rows_batch, topk_sparse)
        for fn in kernels:
            fn.launches = 0
        topk_sparse.long_launches = 0
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            ev = evaluate(make_predict_step(ev_det, mesh=mesh,
                                            topk_impl="sparse"),
                          ev_det.model, loader,
                          CocoEvaluator(ds.ground_truth_for_eval()),
                          mesh=mesh)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in kernels}
        counts["topk_sparse_long"] = topk_sparse.long_launches
        torch.save({"backend": dist.get_backend(), "metrics": metrics,
                    "state": after, "step_ms": timed_ms, "bucket": bucket,
                    "eval_stats": [float(v) for v in ev.stats],
                    "merged_images": sorted(ev.detections),
                    "launches": counts}, out_path)
    finally:
        dist.destroy_process_group()


def summary_lines(text):
    """The COCO summary lines a CLI printed."""
    import re

    return [m.group(0)
            for m in re.finditer(_SUMMARY_LINE, text, re.MULTILINE)]


def distributed(trained, batches, sizes, reset_counts, read_counts):
    """distributed: the data-parallel mesh on the card.

    1. World size 1 over NCCL in this process: two mesh steps at b32 bit-
       equal to two steps without a mesh (cuDNN deterministic); the mesh
       predict step's detections bit-equal to the plain step's in the
       reference and sparse top-k modes, K1/K2/K3 counted; ms per step at
       a local batch of 16, with and without the mesh in turns, a trace
       of each, and the gradient bucket's all-reduce.
    2. Two processes on the one card: NCCL is asked first (a probe pair);
       where it refuses two ranks on one device, the ranks join over gloo
       with CUDA tensors (copied through the host). Each rank takes 16 of
       the b32 batch's rows: after 2 steps the loss terms within 1e-4
       relative and every state entry within 2e-3 absolute of the
       single-process b32 steps, the ranks' states bit-equal; a sharded
       evaluate over 64 synthetic frames holds every image once and its
       COCO AP is within 1e-3 of the single-process evaluation; K1, K2,
       K3 counted on each rank.
    3. The train CLI under `torch.distributed.run --nproc_per_node 1`
       (NCCL): an epoch, then --test-only --resume to the same summary.

    Returns the launch counts by path."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from demonet_tpu_torch.data.coco_eval import CocoEvaluator
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.data.presets import DetectionPresetEval
    from demonet_tpu_torch.data.synthetic import SyntheticDetection
    from demonet_tpu_torch.engine.evaluate import evaluate, make_predict_step
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step
    from demonet_tpu_torch.parallel import data_mesh, initialize

    t0_phase = time.perf_counter()
    launches = {}

    def fresh_state(mesh=None):
        det = trained_detector("cuda")
        state = create_train_state(det, make_optimizer(
            _TRAIN_LR, _TRAIN_MOMENTUM, _TRAIN_WD))
        return det, state, make_train_step(det, mesh=mesh)

    def two_steps(batch, mesh=None):
        det, state, step = fresh_state(mesh)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        return metrics, det.model.state_dict()

    # -- 1. world size 1 over NCCL, in this process ---------------------------
    batch = train_batch(_DIST_SEED, 2 * _DIST_ROWS, "cuda")
    local16 = {k: v[:_DIST_ROWS].contiguous() for k, v in batch.items()}
    initialize(f"tcp://localhost:{free_port()}", 1, 0, backend="nccl",
               timeout_s=_DIST_TIMEOUT_S)
    try:
        mesh = data_mesh()
        backend_w1 = dist.get_backend()
        check(backend_w1 == "nccl" and mesh.group is not None
              and mesh.world_size == 1, f"world 1: {backend_w1}, {mesh}")
        with cudnn_deterministic():
            plain_m, plain_s = two_steps(batch)
            mesh_m, mesh_s = two_steps(batch, mesh)
        differ = [n for n, v in plain_s.items()
                  if not torch.equal(v, mesh_s[n])]
        same_metrics = all(torch.equal(a[k], b[k])
                           for a, b in zip(plain_m, mesh_m) for k in a)
        check(same_metrics and not differ,
              f"world-1 NCCL mesh steps != plain steps: metrics equal "
              f"{same_metrics}, {len(differ)} state entries differ, e.g. "
              f"{differ[:3]}")
        # the mesh step against the plain one at the same 16 rows, in
        # turns (plain, mesh, plain), and a trace of each
        det, state, step = fresh_state(mesh)
        _, p_state, p_step = fresh_state()
        plain_ms = [step_ms(p_step, p_state, local16, _DIST_TIMED_STEPS)]
        step_ms_w1 = step_ms(step, state, local16, _DIST_TIMED_STEPS)
        plain_ms.append(step_ms(p_step, p_state, local16, _DIST_TIMED_STEPS))
        traces_w1 = {}
        for name, (fn, st) in (("mesh", (step, state)),
                               ("plain", (p_step, p_state))):
            tr = trace_calls(lambda: fn(st, local16))
            traces_w1[name] = {k: tr[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share")}
        bucket_w1 = bucket_all_reduce(det.model)
        del det, state, step, p_state, p_step
        predict_w1 = {}
        for mode, kw, k3 in (("reference", {}, 0),
                             ("sparse_topk", {"topk_impl": "sparse"}, 1)):
            want = [make_predict_step(trained, **kw)(trained.model, x, sizes)
                    for x in batches]
            mesh_step = make_predict_step(trained, mesh=mesh, **kw)
            torch.cuda.synchronize()
            reset_counts()
            got = [mesh_step(trained.model, x, sizes) for x in batches]
            torch.cuda.synchronize()
            counts = read_counts()
            launches[f"distributed/world1_{mode}"] = counts
            n = len(batches)
            check(counts["nms_keep_batch"] == n
                  and counts["gather_rows_batch"] == 2 * n
                  and counts["topk_sparse"] == k3 * n,
                  f"world-1 mesh predict ({mode}) launched {counts}")
            check(all(torch.equal(g[k], w[k]) for g, w in zip(got, want)
                      for k in w),
                  f"world-1 mesh predict ({mode}) != the plain predict step")
            predict_w1[mode] = {"bit_equal": True, "launches": counts}
    finally:
        dist.destroy_process_group()

    # -- 2. two processes on the one card -------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        probe_port = free_port()
        paths = [os.path.join(tmp, f"probe{r}.json") for r in (0, 1)]
        codes = run_ranks(_probe_rank, [(r, probe_port, paths[r])
                                        for r in (0, 1)])
        probe = [json.load(open(p)) if os.path.exists(p) else
                 {"rank": r, "ok": False, "error": f"exit code {codes[r]}"}
                 for r, p in enumerate(paths)]
        backend = "nccl" if all(p["ok"] for p in probe) else "gloo"
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in (0, 1)]
        logs = [os.path.join(os.path.dirname(_DIST_LOG),
                             f"distributed_rank{r}.log") for r in (0, 1)]
        t0 = time.perf_counter()
        codes = run_ranks(_dist_rank, [(r, backend, port, outs[r], logs[r])
                                       for r in (0, 1)])
        ranks_s = time.perf_counter() - t0
        check(codes == [0, 0], f"the two ranks ({backend}) exited {codes}; "
              f"see chiprun_out/distributed_rank*.log")
        ranks = [torch.load(p, weights_only=False) for p in outs]
    check(all(r["backend"] == backend for r in ranks),
          f"ranks ran {[r['backend'] for r in ranks]}, want {backend}")
    # the single-process references: the b32 steps, the whole evaluation
    single_m, single_s = two_steps(batch)
    single_m = [{k: float(v) for k, v in m.items()} for m in single_m]
    loss_rel = max(abs(r["metrics"][s][k] - single_m[s][k])
                   / abs(single_m[s][k]) for r in ranks for s in (0, 1)
                   for k in single_m[s])
    # every state entry within 2e-3 of the single-process value
    state_err, state_worst = max(
        (float((ranks[0]["state"][n].double() - v.cpu().double()).abs()
               .max()), n)
        for n, v in single_s.items() if v.is_floating_point())
    ranks_equal = all(torch.equal(ranks[0]["state"][n], ranks[1]["state"][n])
                      for n in ranks[0]["state"])
    check(loss_rel <= _TRAIN_LOSS_RTOL and state_err <= _TRAIN_STATE_ATOL
          and ranks_equal and ranks[0]["metrics"] == ranks[1]["metrics"],
          f"two ranks against the b32 step: loss terms {loss_rel} relative "
          f"(limit {_TRAIN_LOSS_RTOL}), state {state_err} at {state_worst} "
          f"(limit {_TRAIN_STATE_ATOL}), ranks bit-equal {ranks_equal}")
    ds = SyntheticDetection(n=_DIST_FRAMES, num_classes=7, seed=1,
                            transforms=DetectionPresetEval())
    with open(_DIST_LOG, "w") as log, contextlib.redirect_stdout(log):
        single_ev = evaluate(
            make_predict_step(trained, topk_impl="sparse"), trained.model,
            DetectionLoader(ds, _DIST_EVAL_BATCH, image_size=(320, 320)),
            CocoEvaluator(ds.ground_truth_for_eval()))
    ap_err = max(abs(r["eval_stats"][0] - float(single_ev.stats[0]))
                 for r in ranks)
    stats_err = max(abs(a - float(b)) for r in ranks
                    for a, b in zip(r["eval_stats"], single_ev.stats))
    check(all(r["merged_images"] == list(range(_DIST_FRAMES)) for r in ranks)
          and ap_err <= _DIST_AP_ATOL
          and ranks[0]["eval_stats"] == ranks[1]["eval_stats"],
          f"sharded evaluation: merged images "
          f"{[len(r['merged_images']) for r in ranks]}, AP off by {ap_err}")
    for r, res in enumerate(ranks):
        c = res["launches"]
        check(c["nms_keep_batch"] > 0 and c["gather_rows_batch"] > 0
              and c["topk_sparse"] > 0,
              f"rank {r}'s sharded evaluation launched {c}: want K1, K2, K3")
        launches[f"distributed/rank{r}_evaluate"] = {
            "fused_inverted_residual": 0, **c}

    # -- 3. the train CLI under torch.distributed.run, one process, NCCL ------
    cli_log = os.path.join(os.path.dirname(_DIST_LOG), "distributed_cli.log")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "demonet_tpu_torch.train",
           *_CLI_ARGS]
    env = dict(os.environ, NCCL_DEBUG="VERSION")
    cli = {}
    with tempfile.TemporaryDirectory(dir=_HERE) as tmp, \
            open(cli_log, "w") as log:
        for name, argv in (("train", ["--epochs", "1", "--output-dir", tmp]),
                           ("resume", ["--test-only", "--resume",
                                       os.path.join(tmp, "checkpoint_0"),
                                       "--output-dir", tmp])):
            t0 = time.perf_counter()
            proc = subprocess.run(run + argv, cwd=_HERE, env=env,
                                  capture_output=True, text=True,
                                  timeout=_DIST_JOIN_S)
            log.write(f"== {name}: exit {proc.returncode}\n{proc.stdout}\n"
                      f"-- stderr\n{proc.stderr}\n")
            check(proc.returncode == 0,
                  f"torch.distributed.run CLI {name} exited "
                  f"{proc.returncode}; see chiprun_out/distributed_cli.log")
            cli[name] = {"summary": summary_lines(proc.stdout),
                         "nccl": "NCCL version" in proc.stdout + proc.stderr,
                         "seconds": time.perf_counter() - t0}
    check(len(cli["train"]["summary"]) == 12
          and cli["resume"]["summary"] == cli["train"]["summary"]
          and cli["train"]["nccl"],
          f"torch.distributed.run CLI: summaries {cli}")
    emit({"phase": "distributed", "model": "ssdlite320_mobilenet_v3_large "
          "(trained npz), fp32",
          "world1": {"backend": backend_w1,
                     "two_mesh_steps_b32_bit_equal_to_plain": True,
                     "predict": predict_w1,
                     "step_ms_local_b16": step_ms_w1,
                     "no_mesh_step_ms_local_b16_before_after": plain_ms,
                     "trace_local_b16": traces_w1,
                     "grad_all_reduce": bucket_w1},
          "world2_one_card": {
              "nccl_probe": probe, "backend": backend,
              "rows_per_rank": _DIST_ROWS,
              "loss_terms_max_rel_vs_b32": loss_rel,
              "state_max_abs_vs_b32": [state_err, state_worst],
              "limits": {"loss_rel": _TRAIN_LOSS_RTOL,
                         "state_abs": _TRAIN_STATE_ATOL},
              "ranks_bit_equal": ranks_equal,
              "step_ms_local_b16": [r["step_ms"] for r in ranks],
              "grad_all_reduce": [r["bucket"] for r in ranks],
              "eval_frames": _DIST_FRAMES,
              "eval_ap": ranks[0]["eval_stats"][0],
              "single_process_ap": float(single_ev.stats[0]),
              "ap_abs_err": ap_err, "stats_max_abs_err": stats_err,
              "launches_per_rank": [r["launches"] for r in ranks],
              "ranks_seconds": ranks_s},
          "cli_torchrun_nproc1": {
              "backend": "nccl", "summary_equal_after_resume": True,
              "seconds": {k: v["seconds"] for k, v in cli.items()},
              "ap": cli["train"]["summary"][0]},
          "seconds": time.perf_counter() - t0_phase})
    return launches


# closed-loop batches timed per side in `export`, at b1 and at the e2e batch
_EXPORT_ITERS = {"b1": 15, "batch": 10}


def same_outputs(got, want):
    """Every output of two runs equal: keys, shapes, dtypes and bits."""
    import torch

    return got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
        for k in want)


def export_artifacts(trained, random_init, batches, reset_counts,
                     read_counts, packaging=None):
    """export: the torch.export artifacts (`demonet_tpu_torch.export`) on
    the card, each exported, saved to disk, loaded back and run:

      * the trained flagship (91 classes, 320x320) in the reference and
        fused modes at b1 and b32, on the `e2e` frames (4 requests at b32;
        the first frame of each at b1): detections bit-equal to the eager
        `make_predict_step` in the same mode; K1 and K2 launched inside the
        program 1 and 2 times a batch, K3 never (counts reset before and
        read after the 4 requests); the fused program's branch on each
        batch, read from the K of its NMS launch (K = 300: the reference
        fallback, K = R: tier R); export s, artifact MB, ms per batch
        (median, q1-q3) of the artifact beside the eager step, the two
        timed in turns;
      * the random-weight flagship's fused program at b32 on one batch:
        every score is live, so it must take the fallback;
      * the trained flagship's raw heads at b1: bit-equal to the eager
        model's;
      * the four other detectors (family_detectors' weights) in the
        reference mode at b1, 4 requests each;
      * the trained flagship with bf16 compute at b32, reference mode.

    Where a program's detections differ from eager's, both run again
    under cudnn_deterministic(); the line says whether that was needed.
    No fallback: a kernel that fails inside a program fails the run.
    With `packaging` (a CppPackaging), the trained flagship's b1 programs
    are saved into `packaging.dir` and handed, as saved, to
    `packaging.start` (`cpp_runner` packages and times them). Returns the
    launches by path ('export/...')."""
    import tempfile

    import numpy as np
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.export import (
        export_detector,
        load_exported,
        save_exported,
    )
    from demonet_tpu_torch.models.detection import preprocess, to_float
    from demonet_tpu_torch.ops.nms import nms_keep_batch

    t0 = time.perf_counter()
    launches_by_path = {}
    frames = [to_float(x) for x in batches]
    b_e2e = frames[0].shape[0]

    def artifact(det, where, name, **kwargs):
        """(the reloaded program's module, export s, save + load s, MB),
        the program saved as `where`/`name`.pt2."""
        t = time.perf_counter()
        exported = export_detector(det, **kwargs)
        export_s = time.perf_counter() - t
        path = os.path.join(where, f"{name}.pt2")
        t = time.perf_counter()
        save_exported(exported, path)
        module = load_exported(path).module()
        return (module, export_s, time.perf_counter() - t,
                os.path.getsize(path) / 1e6)

    def drive(program, xs):
        """The program on each request, counts reset just before and read
        just after; the K of each batch's NMS launch."""
        with torch.no_grad():
            program(xs[0])                         # warm-up, not counted
            torch.cuda.synchronize()
            reset_counts()
            nms_keep_batch.launches_by_k.clear()
            outs, ks = [], []
            for x in xs:
                before = dict(nms_keep_batch.launches_by_k)
                outs.append(program(x))
                ks.extend(k for k in nms_keep_batch.launches_by_k
                          if nms_keep_batch.launches_by_k[k]
                          != before.get(k, 0))
            torch.cuda.synchronize()
        return outs, read_counts(), ks

    def compare(program, step, det, xs):
        """Bit-equality of the program's detections with the eager step's
        on every request; again under cudnn_deterministic() if they
        differ. Returns (outs, counts, ks, deterministic_needed)."""
        outs, counts, ks = drive(program, xs)
        wants = [step(det.model, x) for x in xs]
        if all(same_outputs(o, w) for o, w in zip(outs, wants)):
            return outs, counts, ks, False
        with cudnn_deterministic():
            outs, counts, ks = drive(program, xs)
            wants = [step(det.model, x) for x in xs]
        check(all(same_outputs(o, w) for o, w in zip(outs, wants)),
              "an exported program's detections != the eager step's, also "
              "under cudnn_deterministic()")
        return outs, counts, ks, True

    def want_counts(n):
        return {"nms_keep_batch": n, "gather_rows_batch": 2 * n,
                "topk_sparse": 0, "fused_inverted_residual": 0,
                "topk_sparse_long": 0}

    def in_turns(program, step, det, x, iters):
        """ms per batch of the program and of the eager step, closed loop,
        one call of each in turn."""
        with torch.no_grad():
            for _ in range(3):
                program(x)
                step(det.model, x)
        torch.cuda.synchronize()
        per = {"artifact": [], "eager": []}
        for _ in range(iters):
            for side, fn in (("artifact", lambda: program(x)),
                             ("eager", lambda: step(det.model, x))):
                t = time.perf_counter()
                with torch.no_grad():
                    fn()
                torch.cuda.synchronize()
                per[side].append((time.perf_counter() - t) * 1e3)
        out = {}
        for side, ms in per.items():
            q1, med, q3 = np.percentile(ms, [25, 50, 75])
            out[side] = {"ms_per_batch_median": med,
                         "ms_per_batch_q1_q3": [q1, q3], "n": iters}
        return out

    # the reference pipeline's K: min(topk_candidates, A)
    k_ref = min(trained.config.topk_candidates, len(trained.anchors))

    def branch_of(k):
        return "fallback" if k == k_ref else f"tier_{k}"

    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        # -- the trained flagship, both modes, b1 and b32 -------------------
        for mode in ("reference", "fused"):
            step = make_predict_step(trained, impl=mode)
            for b in (1, b_e2e):
                xs = frames if b == b_e2e else [f[:1] for f in frames]
                kept = packaging is not None and b == 1
                where = packaging.dir if kept else tmp
                program, export_s, io_s, mb = artifact(
                    trained, where, f"{mode}_b{b}", batch_size=b,
                    postprocess_impl=mode)
                outs, counts, ks, det_needed = compare(program, step,
                                                       trained, xs)
                check(counts == want_counts(len(xs)),
                      f"export {mode} b{b}: launches {counts}, want 1 NMS "
                      "and 2 gathers a batch inside the program, no top-k")
                check(len(ks) == len(xs) and (mode == "fused"
                                              or set(ks) == {k_ref}),
                      f"export {mode} b{b}: NMS launches at K {ks}")
                path = f"export/{mode}_b{b}"
                launches_by_path[path] = counts
                emit({"phase": "export", "artifact": path,
                      "batch": b, "requests": len(xs), "export_s": export_s,
                      "save_load_s": io_s, "artifact_mb": mb,
                      "launches": counts, "bit_equal_to_eager": True,
                      "cudnn_deterministic_needed": det_needed,
                      **({"branches": [branch_of(k) for k in ks]}
                         if mode == "fused" else {}),
                      "valid_detections": [int(o["valid"].sum())
                                           for o in outs],
                      "timing": in_turns(program, step, trained, xs[0],
                                         _EXPORT_ITERS["b1" if b == 1
                                                       else "batch"]),
                      "t_s": time.perf_counter() - _T0})
                if kept:
                    packaging.start(mode, os.path.join(where,
                                                       f"{mode}_b1.pt2"),
                                    program)
                del program

        # -- the random-weight flagship's fused program: the fallback -------
        step = make_predict_step(random_init, impl="fused")
        program, export_s, io_s, mb = artifact(
            random_init, tmp, "fused_random", batch_size=b_e2e,
            postprocess_impl="fused")
        _, counts, ks, det_needed = compare(program, step, random_init,
                                            frames[:1])
        check(counts == want_counts(1) and ks == [k_ref],
              f"random-weight fused program: launches {counts}, NMS at K "
              f"{ks}, want the fallback (K = {k_ref})")
        launches_by_path[f"export/fused_random_b{b_e2e}"] = counts
        emit({"phase": "export", "artifact": f"export/fused_random_b{b_e2e}",
              "weights": "seeded random (every score live)",
              "export_s": export_s, "artifact_mb": mb, "launches": counts,
              "branches": [branch_of(k) for k in ks],
              "bit_equal_to_eager": True,
              "cudnn_deterministic_needed": det_needed})
        del program

        # -- raw heads at b1 -------------------------------------------------
        program, export_s, io_s, mb = artifact(trained, tmp, "raw_b1",
                                               with_postprocess=False)
        cfg = trained.config
        reset_counts()
        with torch.no_grad():
            got = [program(f[:1]) for f in frames]
        counts = read_counts()
        with torch.inference_mode():
            want = [trained.model(preprocess(f[:1], cfg, resize=False))
                    for f in frames]
        det_needed = not all(same_outputs(g, w) for g, w in zip(got, want))
        if det_needed:
            with cudnn_deterministic(), torch.no_grad():
                got = [program(f[:1]) for f in frames]
                want = [trained.model(preprocess(f[:1], cfg, resize=False))
                        for f in frames]
        check(all(same_outputs(g, w) for g, w in zip(got, want))
              and not any(counts.values()),
              f"raw-heads program != the eager model's heads, or launched "
              f"kernels {counts}")
        emit({"phase": "export", "artifact": "export/raw_b1",
              "export_s": export_s, "artifact_mb": mb,
              "outputs": {k: list(v.shape) for k, v in got[0].items()},
              "bit_equal_to_eager": True,
              "cudnn_deterministic_needed": det_needed, "launches": counts})
        del program

        # -- the other four detectors, reference mode, b1 ----------------
        for fi, name in enumerate(_FAMILIES):
            det, _ = family_detectors(name)
            peak_class_head(det)
            size = det.config.size[0]
            rng = np.random.default_rng(300 + fi)
            xs = [to_float(torch.from_numpy(
                shapes_images(rng, 1, size)[0]).cuda()) for _ in range(4)]
            step = make_predict_step(det)
            program, export_s, io_s, mb = artifact(det, tmp, name)
            outs, counts, ks, det_needed = compare(program, step, det, xs)
            check(counts == want_counts(len(xs)),
                  f"export {name}: launches {counts}")
            path = f"export/{name}_reference_b1"
            launches_by_path[path] = counts
            emit({"phase": "export", "artifact": path, "export_s": export_s,
                  "save_load_s": io_s, "artifact_mb": mb,
                  "launches": counts, "bit_equal_to_eager": True,
                  "cudnn_deterministic_needed": det_needed,
                  "valid_detections": [int(o["valid"].sum()) for o in outs],
                  "t_s": time.perf_counter() - _T0})
            del program, det

        # -- bf16 compute, b32 ---------------------------------------------
        det = trained_detector("cuda", dtype=torch.bfloat16)
        step = make_predict_step(det)
        program, export_s, io_s, mb = artifact(det, tmp, "bf16",
                                               batch_size=b_e2e)
        outs, counts, ks, det_needed = compare(program, step, det, frames)
        check(counts == want_counts(len(frames)),
              f"export bf16: launches {counts}")
        path = f"export/bf16_reference_b{b_e2e}"
        launches_by_path[path] = counts
        emit({"phase": "export", "artifact": path,
              "export_s": export_s, "save_load_s": io_s, "artifact_mb": mb,
              "launches": counts, "bit_equal_to_eager": True,
              "cudnn_deterministic_needed": det_needed,
              "valid_detections": [int(o["valid"].sum()) for o in outs],
              "timing": in_turns(program, step, det, frames[0],
                                 _EXPORT_ITERS["batch"])})
        del program, det
    emit({"phase": "export_done", "seconds": time.perf_counter() - t0,
          "t_s": time.perf_counter() - _T0})
    return launches_by_path


# -- the Caffe export -----------------------------------------------------------
# the tolerances of tests/test_caffe_eval.py for the hand-built graphs, and
# the export CLI's --verify for the generic route
_CAFFE_HAND_TOL = (2e-4, 2e-5)
_CAFFE_GENERIC_TOL = (5e-3, 1e-4)
# timed runs of the evaluator per graph
_CAFFE_EVAL_ITERS = 5
_CAFFE_LOG = os.path.join(_HERE, "chiprun_out", "caffe_cli.log")


def caffe_model(name, trained, seed=0):
    """(module on the card, one input (1, S, S, 3) on the card, classes) of
    a registry name for the `caffe` phase: the flagship the trained npz
    model; every other name its builder's seeded weights and class count,
    every BN's scale and running variance drawn in [0.5, 1.5], its bias
    and running mean from N(0, 0.1) (as tests/torch_caffe.py draws them),
    so that each BN is a real per-channel affine and the activations stay
    near 1 (statistics calibrated on a few frames leave the 1x1 maps'
    variances near 0, and outputs in the hundreds). A detector's input is
    a preprocessed shapes frame at its size; a classifier's (224x224) the
    same frame scaled to [-1, 1]."""
    import numpy as np
    import torch

    from demonet_tpu_torch.models.builders import get_model
    from demonet_tpu_torch.models.detection import preprocess, to_float
    from demonet_tpu_torch.models.layers import BatchNorm

    built = trained if name == _FLAGSHIP else get_model(name, seed=seed)
    module = getattr(built, "model", built)
    cfg = getattr(built, "config", None)
    if name != _FLAGSHIP:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for m in module.modules():
                if isinstance(m, BatchNorm):
                    c = m.num_features
                    for t, draw in ((m.weight, rng.uniform(0.5, 1.5, c)),
                                    (m.running_var, rng.uniform(0.5, 1.5, c)),
                                    (m.bias, rng.normal(0.0, 0.1, c)),
                                    (m.running_mean, rng.normal(0.0, 0.1, c))):
                        t.copy_(torch.from_numpy(draw))
    size = cfg.size[0] if cfg is not None else 224
    frame = to_float(torch.from_numpy(shapes_images(
        np.random.default_rng(seed), 1, size)[0]).cuda())
    x = (preprocess(frame, cfg, resize=False) if cfg is not None
         else frame * 2.0 - 1.0)
    classes = (cfg.num_classes if cfg is not None
               else module.classifier.out_features)
    return module, x.contiguous(), classes


def within(got, want, rtol, atol):
    """(every element within atol + rtol * |want| and the shapes equal,
    the max abs difference)."""
    import torch

    if tuple(got.shape) != tuple(want.shape):
        return False, None
    diff = (got.float() - want.float()).abs()
    return (bool(torch.all(diff <= atol + rtol * want.float().abs())),
            float(diff.max()))


def caffe_export(trained, reset_counts, read_counts):
    """caffe: the Caffe export (demonet_tpu_torch/export/caffe.py,
    caffe_eval.py, tracing.py) on the card:

      * the five hand-built families, each at full width and its size (the
        flagship from the trained npz, 91 classes; the others seeded random
        weights at their builders' class counts, caffe_model): exported
        from the card's module, prototxt and caffemodel byte-equal to the
        export of a CPU copy of its weights; the graph run by
        `run_caffenet` on the card and held to the module's forward there
        at tests/test_caffe_eval.py's tolerances (the softmaxed
        mbox_conf_softmax and the flat mbox_loc; a classifier's "prob");
        export s, MB, the evaluator's ms, the max abs error per output;
      * the generic route (`trace_to_caffe`, torch.export on the card) over
        every name of the registry, the detectors as raw heads, each graph
        held to the forward on the card at the export CLI's --verify
        tolerances; trace s and the layer counts;
      * the export CLI once: --format caffe --generic --verify on the
        trained flagship, on the card, into a temporary directory (its
        printing in chiprun_out/caffe_cli.log).

    No kernel lies on this path: the counts stay 0."""
    import collections
    import copy
    import tempfile

    import numpy as np
    import torch

    from demonet_tpu_torch.export import caffe
    from demonet_tpu_torch.export import cli as export_cli
    from demonet_tpu_torch.export.caffe_eval import (
        no_tf32,
        on_device,
        run_caffenet,
    )
    from demonet_tpu_torch.export.tracing import output_list, trace_to_caffe
    from demonet_tpu_torch.models.builders import MODEL_REGISTRY

    t0_phase = time.perf_counter()

    def eval_ms(net, data):
        """(blobs, median ms, q1-q3) of the evaluator on the card over
        _CAFFE_EVAL_ITERS runs after one warm-up, the weights already on
        the card."""
        dev_net = on_device(net, "cuda")
        run_caffenet(dev_net, {"data": data})
        per = []
        for _ in range(_CAFFE_EVAL_ITERS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            blobs = run_caffenet(dev_net, {"data": data})
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t) * 1e3)
        q1, med, q3 = np.percentile(per, [25, 50, 75])
        return blobs, med, [q1, q3]

    reset_counts()
    with tempfile.TemporaryDirectory(dir=_HERE) as tmp:
        for name in MODEL_REGISTRY:
            module, x, classes = caffe_model(name, trained)
            size = x.shape[1]
            data = x.permute(0, 3, 1, 2).contiguous()
            with torch.no_grad(), no_tf32():
                out = module(x)
            if name in caffe.BUILDERS:
                # -- the hand-built graph -----------------------------------
                files = (os.path.join(tmp, f"{name}.prototxt"),
                         os.path.join(tmp, f"{name}.caffemodel"))
                t = time.perf_counter()
                net = caffe.export_caffe(name, module, *files,
                                         num_classes=classes,
                                         input_size=size)
                export_s = time.perf_counter() - t
                cpu_net = caffe.BUILDERS[name](
                    copy.deepcopy(module).cpu(), num_classes=classes,
                    input_size=size)
                with open(files[0]) as f:
                    same_text = f.read() == cpu_net.to_prototxt()
                with open(files[1], "rb") as f:
                    same_bytes = f.read() == cpu_net.to_caffemodel()
                check(same_text and same_bytes,
                      f"caffe {name}: the card module's export != its CPU "
                      f"copy's (prototxt {same_text}, caffemodel "
                      f"{same_bytes})")
                del cpu_net
                blobs, med, q13 = eval_ms(net, data)
                if isinstance(out, dict):
                    want = {"mbox_conf_softmax":
                            torch.softmax(out["cls_logits"], -1),
                            "mbox_loc": out["bbox_regression"].reshape(1, -1)}
                else:
                    want = {"prob": torch.softmax(out, -1)}
                res = {top: within(blobs[top], w, *_CAFFE_HAND_TOL)
                       for top, w in want.items()}
                check(all(ok for ok, _ in res.values()),
                      f"caffe {name}: hand graph against the forward {res}")
                emit({"phase": "caffe", "route": "hand", "model": name,
                      "input": list(data.shape), "classes": classes,
                      "output_abs_max": {k: float(w.abs().max())
                                         for k, w in want.items()},
                      "layers": len(net.layers), "export_s": export_s,
                      "prototxt_mb": os.path.getsize(files[0]) / 1e6,
                      "caffemodel_mb": os.path.getsize(files[1]) / 1e6,
                      "bytes_equal_to_cpu_export": True,
                      "eval_ms_median": med, "eval_ms_q1_q3": q13,
                      "eval_iters": _CAFFE_EVAL_ITERS,
                      "max_abs_err": {k: e for k, (_, e) in res.items()},
                      "rtol_atol": list(_CAFFE_HAND_TOL)})
                del net, blobs
                for f in files:
                    os.remove(f)
            # -- the generic route -----------------------------------------
            t = time.perf_counter()
            net = trace_to_caffe(module, torch.zeros_like(x), name=name)
            trace_s = time.perf_counter() - t
            blobs, med, q13 = eval_ms(net, data)
            want = output_list(out)
            check(len(want) == len(net.output_tops),
                  f"caffe {name}: {len(net.output_tops)} graph outputs, "
                  f"the module has {len(want)}")
            res = {top: within(blobs[top], w, *_CAFFE_GENERIC_TOL)
                   for top, w in zip(net.output_tops, want)}
            check(all(ok for ok, _ in res.values()),
                  f"caffe {name}: generic graph against the forward {res}")
            emit({"phase": "caffe", "route": "generic", "model": name,
                  "input": list(data.shape), "trace_s": trace_s,
                  "output_abs_max": [float(w.abs().max()) for w in want],
                  "layers": len(net.layers),
                  "layer_types": dict(collections.Counter(
                      layer.type for layer in net.layers)),
                  "eval_ms_median": med, "eval_ms_q1_q3": q13,
                  "max_abs_err": {k: e for k, (_, e) in res.items()},
                  "rtol_atol": list(_CAFFE_GENERIC_TOL)})
            del net, blobs, module, out
            torch.cuda.empty_cache()

        # -- the export CLI, --generic --verify, on the card ---------------
        prefix = os.path.join(tmp, "cli")
        argv = ["--model", _FLAGSHIP, "--num-classes", "91", "--npz-weights",
                _NPZ, "--format", "caffe", "--generic", "--verify",
                "--output", prefix + ".pt2"]
        t = time.perf_counter()
        with open(_CAFFE_LOG, "w") as log, contextlib.redirect_stdout(log):
            export_cli.main(export_cli.get_args_parser().parse_args(argv))
        cli_s = time.perf_counter() - t
        with open(_CAFFE_LOG) as log:
            verified = "verified numerically against the model's forward " \
                "on cuda" in log.read()
        written = [os.path.exists(f"{prefix}.{ext}")
                   for ext in ("prototxt", "caffemodel")]
        check(verified and all(written),
              f"caffe CLI: verified on the card {verified}, files written "
              f"{written}")
        emit({"phase": "caffe", "route": "cli", "argv": argv[:-1],
              "verified_on_card": True, "files_written": True,
              "seconds": cli_s})
    counts = read_counts()
    check(not any(counts.values()),
          f"the Caffe export launched kernels: {counts}")
    emit({"phase": "caffe_done", "launches": counts,
          "seconds": time.perf_counter() - t0_phase})


# -- the C++ runner -------------------------------------------------------------
# timed calls of each side at b1
_CPP_ITERS = 50
# a package's detections against the eager step's where they are not
# bit-equal: tests/test_torch_export.py's tolerances against the JAX
# artifact (Inductor fuses BN and activations, so the heads move by ulps)
_CPP_EAGER_TOL = {"scores": 1e-5, "boxes": 1e-3}


def host_timed(fn, iters, warmup=3):
    """ms of fn() with every output copied to the host at each call, the
    runner's completion barrier: {'best', 'p50', 'mean', 'n'}."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    ms = []
    with torch.no_grad():
        for i in range(warmup + iters):
            t = time.perf_counter()
            [leaf.cpu() for leaf in tree_leaves(fn())]
            if i >= warmup:
                ms.append((time.perf_counter() - t) * 1e3)
    return {"best": min(ms), "p50": float(np.percentile(ms, 50)),
            "mean": float(np.mean(ms)), "n": iters}


def detections_within(got, want, tol):
    """Two runs' detections: (bit-equal, max score difference, max box
    difference), each image's valid detections sorted by (-score, label);
    fails unless the valid counts and labels are equal and the scores and
    boxes within `tol`."""
    import numpy as np

    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    if all(np.array_equal(got[k], want[k]) for k in want):
        return True, 0.0, 0.0
    check(np.array_equal(got["valid"].sum(1), want["valid"].sum(1)),
          f"valid detections {got['valid'].sum(1)} != eager's "
          f"{want['valid'].sum(1)}")
    s_err = b_err = 0.0
    for i in range(len(want["valid"])):
        sides = []
        for d in (got, want):
            v = d["valid"][i]
            order = np.lexsort((d["labels"][i][v], -d["scores"][i][v]))
            sides.append([d[k][i][v][order] for k in ("scores", "labels",
                                                      "boxes")])
        (gs, gl, gb), (ws, wl, wb) = sides
        check(np.array_equal(gl, wl), f"image {i}: labels differ")
        if len(ws):
            s_err = max(s_err, float(np.abs(gs - ws).max()))
            b_err = max(b_err, float(np.abs(gb - wb).max()))
    check(s_err <= tol["scores"] and b_err <= tol["boxes"],
          f"scores {s_err} or boxes {b_err} beyond {tol}")
    return False, s_err, b_err


# what a child of CppPackaging runs, each step timed from after the
# imports: the runner's build (its paths printed as JSON), or one package
# of a saved torch.export program and then, if a third argument names a
# file, dump_hlo(stage="optimized") of a tiny function on the card into it
_CPP_CHILD = """
import dataclasses, json, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from demonet_tpu_torch.export import aoti, load_exported
from demonet_tpu_torch.utils.debug import dump_hlo
t = time.perf_counter()
if sys.argv[1] == "build":
    print("runner", json.dumps(dataclasses.asdict(aoti.build_runner("cuda"))))
else:
    aoti.package_exported(load_exported(sys.argv[1]), sys.argv[2])
print("seconds", time.perf_counter() - t, flush=True)
if len(sys.argv) > 3:
    t = time.perf_counter()
    with open(sys.argv[3], "w") as f:
        f.write(dump_hlo(lambda a: (a * 2 + 1).sum(),
                         torch.ones((4, 4), device="cuda"),
                         stage="optimized"))
    print("dump_hlo seconds", time.perf_counter() - t, flush=True)
"""


class CppPackaging:
    """The C++ runner's build and the trained flagship's two AOTInductor
    packages, each in a process of its own (the reference package's also
    compiles `dump_hlo`'s tiny function after it), started before the
    `export` phase ends and run beside it and the `caffe` phase: a package
    takes 2-3 minutes of compiling, most of it g++ and the Triton compiler
    on the host's other cores. The children compile with CXX set to the g++
    on PATH: the card's machine sets CXX to a g++ without OpenMP's link
    spec (libgomp.spec), and Inductor links every package with -fopenmp.
    `stop()` kills whichever is still running and removes the packages;
    every child's printing goes to chiprun_out/cpp_runner_<name>.log."""

    def __init__(self):
        import shutil
        import tempfile

        self.dir = tempfile.mkdtemp(dir=_HERE)
        self.procs = {}
        self.programs = {}
        self.env = dict(os.environ, CXX=shutil.which("g++") or "g++")

    def _start(self, name, *args):
        os.makedirs(os.path.dirname(_LOG), exist_ok=True)
        log = open(os.path.join(os.path.dirname(_LOG),
                                f"cpp_runner_{name}.log"), "w")
        # at a lower priority than this process, whose phases it runs
        # beside: their host work keeps its cores
        self.procs[name] = (subprocess.Popen(
            [sys.executable, "-c", _CPP_CHILD, *args], cwd=_HERE,
            env=self.env, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10)), log)

    def start_build(self):
        self._start("build", "build")

    def dump_path(self):
        return os.path.join(self.dir, "dump_hlo.txt")

    def start(self, mode, src, program):
        """Package `src` (the export phase's saved b1 program of `mode`) in
        a new process; keep its reloaded module for the timings."""
        self.programs[mode] = program
        self._start(mode, src, self.path(mode),
                    *([self.dump_path()] if mode == "reference" else []))

    def path(self, mode):
        return os.path.join(self.dir, f"{mode}.pt2")

    def wait(self, name, timeout=600.0):
        """What the child printed, once it has exited 0; fails else."""
        proc, log = self.procs[name]
        proc.wait(timeout=timeout)
        log.close()
        with open(log.name) as f:
            text = f.read()
        check(proc.returncode == 0,
              f"cpp_runner's {name} process exited {proc.returncode}:\n"
              f"{text[-4000:]}")
        return text

    def running(self):
        """The children that have not exited."""
        return sorted(n for n, (proc, _) in self.procs.items()
                      if proc.poll() is None)

    def stop(self):
        import shutil

        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def cpp_runner(trained, batches, packaging):
    """cpp_runner: the detector run from C++ with no Python
    (demonet_tpu_torch/export/aoti.py, csrc/aoti_runner.cc, aoti_ops.cc):

      * the runner and the ops library built with g++ against the wheel's
        libtorch, the ops library linked to K1's and K2's nvcc libraries;
      * the trained flagship (91 classes, 320x320) packaged by AOTInductor
        at b1 in the reference and fused modes, from the programs the
        export phase saved, in `packaging`'s processes (compile s, MB; K1
        and K2 extern nodes of the package, K3 none); every child has
        exited before the first timed call here, so no compile shares the
        host with a timing;
      * the runner on each, 50 timed calls on the first `e2e` frame
        written raw (a frame of sparse scores: the fused package takes a
        tier), its outputs dumped: bit-equal to the Python call of the same
        package on the same input, both under `aoti.runner_numerics()`;
        its K1 and K2 counts: 1 and 2 every call, K1 in the block launch
        (reference) or the tiled one (a fused tier); its detections against
        the eager step in the same mode and against the same postprocess
        on the eager heads with K1 and K2 in their plain versions (the
        runner's launches of K1 and K2 held to plain PyTorch at this path's
        shapes: P = 90, K = 300 and P = 1, K = R), each bit-equal or within
        _CPP_EAGER_TOL; p50, best and mean ms of the runner, the Python
        package call, the export phase's torch.export program and the
        eager step, each call ending with its outputs on the host;
      * `dump_hlo(stage="optimized")` of a tiny function on the card, in
        the reference package's process: the text names a Triton kernel.

    Returns the launches by path ('cpp_runner/...'), counted by the ops
    library in the runner's process over all its calls."""
    import re
    import zipfile

    import torch
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.export import aoti
    from demonet_tpu_torch.models.detection import (
        postprocess_detections,
        preprocess,
        to_float,
    )

    def printed(text, step):
        return float(re.findall(rf"^{step} ([\d.]+)$", text, re.M)[-1])

    t0 = time.perf_counter()
    logs, waited_s = {}, {}
    for name in ("build", "reference", "fused"):
        t = time.perf_counter()
        logs[name] = packaging.wait(name)
        waited_s[name] = time.perf_counter() - t
    running = packaging.running()
    check(not running, f"cpp_runner: children still running {running}")
    runner = aoti.Runner(**json.loads(
        re.findall(r"^runner (.*)$", logs["build"], re.M)[-1]))
    ldd = {}
    for path in (runner.runner, runner.ops):
        out = subprocess.run(["ldd", path], capture_output=True,
                             text=True).stdout
        check("not found" not in out, f"ldd {path}:\n{out}")
        ldd[os.path.basename(path)] = sorted(
            ln.split()[0] for ln in out.splitlines()
            if "torch" in ln or "c10" in ln or ln.split()[0].startswith(
                ("nms-", "gather-")))
    emit({"phase": "cpp_runner_build", "seconds": printed(logs["build"],
                                                          "seconds"),
          "runner": os.path.basename(runner.runner),
          "ops": os.path.basename(runner.ops), "ldd": ldd,
          "waited_s": waited_s, "children_running_before_timing": running})

    x = to_float(batches[0][:1]).contiguous()
    raw = os.path.join(packaging.dir, "input.bin")
    x.cpu().numpy().tofile(raw)
    anchors = torch.as_tensor(trained.anchors, device=x.device)
    launches_by_path = {}
    for mode in ("reference", "fused"):
        path = packaging.path(mode)
        with zipfile.ZipFile(path) as z:
            (meta,) = [n for n in z.namelist()
                       if n.endswith(".wrapper.json")]
            externs = sorted({nd["node"]["target"] for nd in
                              json.loads(z.read(meta))["nodes"]})
        check(externs == ["demonet_tpu_torch::gather_rows_batch",
                          "demonet_tpu_torch::nms_keep_batch"],
              f"{mode} package's extern nodes {externs}")
        prefix = os.path.join(packaging.dir, mode)
        res = aoti.run_runner(runner, path, tuple(x.shape), iters=_CPP_ITERS,
                              input_file=raw, dump_out=prefix)
        per_call = res.launches
        shapes = [s for s in ("block", "tiled", "long")
                  if per_call.get(f"nms_keep_batch.{s}")]
        check(res.device == "cuda" and per_call.get("nms_keep_batch") == 1
              and per_call.get("gather_rows_batch") == 2
              and shapes == ["block" if mode == "reference" else "tiled"],
              f"{mode}: the runner on {res.device} launched {per_call} a "
              "call; want K1 once (block launch, or tiled on a fused tier) "
              "and K2 twice on cuda")
        diffs = aoti.check_parity(path, prefix, x)
        compiled = aoti.load_package(path)
        step = make_predict_step(trained, impl=mode)
        program = packaging.programs[mode]
        with aoti.runner_numerics(), torch.no_grad():
            leaves, spec = tree_flatten(compiled(x))
            ran = tree_unflatten(aoti.read_dumps(
                prefix, [t.cpu().contiguous() for t in leaves]), spec)
            want = step(trained.model, x)
            equal, s_err, b_err = detections_within(ran, want,
                                                    _CPP_EAGER_TOL)
            with torch.inference_mode():
                heads = trained.model(preprocess(x, trained.config,
                                                 resize=False))
                plain = postprocess_detections(
                    heads["cls_logits"], heads["bbox_regression"], anchors,
                    trained.config, nms_impl="plain", gather_impl="plain",
                    impl=mode)
            p_equal, p_s_err, p_b_err = detections_within(ran, plain,
                                                          _CPP_EAGER_TOL)
            timing = {
                "cpp_runner": {**res.ms, "n": res.iters},
                "python_package": host_timed(lambda: compiled(x),
                                             _CPP_ITERS),
                "torch_export_program": host_timed(lambda: program(x),
                                                   _CPP_ITERS),
                "eager_step": host_timed(lambda: step(trained.model, x),
                                         _CPP_ITERS)}
        launches = {"nms_keep_batch": per_call["nms_keep_batch"] * res.calls,
                    "gather_rows_batch": per_call["gather_rows_batch"]
                    * res.calls,
                    "topk_sparse": 0, "fused_inverted_residual": 0,
                    "topk_sparse_long": 0}
        launches_by_path[f"cpp_runner/{mode}_b1"] = launches
        emit({"phase": "cpp_runner", "package": f"cpp_runner/{mode}_b1",
              "compile_s": printed(logs[mode], "seconds"),
              "package_mb": os.path.getsize(path) / 1e6,
              "extern_nodes": externs, "outputs": res.outputs,
              "runner_vs_python_max_abs_diff": diffs,
              "launches_per_call": per_call, "calls": res.calls,
              "launches": launches, "nms_launch": shapes[0],
              "valid_detections": int(ran["valid"].sum()),
              "vs_eager": {"bit_equal": equal, "max_score_diff": s_err,
                           "max_box_diff": b_err,
                           "tolerance": _CPP_EAGER_TOL},
              "vs_plain_kernels": {
                  "what": "the runner's detections against the postprocess "
                          "on the eager heads, nms_impl and gather_impl "
                          "'plain'",
                  "bit_equal": p_equal, "max_score_diff": p_s_err,
                  "max_box_diff": p_b_err, "tolerance": _CPP_EAGER_TOL},
              "timing_ms": timing,
              "numerics": "cuDNN TF32 off, deterministic, no benchmark, "
                          "both processes"})
        del compiled

    with open(packaging.dump_path()) as f:
        text = f.read()
    check("triton" in text, "dump_hlo(stage='optimized') on the card names "
          "no Triton kernel")
    emit({"phase": "cpp_runner_dump_hlo",
          "seconds": printed(logs["reference"], "dump_hlo seconds"),
          "chars": len(text),
          "triton_kernels": sorted(set(re.findall(r"triton_\w+", text)))[:5]})
    emit({"phase": "cpp_runner_done", "seconds": time.perf_counter() - t0})
    return launches_by_path


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    import numpy as np

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models import detection
    from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
    from demonet_tpu_torch.models.detection import (
        _NEG_INF,
        postprocess_detections,
        preprocess,
    )
    from demonet_tpu_torch.ops import _build
    from demonet_tpu_torch.ops.fused_block import (
        fold_inverted_residual,
        fused_inverted_residual,
        fused_inverted_residual_plain,
    )
    from demonet_tpu_torch.ops.gather import (
        gather_rows_batch,
        gather_rows_batch_plain,
    )
    from demonet_tpu_torch.ops.nms import (
        _kernel as nms_kernel,
        kernel_launch_shape,
        launch_shape,
        nms_keep_batch,
        nms_keep_batch_plain,
    )
    from demonet_tpu_torch.ops.topk import topk_sparse, topk_sparse_plain
    from demonet_tpu_torch.utils.weights import load_jax_variables

    t_start = time.perf_counter()
    if os.path.exists(_LOG):
        os.remove(_LOG)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "probe": module_versions("cv2", "PIL")})

    # -- build -------------------------------------------------------------
    secs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "Compiling entry" in ln]
             for name in secs}
    # K1's launch shape is csrc/nms.cu's choice, which both its callers
    # (ops/nms.py, csrc/aoti_ops.cc) take; ops/nms.py tells it without the
    # library, for reporting
    nms_shapes = {k: kernel_launch_shape(k)
                  for k in (1, 300, 512, 513, 2048, 8192, 8193, 20000)}
    check(all(launch_shape(k) == s for k, s in nms_shapes.items()),
          f"csrc/nms.cu's launch shapes {nms_shapes} != ops/nms.py's")
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas,
          "fused_block_usage": ptxas_usage(_build.build_log("fused_block")),
          "nms_launch_shape": nms_shapes})

    thr = _NEG_INF / 2
    iou = 0.55
    b = 32
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(shapes_images(rng, b)[0]).to(dev)
               for _ in range(4)]
    sizes = torch.tensor([[480, 640]] * b, dtype=torch.int32, device=dev)

    trained = ssdlite320_mobilenet_v3_large(num_classes=91)
    with np.load(_NPZ) as z:
        load_jax_variables(trained.model, {k: z[k] for k in z.files})
    random_init = ssdlite320_mobilenet_v3_large(num_classes=91, seed=0)
    cfg = trained.config
    anchors = torch.as_tensor(trained.anchors, device=dev)
    counters = {"nms_keep_batch": nms_keep_batch,
                "gather_rows_batch": gather_rows_batch,
                "topk_sparse": topk_sparse,
                "fused_inverted_residual": fused_inverted_residual}
    branches = detection._postprocess_fused.branches

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        topk_sparse.long_launches = 0
        nms_keep_batch.launches_by_k.clear()
        branches.clear()

    def read_counts():
        return {**{name: fn.launches for name, fn in counters.items()},
                "topk_sparse_long": topk_sparse.long_launches}

    # -- kernels against their plain versions at the main paths' shapes ----
    regimes = {}
    with torch.inference_mode():
        for name, det in (("trained", trained), ("random", random_init)):
            out = det.model(preprocess(batches[0], det.config, resize=False))
            regimes[name] = (out, head_to_candidates(det, out))
    def nms_tiled(boxes, sc, t):
        """K1's tiled launch at any K, called past the wrapper (which takes
        it only above K = 512) and not counted in `launches`: checks it at
        the reference shape and times the wrapper's choice of launch."""
        p, k, _ = boxes.shape
        keep = torch.empty((p, k), dtype=torch.bool, device=dev)
        mask = torch.empty((p, k, -(-k // 64)), dtype=torch.int64, device=dev)
        _build.check(nms_kernel()(
            boxes.data_ptr(), sc.data_ptr(), keep.data_ptr(), mask.data_ptr(),
            p, k, t, thr, 2, torch.cuda.current_stream().cuda_stream),
            "nms_keep_batch, tiled launch")
        return keep

    def check_nms(boxes, sc, t, what, tiled_too=False, err_key=None):
        """The kernel (and its tiled launch, if asked) against the plain
        version; returns the plain keep mask and the wrapper's launch.
        The largest difference goes under nms_keep_batch (and err_key)."""
        p_keep = nms_keep_batch_plain(boxes, sc, t, thr)
        shape = launch_shape(boxes.shape[1])
        got = {shape: nms_keep_batch(boxes, sc, t, thr)}
        if tiled_too:
            got["tiled"] = nms_tiled(boxes, sc, t)
        torch.cuda.synchronize()
        for name, k_keep in got.items():
            record_err(("nms_keep_batch", err_key or "nms_keep_batch"),
                       k_keep, p_keep)
            check(torch.equal(k_keep, p_keep),
                  f"NMS kernel ({name} launch) != plain on {what} "
                  f"({int((k_keep != p_keep).sum())} entries differ)")
        return p_keep, shape

    for name, (_, cand) in regimes.items():
        boxes, sc = cand["cand_boxes"], cand["cand_sc"]
        keep, shape = check_nms(boxes, sc, iou, f"the {name} candidates",
                                tiled_too=True)
        emit({"phase": "kernel_nms", "regime": name,
              "problems": list(sc.shape), "bit_equal": True,
              "launch": shape, "tiled_launch_bit_equal": True,
              "valid": int((sc > thr).sum()), "kept": int(keep.sum())})

    # the fused path's shapes: one class-offset problem per image, from
    # the trained model's scores and the random-weight model's (whose
    # per-class cap leaves 300 valid an image), and the random-weight
    # model's best candidates uncapped: every candidate valid
    fused_in = {r: fused_shapes(trained, regimes["trained"][1], r)
                for r in (1024, 2048)}
    fused_random = {r: fused_shapes(random_init, regimes["random"][1], r)
                    for r in (1024, 2048)}
    offset = max(cfg.size) + 2
    fused_dense = {r: dense_fused_problem(regimes["random"][1], r, offset)
                   for r in (1024, 2048)}
    for regime, shapes in (("trained", fused_in), ("random", fused_random),
                           ("random all valid", fused_dense)):
        for r, f in shapes.items():
            off, sc = f if regime == "random all valid" else f["nms"]
            keep, shape = check_nms(
                off, sc, iou, f"the {regime} fused K={r} problems",
                err_key=f"nms_keep_batch/K{r}" if regime == "trained"
                else None)
            emit({"phase": "kernel_nms", "regime": f"{regime}, fused path",
                  "problems": list(sc.shape), "bit_equal": True,
                  "launch": shape,
                  "valid": int((sc > thr).sum()), "kept": int(keep.sum())})

    edge = {
        "all_invalid": ([[[0, 0, 10, 10]] * 4], [[-1e30] * 4], 0.5),
        "single_valid": ([[[0, 0, 10, 10]] * 4], [[0.9] + [-1e30] * 3], 0.5),
        "identical_chain": ([[[0, 0, 10, 10]] * 6],
                            [[0.9, 0.8, 0.7, 0.6, 0.5, 0.4]], 0.5),
        "iou_at_threshold": ([[[0, 0, 2, 1], [0, 0, 1, 1]]], [[0.9, 0.8]], 0.5),
        "iou_below_threshold": ([[[0, 0, 2, 1], [0, 0, 1, 1]]], [[0.9, 0.8]],
                                0.49),
    }
    expect = {"all_invalid": [False] * 4,
              "single_valid": [True, False, False, False],
              "identical_chain": [True] + [False] * 5,
              "iou_at_threshold": [True, True],
              "iou_below_threshold": [True, False]}
    # each edge case at its own K (block launch) and padded with invalid
    # candidates to K = 576 (tiled launch)
    k_pad = 576
    edge_launches = set()
    for name, (bx, sc, t) in edge.items():
        bx = torch.tensor(bx, dtype=torch.float32, device=dev)
        sc = torch.tensor(sc, dtype=torch.float32, device=dev)
        n = sc.shape[1]
        padded = (torch.cat([bx, bx.new_zeros((1, k_pad - n, 4))], 1),
                  torch.cat([sc, sc.new_full((1, k_pad - n), -1e30)], 1))
        for bx_k, sc_k in ((bx, sc), padded):
            k_e = sc_k.shape[1]
            keep, shape = check_nms(bx_k.contiguous(), sc_k.contiguous(), t,
                                    f"edge case {name}, K={k_e}")
            edge_launches.add(shape)
            check(keep[0].tolist() == expect[name] + [False] * (k_e - n),
                  f"NMS edge case {name}, K={k_e}")
    # the mask's 64-bit words: chains and pairs at IoU = threshold across
    # word boundaries, in the block launch (K <= 512) and the tiled one
    boundary = []
    for k_b in (63, 64, 65, 128, 300, 576, 1024):
        bx, sc, marks = word_boundary_problems(k_b)
        bx, sc = bx.to(dev), sc.to(dev)
        for t in (0.5, 0.49):
            keep, shape = check_nms(bx, sc, t, f"word-boundary K={k_b} "
                                    f"at {t}")
            k0 = keep[0].tolist()
            for m in marks:
                pair_ok = m + 1 >= k_b or (k0[m - 1]
                                           and k0[m + 1] == (t >= 0.5))
                check(k0[m - 3] and not k0[m - 2] and not k0[m] and pair_ok,
                      f"NMS word-boundary K={k_b} at {t}, candidate {m}: "
                      "chain or pair wrong")
        boundary.append({"k": k_b, "marks": marks, "launch": shape})
    emit({"phase": "kernel_nms_edges", "cases": sorted(edge),
          "edge_k": ["own", k_pad], "launches": sorted(edge_launches),
          "word_boundary": boundary, "ok": True})

    cand = regimes["trained"][1]
    adv = torch.rand((b, 27000, 4), generator=torch.Generator().manual_seed(1))
    adv[0, 0] = torch.tensor([1e30, -1e-30, 3.14159274, 2.0 ** -20])
    adv[0, -1] = torch.tensor([-0.0, 1e-45, -1e30, 1e-39])
    adv = adv.to(dev)
    adv_idx = torch.randint(0, 27000, (b, 300), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2)).to(dev)
    adv_idx[0, :3] = torch.tensor([0, 26999, 26999], dtype=torch.int32)
    cand_flat = cand["cand_boxes"].reshape(b, -1, 4)
    final_idx = torch.sort(cand["cand_sc"].reshape(b, -1), dim=-1,
                           descending=True, stable=True)[1][:, :300]
    final_idx = final_idx.to(torch.int32).contiguous()
    gather_cases = {
        "candidate": (cand["boxes"], cand["top_idx"]),
        "final": (cand_flat, final_idx),
        "adversarial": (adv, adv_idx),
    }
    for r, f in fused_in.items():
        gather_cases[f"fused_candidate_r{r}"] = f["candidate"]
        gather_cases[f"fused_final_r{r}"] = f["final"]
    for name, (table, idx) in gather_cases.items():
        for cm in (False, True):
            got = gather_rows_batch(table, idx, coord_major=cm)
            want = gather_rows_batch_plain(table, idx, coord_major=cm)
            torch.cuda.synchronize()
            shape_key = ("gather_rows_batch/R" + name.rsplit("_r", 1)[1]
                         if name.startswith("fused_")
                         else "gather_rows_batch")
            record_err(("gather_rows_batch", shape_key), got, want)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"gather kernel != plain on {name}, coord_major={cm}")
        emit({"phase": "kernel_gather", "case": name,
              "table": list(table.shape), "idx": list(idx.shape),
              "layouts": ["row", "coord_major"], "bit_equal": True})

    # sparse top-k: P = 32 * 90 rows of A = 3,234, k = 300, slots = 8
    p_rows, a = b * (cfg.num_classes - 1), anchors.shape[0]
    st = cfg.score_thresh
    gen = torch.Generator().manual_seed(3)
    topk_cases = {
        "trained": regimes["trained"][1]["fg"].reshape(p_rows, a),
        "synthetic_within_slots": synthetic_topk_rows(
            p_rows, a, st, torch.randint(1, _TOPK_SLOTS + 1, (p_rows,),
                                         generator=gen), seed=4),
        "chunks_0_8_9": synthetic_topk_rows(
            p_rows, a, st, torch.tensor([0, 8, 9]).repeat(p_rows // 3 + 1)[
                :p_rows], seed=5),
        "ties_across_chunks": synthetic_topk_rows(
            p_rows, a, st, torch.randint(1, 13, (p_rows,), generator=gen),
            levels=(0.25, 0.5, 0.75), seed=6),
        "random_weights": regimes["random"][1]["fg"].reshape(p_rows, a),
    }
    for seed, case in enumerate(("tie_at_kth", "live_k_minus_1", "live_k",
                                 "live_k_plus_1", "one_exponent_bin")):
        topk_cases[case] = spread_topk_rows(p_rows, a, st, _TOPK_K, case,
                                            seed=7 + seed)
    topk_rows = {}
    for name, rows in topk_cases.items():
        rows = rows.to(dev).contiguous()
        topk_cases[name] = rows
        k_sc, k_idx = topk_sparse(rows, _TOPK_K, st, _TOPK_SLOTS)
        p_sc, p_idx = topk_sparse_plain(rows, _TOPK_K, st)
        torch.cuda.synchronize()
        record_err(("topk_sparse",), k_sc, p_sc)
        check(torch.equal(k_sc.view(torch.int32), p_sc.view(torch.int32))
              and torch.equal(k_idx, p_idx),
              f"top-k kernel != plain on {name} "
              f"({int((k_idx != p_idx).sum())} indices differ)")
        topk_rows[name] = topk_branches(rows, st, _TOPK_K, _TOPK_SLOTS)
        emit({"phase": "kernel_topk", "case": name, "shape": [p_rows, a],
              "k": _TOPK_K, "slots": _TOPK_SLOTS, "bit_equal": True,
              **topk_rows[name]})
    spread = ("tie_at_kth", "live_k_minus_1", "live_k", "live_k_plus_1",
              "one_exponent_bin")
    check(topk_rows["chunks_0_8_9"]["rows_select"] == p_rows // 3
          and topk_rows["synthetic_within_slots"]["rows_select"] == 0
          and all(topk_rows[c]["rows_select"] == p_rows for c in spread)
          and all(topk_rows[c]["rows_select_radix"] == (
              p_rows if c in ("tie_at_kth", "live_k_plus_1",
                              "one_exponent_bin") else 0) for c in spread),
          f"top-k cases do not cover every branch: {topk_rows}")

    # K3's long-row launch: rows of the VGG SSDs' anchor counts
    def topk_long_row(rows_in):
        nbytes, ops = topk_work(rows_in, _TOPK_K, st)
        bms, by = bound(nbytes, ops)
        k_t = timed(lambda: topk_sparse(rows_in, _TOPK_K, st, _TOPK_SLOTS),
                    50)
        p_t = timed(lambda: topk_sparse_plain(rows_in, _TOPK_K, st), 10)
        l_t = timed(lambda: torch.topk(rows_in, _TOPK_K, dim=-1), 10)
        return {"ms": k_t["ms"], "plain_ms": p_t["ms"], "bound_ms": bms,
                "bound_by": by, "library_ms": l_t["ms"],
                "library": "torch.topk(k=300) on the same rows",
                "bytes": nbytes, "ops": ops, "event_ms": k_t["event_ms"],
                "ms_from": k_t["ms_from"]}

    topk_long_times = topk_long(dev, topk_long_row)

    # fused inverted-residual block: blocks 0-2 of the trained trunk on
    # the trunk's own activations (channels_last in memory on the card,
    # fed as they are), then the other blocks of the kernel's contract
    # with random weights
    trunk = trained.model.extractor.trunk
    folded = [fold_inverted_residual(trunk.blocks[i]) for i in range(3)]
    with torch.inference_mode():
        native = [trunk.stem(preprocess(batches[0], cfg,
                                        resize=False).permute(0, 3, 1, 2))]
        for i in range(3):
            native.append(trunk.blocks[i](native[-1]))
    check(all(t.is_contiguous(memory_format=torch.channels_last)
              for t in native), "trunk activations are not channels_last")
    block_err = [check_fused_block(f"v3l_{i}", native[i], folded[i],
                                   native[i + 1]) for i in range(3)]
    others = {}
    for n, (name, ci, ce, co, h, w, s, act) in enumerate(contract_blocks()):
        mod = random_block(ci, ce, co, s, act, dev, seed=20 + n)
        x_o = torch.randn((b, h, w, ci), device=dev, generator=torch.Generator(
            device=dev).manual_seed(20 + n)).permute(0, 3, 1, 2)
        others[name] = (x_o, fold_inverted_residual(mod), mod)
        block_err.append(check_fused_block(name, x_o, others[name][1]))
    try:
        fused_inverted_residual(native[0].contiguous(), **folded[0])
        raised = "nothing"
    except ValueError as e:
        raised = str(e)
    check("channels_last" in raised,
          f"an NCHW-contiguous CUDA input gave {raised!r}, not a ValueError")
    emit({"phase": "kernel_fused_block",
          "weights": "trained (v3l_*), random He-like (others)",
          "tolerance": {"atol": _BLOCK_ATOL, "rtol": _BLOCK_RTOL},
          "trunk_activations_channels_last": True,
          "nchw_input_raises": raised, "blocks": block_err})

    # -- main paths: 4 requests of 32 through the user's entry point -------
    def check_detections(dets):
        n_valid = []
        for d in dets:
            check(d["boxes"].shape == (b, 300, 4)
                  and d["scores"].shape == (b, 300)
                  and d["labels"].shape == (b, 300)
                  and d["valid"].shape == (b, 300)
                  and d["labels"].dtype == torch.int32
                  and d["valid"].dtype == torch.bool, "detection shapes")
            check(bool(torch.isfinite(d["boxes"]).all())
                  and bool(torch.isfinite(d["scores"]).all()),
                  "finite outputs")
            v = d["valid"]
            check(bool((d["scores"][v] > cfg.score_thresh).all())
                  and bool((d["labels"][v] >= 1).all())
                  and bool((d["labels"][v] <= 90).all()), "valid detections")
            n_valid.append(int(v.sum()))
        return n_valid

    def drive(step, det=trained, xs_in=batches):
        """Run the step on each batch with every count reset just before
        and read just after; the fused path's branch of each batch."""
        step(det.model, xs_in[0], sizes)  # warm-up, outside the count
        torch.cuda.synchronize()
        reset_counts()
        dets, taken = [], []
        for x in xs_in:
            before = dict(branches)
            dets.append(step(det.model, x, sizes))
            taken.extend(k for k in branches if branches[k] != before.get(k, 0))
        torch.cuda.synchronize()
        return dets, read_counts(), taken

    def same_head_outputs(det, xs_in, **kwargs):
        """The detections of one mode and of the reference postprocess on
        the same head outputs, checked: valid, scores and labels bit-equal,
        boxes bit-equal or within 1e-4 px. Returns the largest box diff."""
        worst = 0.0
        for x in xs_in:
            with torch.inference_mode():
                o = det.model(preprocess(x, det.config, resize=False))
                args = (o["cls_logits"], o["bbox_regression"],
                        torch.as_tensor(det.anchors, device=dev), det.config,
                        sizes)
                want = postprocess_detections(*args)
                got = postprocess_detections(*args, **kwargs)
            for key in ("valid", "scores", "labels"):
                check(torch.equal(got[key], want[key]),
                      f"{kwargs}: {key} != reference postprocess")
            box_diff = float((got["boxes"] - want["boxes"]).abs().max())
            check(box_diff <= 1e-4, f"{kwargs}: boxes differ by {box_diff}")
            worst = max(worst, box_diff)
        return worst

    k_ref = regimes["trained"][1]["cand_sc"].shape[1]

    def nms_launches(taken):
        """K1's launch shape on each fused-path branch taken."""
        return {br: launch_shape(int(br[len("tier_"):]) if br.startswith(
            "tier_") else k_ref) for br in sorted(set(taken))}

    launches_by_path = {}
    dets, counts, _ = drive(make_predict_step(trained))
    check(counts == {"nms_keep_batch": 4, "gather_rows_batch": 8,
                     "topk_sparse": 0, "fused_inverted_residual": 0,
                     "topk_sparse_long": 0},
          f"reference path launch counts {counts}, want 1 NMS and 2 "
          "gathers per batch")
    launches_by_path["reference"] = counts
    emit({"phase": "main_path", "mode": "reference", "batches": len(batches),
          "batch": b, "launches": counts, "nms_launch": launch_shape(k_ref),
          "valid_detections": check_detections(dets)})

    dets, counts, taken = drive(make_predict_step(trained, impl="fused"))
    check(counts == {"nms_keep_batch": 4, "gather_rows_batch": 8,
                     "topk_sparse": 0, "fused_inverted_residual": 0,
                     "topk_sparse_long": 0}
          and len(taken) == 4,
          f"fused path launch counts {counts}, branches {taken}: want 1 NMS "
          "and 2 gathers per batch on every branch")
    launches_by_path["fused"] = counts
    fused_branches = taken
    n_valid = check_detections(dets)
    box_diff = same_head_outputs(trained, batches, impl="fused")
    # random weights: dense scores, so every batch must take the fallback
    dets_r, counts_r, taken_r = drive(
        make_predict_step(random_init, impl="fused"), random_init,
        batches[:1])
    check(taken_r == ["fallback"], f"random weights took {taken_r}")
    box_diff_r = same_head_outputs(random_init, batches[:1], impl="fused")
    emit({"phase": "main_path_fused", "batches": len(batches), "batch": b,
          "launches": counts, "branches": fused_branches,
          "nms_launch": nms_launches(fused_branches),
          "valid_detections": n_valid,
          "vs_reference_same_head": "valid/scores/labels bit-equal",
          "max_box_diff_vs_reference": box_diff,
          "random_weights": {"branches": taken_r, "launches": counts_r,
                             "max_box_diff_vs_reference": box_diff_r}})

    dets, counts, _ = drive(make_predict_step(trained,
                                              topk_impl="sparse_pallas"))
    check(counts == {"nms_keep_batch": 4, "gather_rows_batch": 8,
                     "topk_sparse": 4, "fused_inverted_residual": 0,
                     "topk_sparse_long": 0},
          f"sparse top-k path launch counts {counts}, want 1 top-k, 1 NMS "
          "and 2 gathers per batch")
    launches_by_path["sparse_topk"] = counts
    box_diff = same_head_outputs(trained, batches, topk_impl="sparse_pallas")
    check(box_diff == 0.0, "sparse top-k boxes != reference")
    emit({"phase": "main_path_sparse_topk", "batches": len(batches),
          "batch": b, "launches": counts, "nms_launch": launch_shape(k_ref),
          "valid_detections": check_detections(dets),
          "vs_exact_topk_same_head": "bit-equal"})

    # blocks 0-2 of the trained trunk through the fused kernel (the model
    # keeps its unfused blocks, as the JAX package does)
    def fused_blocks(x):
        with torch.inference_mode():
            y = trunk.stem(preprocess(x, cfg, resize=False).permute(
                0, 3, 1, 2))
            for f in folded:
                y = fused_inverted_residual(y, **f)
        return y

    fused_blocks(batches[0])
    torch.cuda.synchronize()
    reset_counts()
    ys = [fused_blocks(x) for x in batches]
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["fused_inverted_residual"] == 3 * len(batches)
          and sum(counts.values()) == 3 * len(batches),
          f"fused blocks launch counts {counts}, want 3 per batch")
    launches_by_path["fused_blocks"] = counts
    worst = 0.0
    for x, y in zip(batches, ys):
        with torch.inference_mode():
            want = trunk.stem(preprocess(x, cfg, resize=False).permute(
                0, 3, 1, 2))
            for i in range(3):
                want = trunk.blocks[i](want)
        check(y.shape == want.shape and bool(torch.isfinite(y).all()),
              "fused blocks output")
        share = float(((y - want).abs() / (
            _BLOCK_ATOL + _BLOCK_RTOL * want.abs())).max())
        check(share <= 1.0, f"fused blocks differ from the unfused blocks "
              f"by {share} of the tolerance")
        worst = max(worst, float((y - want).abs().max()))
    emit({"phase": "main_path_fused_blocks", "batches": len(batches),
          "batch": b, "launches": counts, "input": "the stem's output as "
          "it is (channels_last), no copy",
          "max_abs_err_vs_unfused_blocks": worst,
          "tolerance": {"atol": _BLOCK_ATOL, "rtol": _BLOCK_RTOL}})

    # -- reference: the card against the CPU, kernels against plain --------
    out_main, _ = regimes["trained"]
    cpu = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu")
    with np.load(_NPZ) as z:
        load_jax_variables(cpu.model, {k: z[k] for k in z.files})
    with torch.inference_mode():
        ref = cpu.model(preprocess(batches[0][:2].cpu(), cpu.config,
                                   resize=False))
    head_err = {k: float((out_main[k][:2].cpu() - ref[k]).abs().max())
                for k in ref}
    check(all(e <= 1e-3 for e in head_err.values()),
          f"card vs CPU head outputs differ by {head_err} (limit 1e-3)")
    with torch.inference_mode():
        pp = {(impl, mode): postprocess_detections(
            out_main["cls_logits"], out_main["bbox_regression"], anchors,
            cfg, sizes, nms_impl=impl, gather_impl=impl, impl=mode)
            for impl in ("auto", "plain") for mode in ("reference", "fused")}
    for mode in ("reference", "fused"):
        for key in pp["auto", mode]:
            check(torch.equal(pp["auto", mode][key], pp["plain", mode][key]),
                  f"{mode} postprocess through kernels != plain in {key}")
    emit({"phase": "reference", "head_max_abs_err_vs_cpu": head_err,
          "head_limit": 1e-3,
          "postprocess_kernels_vs_plain": "bit-equal (reference and fused)"})

    # -- timings at the main paths' shapes ---------------------------------
    def total_launches(name):
        return sum(c[name] for c in launches_by_path.values())

    def by_path(name):
        return {p: c[name] for p, c in launches_by_path.items() if c[name]}

    def nms_row(bx, sc, plain_iters, tiled_too=False):
        keep = nms_keep_batch(bx, sc, iou, thr)
        nbytes, ops = nms_work(keep, sc, thr)
        bms, by = bound(nbytes, ops)
        k_t = timed(lambda: nms_keep_batch(bx, sc, iou, thr), 50)
        p_t = timed(lambda: nms_keep_batch_plain(bx, sc, iou, thr),
                    plain_iters, 1)
        row = {"shape": list(sc.shape), "launch": launch_shape(sc.shape[1]),
               "ms": k_t["ms"], "plain_ms": p_t["ms"], "bound_ms": bms,
               "bound_by": by, "library_ms": None, "bytes": nbytes,
               "ops": ops, "event_ms": k_t["event_ms"],
               "plain_event_ms": p_t["event_ms"], "ms_from": k_t["ms_from"]}
        if tiled_too:   # the launch the wrapper does not take at this K
            row["tiled_launch_ms"] = timed(lambda: nms_tiled(bx, sc, iou),
                                           50)["ms"]
        return row

    tier_counts = {r: fused_branches.count(f"tier_{r}") for r in (1024, 2048)}
    rows = []
    nms_rows = {name: nms_row(c["cand_boxes"], c["cand_sc"], 3,
                              tiled_too=True)
                for name, (_, c) in regimes.items()}
    nms_fused = {}
    for r, f in fused_in.items():
        nms_fused[f"K{r}"] = {**nms_row(*f["nms"], 2),
                              "max_abs_err":
                                  _MAX_ERR[f"nms_keep_batch/K{r}"],
                              "launches": tier_counts[r],
                              "launches_from": "fused path, batches on "
                                               f"tier {r}"}
    for r, f in fused_random.items():
        nms_fused[f"K{r}_random_weights"] = nms_row(*f["nms"], 1)
    for r, f in fused_dense.items():
        nms_fused[f"K{r}_random_all_valid"] = nms_row(*f, 1)
    main = nms_rows["trained"]
    rows.append({
        "name": "nms_keep_batch", "route": "cuda",
        "source": "demonet_tpu_torch/csrc/nms.cu",
        "replaces": "demonet_tpu/ops/nms_pallas.py:80",
        "launches": total_launches("nms_keep_batch"),
        "launches_by_path": by_path("nms_keep_batch"),
        "max_abs_err": _MAX_ERR["nms_keep_batch"],
        "bit_equal": True, **{k: main[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": main["shape"], "detail": main,
        "dense_random_weights": nms_rows["random"],
        "fused_path_shapes": nms_fused})

    calls = {name: gather_row(*gather_cases[name])
             for name in ("candidate", "final")}
    total = {key: sum(c[key] for c in calls.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    g_fused = {}
    for r in (1024, 2048):
        fc = {name: gather_row(*gather_cases[f"fused_{name}_r{r}"])
              for name in ("candidate", "final")}
        g_fused[f"R{r}"] = {
            **{key: sum(c[key] for c in fc.values())
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": "bytes",
            "max_abs_err": _MAX_ERR[f"gather_rows_batch/R{r}"],
            "launches": 2 * tier_counts[r],
            "launches_from": f"fused path, batches on tier {r}",
            "calls": fc}
    rows.append({
        "name": "gather_rows_batch", "route": "cuda",
        "source": "demonet_tpu_torch/csrc/gather.cu",
        "replaces": "demonet_tpu/ops/gather_pallas.py:86",
        "launches": total_launches("gather_rows_batch"),
        "launches_by_path": by_path("gather_rows_batch"),
        "max_abs_err": _MAX_ERR["gather_rows_batch"],
        "bit_equal": True, **total, "bound_by": "bytes",
        "per_predict": "candidate + final gather", "calls": calls,
        "fused_path_shapes": g_fused})

    def topk_row(rows_in, scores_bac):
        nbytes, ops = topk_work(rows_in, _TOPK_K, st)
        bms, by = bound(nbytes, ops)
        masked = torch.where(rows_in > st, rows_in,
                             torch.tensor(float("-inf"), device=dev))
        k_t = timed(lambda: topk_sparse(rows_in, _TOPK_K, st, _TOPK_SLOTS), 50)
        p_t = timed(lambda: topk_sparse_plain(rows_in, _TOPK_K, st), 20)
        l_t = timed(lambda: torch.topk(rows_in, _TOPK_K, dim=-1), 20)
        s_t = timed(lambda: torch.sort(masked, dim=-1, descending=True,
                                       stable=True), 20)
        # the (B, C-1, A) copy of the (B, A, C) scores that detection.py
        # hands the kernel
        c_t = timed(lambda: scores_bac[..., 1:].transpose(1, 2).contiguous(),
                    20)
        return {"ms": k_t["ms"], "plain_ms": p_t["ms"], "bound_ms": bms, "bound_by": by,
                "library_ms": l_t["ms"],
                "library": "torch.topk(k=300) on the same rows",
                "stable_sort_ms": s_t["ms"],
                "fg_contiguous_copy_ms": c_t["ms"], "bytes": nbytes,
                "ops": ops, "event_ms": k_t["event_ms"],
                "ms_from": k_t["ms_from"]}

    t_main = topk_row(topk_cases["trained"], regimes["trained"][1]["scores"])
    rows.append({
        "name": "topk_sparse", "route": "cuda",
        "source": "demonet_tpu_torch/csrc/topk.cu",
        "replaces": "demonet_tpu/ops/topk_pallas.py:188",
        "launches": total_launches("topk_sparse"),
        "launches_by_path": by_path("topk_sparse"),
        "max_abs_err": _MAX_ERR["topk_sparse"],
        "bit_equal": True, **{k: t_main[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": [p_rows, a], "k": _TOPK_K, "slots": _TOPK_SLOTS,
        "detail": t_main, "branches": topk_rows["trained"],
        "dense_random_weights": {
            **topk_row(topk_cases["random_weights"],
                       regimes["random"][1]["scores"]),
            "branches": topk_rows["random_weights"]},
        "long_rows": {"launch": "topk_sparse_long (rows over 4,096)",
                      "launches": total_launches("topk_sparse_long"),
                      "launches_by_path": by_path("topk_sparse_long"),
                      "launches_from": "the main-path runs (no ported "
                      "model has rows over 4,096); kernel_topk_long's "
                      "checks launch it apart",
                      "max_abs_err": _MAX_ERR["topk_sparse_long"],
                      "k": _TOPK_K, "slots": _TOPK_SLOTS,
                      **topk_long_times}})

    # K4 with the L2 flushed before each call (block 2's 20 MB input would
    # stay in the 50 MB L2 otherwise), the flush left out of the time
    scratch = torch.empty(_FLUSH_BYTES // 4, device=dev)

    def block_row(name, x_b, f, library):
        with torch.inference_mode():
            out = fused_inverted_residual(x_b, **f)
            k_t = cold_timed(lambda: fused_inverted_residual(x_b, **f), 20,
                             scratch.zero_)
            p_t = cold_timed(lambda: fused_inverted_residual_plain(x_b, **f),
                             10, scratch.zero_)
            l_t = cold_timed(library, 10, scratch.zero_)
        return {"block": name, "x": list(x_b.shape), "out": list(out.shape),
                "ms": k_t["ms"], "plain_ms": p_t["ms"],
                "library_ms": l_t["ms"], **block_bound(*block_work(
                    x_b, f, out)),
                "event_ms": k_t["event_ms"], "profiler_ms": k_t["profiler_ms"],
                "ms_from": k_t["ms_from"]}

    blocks = [block_row(f"v3l_{i}", native[i], folded[i],
                        lambda i=i: trunk.blocks[i](native[i]))
              for i in range(3)]
    other_rows = [block_row(name, x_o, f_o, lambda m=mod, x=x_o: m(x))
                  for name, (x_o, f_o, mod) in others.items()]
    b_sum = {key: sum(c[key] for c in blocks)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_fp32_fma_ms")}
    rows.append({
        "name": "fused_inverted_residual", "route": "cuda",
        "source": "demonet_tpu_torch/csrc/fused_block.cu",
        "replaces": "demonet_tpu/ops/fused_block.py:144",
        "launches": total_launches("fused_inverted_residual"),
        "launches_by_path": by_path("fused_inverted_residual"),
        "max_abs_err": max(e["max_abs_err"] for e in block_err[:3]),
        "tolerance": {"atol": _BLOCK_ATOL, "rtol": _BLOCK_RTOL}, **b_sum,
        "bound_by": "+".join(sorted({c["bound_by"] for c in blocks})),
        "bound": "max(bytes / 3.35 TB/s, 3 x 1x1-product operations / 495 "
                 "TFLOP/s, the rest / 67 TFLOP/s); bound_fp32_fma_ms: every "
                 "operation at 67 TFLOP/s",
        "l2": "flushed before each timed call",
        "library": "the port's unfused block (cuDNN convs, BN, activations) "
                   "on the same channels_last activations",
        "ptxas": ptxas_usage(_build.build_log("fused_block")),
        "per_pass": "blocks 0-2 at b32", "calls": blocks,
        "other_shapes": {"weights": "random He-like", "batch": b,
                         "max_abs_err": max(e["max_abs_err"]
                                            for e in block_err[3:]),
                         "calls": other_rows}})

    e2e = {}
    modes = {"reference": {}, "fused": {"impl": "fused"},
             "sparse_topk": {"topk_impl": "sparse_pallas"}}
    steps = {m: make_predict_step(trained, **kw) for m, kw in modes.items()}
    for bs, iters in ((32, 30), (128, 12)):
        x = torch.from_numpy(shapes_images(np.random.default_rng(bs),
                                           bs)[0]).to(dev)
        sz = torch.tensor([[480, 640]] * bs, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: trained.model(
                preprocess(x, cfg, resize=False)), 5)
            o = trained.model(preprocess(x, cfg, resize=False))
            sc_bs = detection._scores_and_boxes(
                o["cls_logits"], o["bbox_regression"], anchors, cfg)[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                detection._fused_capacity(sc_bs, cfg)
            guard_ms = (time.perf_counter() - t0) * 1e3 / 20
        for mode, kw in modes.items():
            step = steps[mode]
            for _ in range(3):
                step(trained.model, x, sz)
            torch.cuda.synchronize()
            branches.clear()
            per_batch = []
            for _ in range(iters):   # closed loop, one caller, batch by batch
                t0 = time.perf_counter()
                step(trained.model, x, sz)
                torch.cuda.synchronize()
                per_batch.append((time.perf_counter() - t0) * 1e3)
            q1, med, q3 = np.percentile(per_batch, [25, 50, 75])
            with torch.inference_mode():
                post_ms = cuda_ms(lambda: postprocess_detections(
                    o["cls_logits"], o["bbox_regression"], anchors, cfg, sz,
                    **kw), 5)
            e2e[f"{mode}_b{bs}"] = {
                "img_per_s": bs / med * 1e3, "ms_per_batch_median": med,
                "ms_per_batch_q1_q3": [q1, q3], "n": iters,
                "forward_ms": fwd_ms, "postprocess_ms": post_ms,
                **({"branches": dict(branches),
                    "guard_host_read_ms": guard_ms} if mode == "fused"
                   else {})}
    emit({"phase": "e2e", "weights": "trained", "images": "shapes, seeded",
          **e2e, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # where the device time of a b128 predict goes, and how idle it is
    for mode in ("reference", "fused"):
        tr = trace_calls(lambda: steps[mode](trained.model, x, sz))
        emit({"phase": "trace_b128", "mode": mode,
              "wall_ms_per_batch": tr["wall_ms"],
              "device_busy_ms_per_batch": tr["device_busy_ms"],
              "device_idle_share": tr["device_idle_share"],
              "top_kernels_ms": tr["top_kernels_ms"],
              "seconds_so_far": time.perf_counter() - t_start})

    # -- the other detector families, each path counted -------------------
    fam = families(reset_counts, read_counts)
    launches_by_path.update(fam["launches_by_path"])
    for r in rows:
        r["launches"] = total_launches(r["name"])
        r["launches_by_path"] = by_path(r["name"])
        if r["name"] != "fused_inverted_residual":
            r["family_shapes"] = fam["kernels"][r["name"]]
    long_row = next(r for r in rows if r["name"] == "topk_sparse")["long_rows"]
    check(all(launches_by_path[f"{n}/sparse_topk"]["topk_sparse_long"] > 0
              for n in ("ssd300_vgg16", "ssd512_vgg16")),
          "the long-row launch did not run on the VGG sparse top-k paths")
    long_row.update({
        "launches": total_launches("topk_sparse_long"),
        "launches_by_path": by_path("topk_sparse_long"),
        "launches_from": "the main-path runs: the VGG families' sparse "
                         "top-k paths, float32 and bf16; kernel_topk_long's "
                         "checks launch it apart",
        "max_abs_err": _MAX_ERR["topk_sparse_long"],
        "family_rows": fam["kernels"]["topk_sparse_long"]})

    # -- training: the train step and loop, card against the CPU ----------
    # the training path reaches no kernel (as in the JAX package); the
    # counts over its timed steps are recorded, and must stay 0
    train_check()
    reset_counts()
    train_out = train_e2e(read_counts)
    check(not any(read_counts().values()),
          f"the train step launched kernels: {read_counts()}")
    train_loop()
    cli_synthetic(reset_counts, read_counts)
    entry = entry_points(trained, batches, sizes, reset_counts, read_counts)
    launches_by_path.update(entry["launches_by_path"])
    # -- bf16 compute and remat: serving, training, the families, the CLI
    launches_by_path.update(bf16_serving(trained, batches, sizes,
                                         reset_counts, read_counts))
    reset_counts()
    bf16_training()
    check(not any(read_counts().values()),
          f"the bf16 train steps launched kernels: {read_counts()}")
    launches_by_path.update(bf16_families(reset_counts, read_counts))
    bf16_cli()
    # -- data parallelism: world 1 over NCCL, two ranks on the card, the CLI
    launches_by_path.update(distributed(trained, batches, sizes,
                                        reset_counts, read_counts))
    # -- torch.export artifacts: K1 and K2 inside the exported programs;
    # the C++ runner's build and packages compile beside this phase and
    # the next (CppPackaging)
    packaging = CppPackaging()
    try:
        packaging.start_build()
        launches_by_path.update(export_artifacts(
            trained, random_init, batches, reset_counts, read_counts,
            packaging=packaging))
        # -- the Caffe export: hand-built, generic, the CLI's --verify ----
        caffe_export(trained, reset_counts, read_counts)
        # -- the C++ runner: K1 and K2 launched from a process with no
        # Python
        launches_by_path.update(cpp_runner(trained, batches, packaging))
    finally:
        packaging.stop()
    for r in rows:
        r["launches"] = total_launches(r["name"])
        r["launches_by_path"] = by_path(r["name"])
    long_row.update(launches=total_launches("topk_sparse_long"),
                    launches_by_path=by_path("topk_sparse_long"))
    nms_row_main = next(r for r in rows if r["name"] == "nms_keep_batch")
    nms_row_main["public_api_shapes"] = {
        **entry["public_nms"], "max_abs_err": entry["public_nms_err"],
        "launches": launches_by_path["entry_points/public_nms"][
            "nms_keep_batch"] + launches_by_path[
            "entry_points/public_nms_long"]["nms_keep_batch"],
        "launches_from": "entry_points: nms_mask, nms and batched_nms, "
                         "one K1 launch each per case (P = 1, K = N), the "
                         f"long launch's at N = {max(_LONG_NMS_N)}"}

    # the shortest kernel the card runs: one float written by a fill,
    # timed as every kernel here is (device_ms)
    one = torch.empty(1, device=dev)
    launch_floor_ms = device_ms(lambda: one.fill_(1.0), 200)
    g_row = next(r for r in rows if r["name"] == "gather_rows_batch")
    g_row["launch_floor_ms"] = launch_floor_ms
    for fr in g_row["fused_path_shapes"].values():
        per_call = [c["ms"] for c in fr["calls"].values()]
        fr["max_call_ms_over_launch_floor"] = max(per_call) / launch_floor_ms
    emit({"phase": "launch_floor", "launch_floor_ms": launch_floor_ms,
          "kernel": "fill_ of one float32", "k2_fused_calls_ms": {
              r: [c["ms"] for c in fr["calls"].values()]
              for r, fr in g_row["fused_path_shapes"].items()}})

    emit({"phase": "timing", "seconds": time.perf_counter() - t_start,
          "train_img_per_s": {k: v["img_per_s"] for k, v in
                              train_out.items()}})
    emit({"phase": "previous_design", "constants": True,
          "not_measured_in_this_run": True,
          "what": "K1, K3 and K4 device ms before their redesign, b32",
          "source": "PERF.md section 6", "card": "NVIDIA H100 80GB HBM3, "
          "700.00 W", "ms": _PREVIOUS_MS})
    emit({"kernels": rows, "launch_floor_ms": launch_floor_ms})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
