#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is flagship inference: ssdlite320_mobilenet_v3_large
(91 classes, 320x320, fp32) predict with the reference postprocess,
through `make_predict_step`, with the trained weights of
bench_assets/ssdlite320_shapes_trained.npz loaded by `load_jax_variables`.
The script prints one JSON line per phase:

  device     card, power limit, torch/CUDA versions; TF32 turned off
  build      nvcc of csrc/*.cu, all sources at once, and ptxas's report
  kernel_*   each hand-written kernel against its plain PyTorch version on
             the main path's inputs and shapes (B = 32: NMS over
             P = 32 * 90 problems of K = 300; gathers 3,234 -> 27,000 and
             27,000 -> 300 rows), and NMS edge cases; bit-equal or fail
  main_path  4 requests of 32 images; launch counts reset just before and
             read just after: 1 NMS and 2 gathers per batch, or fail
  reference  the card's head outputs against the CPU's on 2 images, and
             the postprocess through the kernels against the plain
             versions on the same head outputs, bit-equal
  e2e        predict img/s at b32 and b128, with a forward/postprocess split

then the `kernels` line (time, bound, plain and library time of each
kernel), the card line from nvidia-smi, and the last line
{"ok": true, "device": {...}}. Any failed check raises, and the exit code
is not 0. Without a CUDA device it exits with 2 before printing anything.
"""

import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_NPZ = os.path.join(_HERE, "bench_assets", "ssdlite320_shapes_trained.npz")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
_HBM_BYTES_PER_S = 3.35e12
_FP32_OPS_PER_S = 67e12
# f32 operations per IoU test in csrc/nms.cu: 2 min, 2 max, 2 sub, 2 clamp,
# mul, add, sub, max, div, compare
_OPS_PER_IOU = 14


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def device_ms(fn, iters):
    """Mean device time of the kernels fn() launches, in ms, summed from a
    torch.profiler trace; None if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us else None


def timed(fn, iters, warmup=2):
    """{'ms': device time (event time if the profiler saw none),
    'event_ms': CUDA-event time}."""
    ev = cuda_ms(fn, iters, warmup)
    dev = device_ms(fn, iters)
    return {"ms": dev if dev is not None else ev, "event_ms": ev,
            "ms_from": "profiler" if dev is not None else "events"}


def shapes_images(rng, b, size=320):
    """Noise backgrounds with 1-4 filled rectangles: the kind of frame the
    trained 'shapes' weights detect things in."""
    import numpy as np

    imgs = rng.integers(0, 60, (b, size, size, 3)).astype(np.uint8)
    for img in imgs:
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = rng.integers(size // 8, size // 2, 2)
            x0, y0 = rng.integers(0, size - bw), rng.integers(0, size - bh)
            img[y0:y0 + bh, x0:x0 + bw] = rng.integers(40, 256, 3)
    return imgs


def head_to_candidates(det, outputs):
    """The main path's postprocess up to the NMS: scores, boxes, and the
    per-(image, class) candidates with the gather indices that made them."""
    import torch

    from demonet_tpu_torch.models import detection

    cfg = det.config
    anchors = torch.as_tensor(det.anchors, device=det.device)
    scores, boxes = detection._scores_and_boxes(
        outputs["cls_logits"], outputs["bbox_regression"], anchors, cfg)
    b, a, c = scores.shape
    k = min(cfg.topk_candidates, a)
    _, top_idx = detection._sorted_topk(scores[..., 1:].transpose(1, 2), k)
    cand_boxes, cand_sc = detection._select_candidates(
        scores, boxes, cfg, "exact", "auto")
    return {
        "boxes": boxes, "top_idx": top_idx.reshape(b, -1).to(torch.int32),
        "cand_boxes": cand_boxes.reshape(b * (c - 1), k, 4).contiguous(),
        "cand_sc": cand_sc.reshape(b * (c - 1), k).contiguous(),
    }


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


def bound(nbytes, ops):
    t_bytes = nbytes / _HBM_BYTES_PER_S * 1e3
    t_ops = ops / _FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    import numpy as np

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
    from demonet_tpu_torch.models.detection import (
        _NEG_INF,
        postprocess_detections,
        preprocess,
    )
    from demonet_tpu_torch.ops import _build
    from demonet_tpu_torch.ops.gather import (
        gather_rows_batch,
        gather_rows_batch_plain,
    )
    from demonet_tpu_torch.ops.nms import nms_keep_batch, nms_keep_batch_plain
    from demonet_tpu_torch.utils.weights import load_jax_variables

    t_start = time.perf_counter()
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
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # -- build -------------------------------------------------------------
    secs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "Compiling entry" in ln]
             for name in secs}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})

    thr = _NEG_INF / 2
    iou = 0.55
    b = 32
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(shapes_images(rng, b)).to(dev)
               for _ in range(4)]
    sizes = torch.tensor([[480, 640]] * b, dtype=torch.int32, device=dev)

    trained = ssdlite320_mobilenet_v3_large(num_classes=91)
    with np.load(_NPZ) as z:
        load_jax_variables(trained.model, {k: z[k] for k in z.files})
    random_init = ssdlite320_mobilenet_v3_large(num_classes=91, seed=0)

    # -- kernels against their plain versions at the main path's shapes ----
    regimes = {}
    with torch.inference_mode():
        for name, det in (("trained", trained), ("random", random_init)):
            out = det.model(preprocess(batches[0], det.config, resize=False))
            regimes[name] = (out, head_to_candidates(det, out))
    for name, (_, cand) in regimes.items():
        boxes, sc = cand["cand_boxes"], cand["cand_sc"]
        k_keep = nms_keep_batch(boxes, sc, iou, thr)
        p_keep = nms_keep_batch_plain(boxes, sc, iou, thr)
        torch.cuda.synchronize()
        check(torch.equal(k_keep, p_keep),
              f"NMS kernel != plain on the {name} candidates "
              f"({int((k_keep != p_keep).sum())} entries differ)")
        emit({"phase": "kernel_nms", "regime": name,
              "problems": list(sc.shape), "bit_equal": True,
              "valid": int((sc > thr).sum()), "kept": int(k_keep.sum())})

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
    for name, (bx, sc, t) in edge.items():
        bx = torch.tensor(bx, dtype=torch.float32, device=dev)
        sc = torch.tensor(sc, dtype=torch.float32, device=dev)
        got = nms_keep_batch(bx, sc, t, thr)
        check(torch.equal(got, nms_keep_batch_plain(bx, sc, t, thr))
              and got[0].tolist() == expect[name], f"NMS edge case {name}")
    emit({"phase": "kernel_nms_edges", "cases": sorted(edge), "ok": True})

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
    for name, (table, idx) in gather_cases.items():
        for cm in (False, True):
            got = gather_rows_batch(table, idx, coord_major=cm)
            want = gather_rows_batch_plain(table, idx, coord_major=cm)
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"gather kernel != plain on {name}, coord_major={cm}")
        emit({"phase": "kernel_gather", "case": name,
              "table": list(table.shape), "idx": list(idx.shape),
              "layouts": ["row", "coord_major"], "bit_equal": True})

    # -- main path: 4 requests of 32 through the user's entry point --------
    step = make_predict_step(trained)
    step(trained.model, batches[0], sizes)  # warm-up, outside the count
    torch.cuda.synchronize()
    nms_keep_batch.launches = 0
    gather_rows_batch.launches = 0
    dets = [step(trained.model, x, sizes) for x in batches]
    torch.cuda.synchronize()
    launches = {"nms_keep_batch": nms_keep_batch.launches,
                "gather_rows_batch": gather_rows_batch.launches}
    check(launches == {"nms_keep_batch": 4, "gather_rows_batch": 8},
          f"launch counts {launches}, want 1 NMS and 2 gathers per batch")
    n_valid = []
    for d in dets:
        check(d["boxes"].shape == (b, 300, 4) and d["scores"].shape == (b, 300)
              and d["labels"].shape == (b, 300) and d["valid"].shape == (b, 300)
              and d["labels"].dtype == torch.int32
              and d["valid"].dtype == torch.bool, "detection shapes/dtypes")
        check(bool(torch.isfinite(d["boxes"]).all())
              and bool(torch.isfinite(d["scores"]).all()), "finite outputs")
        v = d["valid"]
        check(bool((d["scores"][v] > 0.001).all())
              and bool((d["labels"][v] >= 1).all())
              and bool((d["labels"][v] <= 90).all()), "valid detections")
        n_valid.append(int(v.sum()))
    emit({"phase": "main_path", "batches": len(batches), "batch": b,
          "launches": launches, "valid_detections": n_valid})

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
    anchors = torch.as_tensor(trained.anchors, device=dev)
    with torch.inference_mode():
        pp = {impl: postprocess_detections(
            out_main["cls_logits"], out_main["bbox_regression"], anchors,
            trained.config, sizes, nms_impl=impl, gather_impl=impl)
            for impl in ("auto", "plain")}
    for key in pp["auto"]:
        check(torch.equal(pp["auto"][key], pp["plain"][key]),
              f"postprocess through kernels != plain in {key}")
    emit({"phase": "reference", "head_max_abs_err_vs_cpu": head_err,
          "head_limit": 1e-3, "postprocess_kernels_vs_plain": "bit-equal"})

    # -- timings at the main path's shapes ---------------------------------
    rows = []
    nms_rows = {}
    for name, (_, c) in regimes.items():
        bx, sc = c["cand_boxes"], c["cand_sc"]
        keep = nms_keep_batch(bx, sc, iou, thr)
        nbytes, ops = nms_work(keep, sc, thr)
        bms, by = bound(nbytes, ops)
        k_t = timed(lambda: nms_keep_batch(bx, sc, iou, thr), 50)
        p_t = timed(lambda: nms_keep_batch_plain(bx, sc, iou, thr), 3, 1)
        nms_rows[name] = {
            "ms": k_t["ms"], "plain_ms": p_t["ms"], "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "event_ms": k_t["event_ms"], "plain_event_ms": p_t["event_ms"],
            "ms_from": k_t["ms_from"]}
    main = nms_rows["trained"]
    rows.append({
        "name": "nms_keep_batch", "route": "cuda",
        "source": "demonet_tpu_torch/csrc/nms.cu",
        "replaces": "demonet_tpu/ops/nms_pallas.py:80",
        "launches": launches["nms_keep_batch"], "max_abs_err": 0.0,
        "bit_equal": True, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "shape": [b * 90, 300],
        "dense_random_weights": nms_rows["random"]})

    calls = {}
    for name in ("candidate", "final"):
        table, idx = gather_cases[name]
        idx64 = idx.long()[..., None].expand(-1, -1, 4)
        nbytes = gather_bytes(table, idx, idx.numel() * 4)
        k_t = timed(lambda: gather_rows_batch(table, idx), 200)
        p_t = timed(lambda: gather_rows_batch_plain(table, idx), 200)
        l_t = timed(lambda: torch.gather(table, 1, idx64), 200)
        calls[name] = {
            "table": list(table.shape), "idx": list(idx.shape),
            "ms": k_t["ms"], "plain_ms": p_t["ms"], "library_ms": l_t["ms"],
            "bound_ms": bound(nbytes, 0)[0], "bytes": nbytes,
            "event_ms": k_t["event_ms"], "ms_from": k_t["ms_from"]}
    total = {key: sum(c[key] for c in calls.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rows.append({
        "name": "gather_rows_batch", "route": "cuda",
        "source": "demonet_tpu_torch/csrc/gather.cu",
        "replaces": "demonet_tpu/ops/gather_pallas.py:86",
        "launches": launches["gather_rows_batch"], "max_abs_err": 0.0,
        "bit_equal": True, **total, "bound_by": "bytes",
        "per_predict": "candidate + final gather", "calls": calls})

    e2e = {}
    for bs, iters in ((32, 30), (128, 12)):
        x = torch.from_numpy(shapes_images(np.random.default_rng(bs), bs)).to(
            dev)
        sz = torch.tensor([[480, 640]] * bs, dtype=torch.int32, device=dev)
        for _ in range(3):
            step(trained.model, x, sz)
        torch.cuda.synchronize()
        per_batch = []
        for _ in range(iters):   # closed loop, one caller, batch after batch
            t0 = time.perf_counter()
            step(trained.model, x, sz)
            torch.cuda.synchronize()
            per_batch.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(per_batch, [25, 50, 75])
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: trained.model(
                preprocess(x, trained.config, resize=False)), 5)
            o = trained.model(preprocess(x, trained.config, resize=False))
            post_ms = cuda_ms(lambda: postprocess_detections(
                o["cls_logits"], o["bbox_regression"], anchors,
                trained.config, sz), 5)
        e2e[f"b{bs}"] = {
            "img_per_s": bs / med * 1e3, "ms_per_batch_median": med,
            "ms_per_batch_q1_q3": [q1, q3], "n": iters,
            "forward_ms": fwd_ms, "postprocess_ms": post_ms}
    emit({"phase": "e2e", "weights": "trained", "images": "shapes, seeded",
          **e2e, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # where the device time of a b128 predict goes, and how idle it is
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(trained.model, x, sz)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    per_kernel = sorted(
        ((getattr(e, "device_time_total", None)
          or getattr(e, "cuda_time_total", 0)) / 3e3, e.key[:60])
        for e in prof.key_averages())[::-1]
    busy_ms = sum(t for t, _ in per_kernel)
    emit({"phase": "trace_b128", "wall_ms_per_batch": wall_ms,
          "device_busy_ms_per_batch": busy_ms,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
          "top_kernels_ms": [[k, t] for t, k in per_kernel[:10]],
          "seconds_so_far": time.perf_counter() - t_start})

    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
