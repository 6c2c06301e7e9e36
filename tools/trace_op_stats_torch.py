#!/usr/bin/env python
"""Summarize a torch.profiler trace of the PyTorch port
(tools/profile_model_torch.py output) into device time per kernel
category: the twin of tools/trace_op_stats.py.

Reads the newest `*.pt.trace.json[.gz]` under LOGDIR (Chrome trace
format). Device events are the events of category `kernel`, `gpu_memcpy`
and `gpu_memset`; a trace with none (one taken on the CPU) is refused.
Prints the device busy ms per iteration and the device's idle share over
the traced window (from the first host event to the last device or
runtime event; the profiler's own host work, shapes and flops recorded,
is in that window, so a host-bound step reads idler here than in a
closed loop), a rollup by category (convolutions and matrix products;
each of the four hand-written kernels K1-K4, by the `__global__` names
of demonet_tpu_torch/csrc/*.cu; batch norm (PyTorch's and cuDNN's
kernels); sort and select; reduction; copies; elementwise; other) with
achieved TFLOP/s, the top `--top` kernels, and last one JSON line with
the same numbers.

Flops: the profiler's `with_flops` count of an `aten::` op (`flops` on its
event) goes to the kernels launched inside that op's span on its thread
(the runtime's launch event, linked to its kernel by `correlation`), to
its product kernels if it launched any, else to all of them, each in
proportion to its device time. An op inside another op that carries
flops takes them, not the outer op. The profiler counts products and
elementwise `mul`/`add` in the forward; the backward's convolutions
carry no count, so a train step's TFLOP/s reads low.

    python tools/profile_model_torch.py --mode train --batch-size 32 \
        --bf16 --iters 5 --logdir runs/trace
    python tools/trace_op_stats_torch.py runs/trace --iters 5 [--top 40]

CPU-only (JSON parsing; touches no card).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import functools
import glob
import gzip
import json
import os
import re
import sys

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the hand-written kernels by their __global__ names in
# demonet_tpu_torch/csrc/*.cu, and the names that run once a launch of
# the wrapper (K1's tiled and long launches are a mask kernel and a sweep)
HAND_WRITTEN = {
    "nms_keep_batch": ("nms_block_kernel", "nms_mask_kernel",
                       "nms_sweep_kernel", "nms_sweep_long_kernel"),
    "gather_rows_batch": ("gather_rows_kernel",
                          "gather_rows_coord_major_kernel"),
    "topk_sparse": ("topk_sparse_kernel", "topk_sparse_long_kernel",
                    "topk_sparse_classes_kernel"),
    "fused_inverted_residual": ("fused_block_kernel",),
}
ONE_PER_LAUNCH = {
    "nms_keep_batch": ("nms_block_kernel", "nms_sweep_kernel",
                       "nms_sweep_long_kernel"),
    "gather_rows_batch": HAND_WRITTEN["gather_rows_batch"],
    "topk_sparse": HAND_WRITTEN["topk_sparse"],
    "fused_inverted_residual": HAND_WRITTEN["fused_inverted_residual"],
}
PRODUCTS = "convolution and matrix products"
_RULES = (
    ("batch norm", re.compile(r"batch_norm|\bbn_|::bn_", re.I)),
    (PRODUCTS, re.compile(
        r"cudnn|xmma|cutlass|gemm|nvjet|conv2d|convolve|implicit|winograd|"
        r"fft|dgrad|wgrad|fprop", re.I)),
    ("sort and select", re.compile(r"sort|radix|topk", re.I)),
    ("reduction", re.compile(r"reduce|welford|softmax|scan", re.I)),
    ("copies", re.compile(r"copy|cat_|catarray|transpose|permute", re.I)),
    ("elementwise", re.compile(r"elementwise|functor", re.I)),
)
_BASE = re.compile(r"^(?:void\s+)?(?:(?:\w+|\(anonymous namespace\))::)*(\w+)")


@functools.lru_cache(maxsize=None)
def base_name(name: str) -> str:
    """A kernel's identifier without return type, namespaces (the csrc
    kernels sit in an anonymous one), template arguments and arguments."""
    m = _BASE.match(name.strip())
    return m.group(1) if m else name


@functools.lru_cache(maxsize=None)
def _kernel_category(name: str) -> str:
    base = base_name(name)
    for kernel, names in HAND_WRITTEN.items():
        if base in names:
            return kernel
    for cat, rule in _RULES:
        if rule.search(name):
            return cat
    return "other"


def category(event) -> str:
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copies"
    return _kernel_category(event.get("name", ""))


def find_trace(logdir: str) -> str:
    paths = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pat),
                                recursive=True)]
    if not paths:
        raise SystemExit(f"no *.pt.trace.json[.gz] under {logdir}")
    return max(paths, key=os.path.getmtime)


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return [e for e in data["traceEvents"] if e.get("ph") == "X"]


def _innermost(ops):
    """The ops (ts, end, flops) that hold no other op of the list: ops of
    one thread nest or are disjoint, so an op holds another exactly when
    the next one in (start, -end) order starts inside it."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    return [o for o, nxt in zip(ops, ops[1:] + [None])
            if nxt is None or nxt[0] >= o[1]]


def attribute_flops(events, device):
    """{id(kernel event): flops} from the ops that carry a flop count."""
    by_corr = {}
    for e in device:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append(e)
    launches = collections.defaultdict(list)
    ops = collections.defaultdict(list)
    for e in events:
        cat, a = e.get("cat"), e.get("args", {})
        if cat in _RUNTIME_CATEGORIES and a.get("correlation") is not None:
            launches[(e["pid"], e["tid"])].append((e["ts"], a["correlation"]))
        elif cat == "cpu_op" and a.get("flops"):
            ops[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], float(a["flops"])))
    got = collections.Counter()
    for thread, thread_ops in ops.items():
        runs = sorted(launches.get(thread, ()))
        starts = [t for t, _ in runs]
        for t0, t1, flops in _innermost(thread_ops):
            lo, hi = bisect.bisect_left(starts, t0), bisect.bisect_right(
                starts, t1)
            kernels = [k for _, c in runs[lo:hi] for k in by_corr.get(c, ())]
            products = [k for k in kernels if category(k) == PRODUCTS]
            kernels = products or kernels
            total = sum(k["dur"] for k in kernels)
            for k in kernels:
                got[id(k)] += flops * (k["dur"] / total if total
                                       else 1.0 / len(kernels))
    return got


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def summarize(path: str, iters: int, top: int = 30) -> dict:
    """The numbers the tool prints, as one dict."""
    events = load_events(path)
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise SystemExit(
            f"{path} holds no device events ({', '.join(DEVICE_CATEGORIES)})"
            ": a trace taken on the CPU has nothing to summarize")
    flops = attribute_flops(events, device)
    busy = sum(e["dur"] for e in device)
    host = [e for e in events if e.get("cat") in ("cpu_op",)
            + _RUNTIME_CATEGORIES]
    t0 = min(e["ts"] for e in host + device)
    t1 = max(e["ts"] + e["dur"] for e in device
             + [e for e in host if e.get("cat") in _RUNTIME_CATEGORIES])
    window = t1 - t0
    union = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in device])

    def tflops(fl, us):
        return fl / (us * 1e-6) / 1e12 if us and fl else None

    cats = collections.defaultdict(lambda: [0.0, 0.0, 0])
    kernels = collections.defaultdict(lambda: [0.0, 0.0, 0, ""])
    for e in device:
        c = cats[category(e)]
        c[0] += e["dur"]
        c[1] += flops.get(id(e), 0.0)
        c[2] += 1
        k = kernels[e["name"]]
        k[0] += e["dur"]
        k[1] += flops.get(id(e), 0.0)
        k[2] += 1
        k[3] = category(e)
    hand = {name: sum(1 for e in device if base_name(e["name"]) in names)
            / iters for name, names in ONE_PER_LAUNCH.items()}
    flops_total = sum(flops.values())
    return {
        "trace": path, "iters": iters, "device_events": len(device),
        "device_busy_ms_per_iter": busy / 1e3 / iters,
        "device_idle_share": 1.0 - union / window if window else None,
        "window_ms_per_iter": window / 1e3 / iters,
        "gflop_per_iter": flops_total / 1e9 / iters,
        "tflops_per_s": tflops(flops_total, busy),
        "categories": {
            name: {"ms_per_iter": us / 1e3 / iters, "share": us / busy,
                   "launches_per_iter": n / iters,
                   "gflop_per_iter": fl / 1e9 / iters,
                   "tflops_per_s": tflops(fl, us)}
            for name, (us, fl, n) in sorted(cats.items(),
                                            key=lambda kv: -kv[1][0])},
        "hand_written_launches_per_iter": hand,
        "top": [{"name": name, "category": cat,
                 "ms_per_iter": us / 1e3 / iters, "share": us / busy,
                 "launches_per_iter": n / iters,
                 "tflops_per_s": tflops(fl, us)}
                for name, (us, fl, n, cat) in sorted(
                    kernels.items(), key=lambda kv: -kv[1][0])[:top]],
    }


def _tf(v):
    return f"{v:7.2f}" if v is not None else "      -"


def main(args) -> dict:
    s = summarize(find_trace(args.logdir), args.iters, args.top)
    print(f"{s['trace']}: {s['device_events']} device events; device busy "
          f"{s['device_busy_ms_per_iter']:.3f} ms/iter over "
          f"{s['window_ms_per_iter']:.3f} ms/iter traced "
          f"(idle share {s['device_idle_share']:.3f}; {args.iters} iters); "
          f"{s['gflop_per_iter']:.2f} GFLOP/iter attributed")
    print("\nby category:                        ms/iter  share  "
          "launches/iter  TFLOP/s")
    for name, c in s["categories"].items():
        print(f"  {name:32s} {c['ms_per_iter']:8.3f} {100 * c['share']:5.1f}% "
              f"{c['launches_per_iter']:9.1f}     {_tf(c['tflops_per_s'])}")
    print("\nhand-written kernels, launches per iteration: " + ", ".join(
        f"{k} {v:g}" for k, v in s["hand_written_launches_per_iter"].items()))
    print(f"\ntop {args.top} kernels by device time:")
    for k in s["top"]:
        print(f"  {k['ms_per_iter']:8.3f} ms ({100 * k['share']:4.1f}%) "
              f"{_tf(k['tflops_per_s'])} TF/s x{k['launches_per_iter']:<5g} "
              f"{k['category'][:12]:12s} {k['name'][:90]}")
    print(json.dumps(s), flush=True)
    return s


def get_args_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("logdir", help="the directory the trace is under")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--iters", type=int, default=5,
                   help="iterations captured inside the trace")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
    sys.exit(0)
