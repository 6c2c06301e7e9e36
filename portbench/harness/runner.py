"""One run of one cell: set-up, the measured window, the comparison, the
metrics; the result line is assembled here and printed by `run.py`."""

from __future__ import annotations

import math
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

import flops
from harness import isolation, manifest, program, work
from harness.serve import Serve
from harness.train import Train

ENTRIES = {"serve": Serve, "train": Train}


class Run:
    """What a run measured, for the metric readers: `cell`, `entry`,
    `setup_s`, `window_s`, `images`, `attempted`, `failed`,
    `step_host_s` (seconds per call), and with tracing on `phase_ms`
    ({phase: [ms per call]}), `trace_summary` (`trace.reduce`),
    `launches` (K1/K2/K3 per call), `k1_bound_ms`, `flops_per_image`,
    `peak_flops`; `latencies_s` for serving, `steps` for training."""

    def __init__(self, cell: dict, trace: bool):
        self.cell, self.trace = cell, trace
        self.entry = cell["traffic"]["entry"]
        self.trace_summary: Optional[dict] = None
        self.launches: Dict[str, float] = {}
        self.phase_ms: Dict[str, List[float]] = {}
        self.k1_bound_ms: Optional[float] = None

    def mean(self, values: List[float]) -> Optional[float]:
        return statistics.fmean(values) if values else None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name, finite and within its limit."""
    return set(numbers) >= set(limits) and all(
        math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def run(bench: dict, name: str, seed: int, seconds: float, trace: bool,
        t0: float, device="cuda", wrap_step: Optional[Callable] = None,
        tweak: Optional[Callable[[dict], None]] = None) -> dict:
    """Run cell `name`; returns {'result': the contract's line, 'info':
    what goes on earlier lines, 'checks': {number: (value, limit)}}.
    `wrap_step` wraps the program's step (a planted fault, in tests);
    `tweak` edits the cell once read (smaller sizes, in tests)."""
    cell = manifest.cell(bench, name)
    if tweak is not None:
        tweak(cell)
    program.set_fp32_exact()
    side = ENTRIES[cell["traffic"]["entry"]](cell, seed, device, trace,
                                             wrap_step)
    r = Run(cell, trace)
    r.setup_s = time.perf_counter() - t0
    side.window(r, seconds)
    peak = side.clock.memory_peak()
    if trace:
        r.flops_per_image = flops.flops_per_image(cell["config"], r.entry)
        r.peak_flops = work.PEAK_FLOPS[cell["dtype"]]
    numbers = side.check(r)
    # a request or step that failed (a train step's loss not finite)
    numbers["failed"] = float(r.failed)
    limits = dict(cell["limits"], failed=0)
    metrics = manifest.read_metrics(bench, name, trace, r)
    dev = {"platform": "gpu" if side.clock.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(0) if side.clock.cuda
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": judge(numbers, limits), "attempted": r.attempted,
              "failed": r.failed, "metrics": metrics, "device": dev}
    s = r.trace_summary
    if trace and s is not None:
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    checks = {k: (numbers.get(k, float("nan")), limits[k]) for k in limits}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    info = {"cell": name, "seed": seed, "seconds": seconds, "trace": trace,
            "dtype": cell["dtype"],
            "card": power_limit() if side.clock.cuda else "cpu",
            "setup_s": r.setup_s, "window_s": r.window_s,
            "calls": r.attempted, "launches_per_call": r.launches,
            "k1_bound_ms": r.k1_bound_ms, "numbers": numbers,
            "forbidden_modules": isolation.forbidden_modules()}
    return {"result": result, "info": info, "checks": checks}
