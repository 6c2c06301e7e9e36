"""From a torch.profiler trace to busy time, top device operations and
idle gaps.

A traced segment records the card's activity alone (busy time, device
operations: recording the host's operations too costs the host several
microseconds an operation, which a launch-bound step would show as idle
device time), or the host's too, wrapped in `record_function(WINDOW)`
(idle gaps by what the host was doing). The window is the WINDOW range,
or without one the span from the first device interval to the last. Busy
time is the union of the device intervals (kernels, copies, fills)
clipped to it; an idle gap is a stretch of it that none covers, labelled
by the benchmark's own span at its middle and the innermost host
operation there.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOW = "portbench.window"
SPAN = "portbench."
Interval = Tuple[str, float, float]   # name, start and end in microseconds
_LABELLED_GAPS = 2000


def events_of(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host intervals) of a finished profiler."""
    device, host = [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CPU:
            host.append(iv)
        elif not e.name.startswith(SPAN):
            device.append(iv)
    return device, host


def _union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(mid: float, spans: List[Interval], host: List[Interval],
           starts: List[float]) -> str:
    """The benchmark's span and the innermost host operation around mid."""
    span = next((n[len(SPAN):] for n, s, e in reversed(spans)
                 if s <= mid <= e), "outside spans")
    op, op_start = "python", -1.0
    i = bisect.bisect_right(starts, mid)
    for name, s, e in reversed(host[max(0, i - 400):i]):
        if e >= mid and s > op_start:
            op, op_start = name, s
    return f"{span}/{op}"


def reduce(device: List[Interval], host: List[Interval]) -> Optional[dict]:
    """{'window_s', 'busy_s', 'kernels': {name: [seconds, count]},
    'device_ops': [[name, s]] (top 10), 'idle_gaps': [[label, s]] (top
    10)} of the window, or None if the trace has none."""
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if win:
        w0, w1 = win[0]
    elif device:
        w0, w1 = min(s for _, s, _ in device), max(e for _, _, e in device)
    else:
        return None
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if e > w0 and s < w1]
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for n, s, e in clipped:
        kernels[n][0] += (e - s) * 1e-6
        kernels[n][1] += 1
    busy = _union([(s, e) for _, s, e in clipped])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    spans = sorted((iv for iv in host if iv[0].startswith(SPAN)
                    and iv[0] != WINDOW), key=lambda iv: iv[1])
    host = sorted((iv for iv in host if not iv[0].startswith(SPAN)),
                  key=lambda iv: iv[1])
    starts = [s for _, s, _ in host]
    by_label: Dict[str, float] = collections.defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:_LABELLED_GAPS]:
        by_label[_label((s + e) / 2, spans, host, starts)] += (e - s) * 1e-6
    rest = sum(e - s for s, e in gaps[_LABELLED_GAPS:]) * 1e-6
    if rest:
        by_label["shorter gaps"] += rest
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "kernels": {n: list(v) for n, v in kernels.items()},
            "device_ops": [[n[:120], v[0]] for n, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                by_label.items(), key=lambda kv: -kv[1])[:10]]}


def span(name: str, on: bool):
    """A host span of the benchmark's own (a `record_function` range) when
    `on`, else nothing."""
    return (torch.autograd.profiler.record_function(SPAN + name) if on
            else contextlib.nullcontext())


def start(device, host: bool):
    """A started profiler of the card's activity (the host's too, in a
    WINDOW range, where `host`); `stop` ends it."""
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    rec = None
    if host:
        rec = torch.autograd.profiler.record_function(WINDOW)
        rec.__enter__()
    return prof, rec, device


def stop(started) -> Tuple[List[Interval], List[Interval]]:
    """End the segment once the device is done; its (device, host)
    intervals."""
    prof, rec, device = started
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    if rec is not None:
        rec.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return events_of(prof)


def traced(call, n: int, device, counts) -> Tuple[Optional[dict],
                                                  Dict[str, float]]:
    """Run call(spans) n times with the card's activity traced, then n
    times with the host's too (spans on). Returns the first trace reduced,
    with the idle gaps of the second, and the launches per call counted
    over the first."""
    started = start(device, host=False)
    counts.reset()
    for _ in range(n):
        call(False)
    summary = reduce(*stop(started))
    launches = counts.per_call(n)
    started = start(device, host=True)
    for _ in range(n):
        call(True)
    labelled = reduce(*stop(started))
    if summary is not None and labelled is not None:
        summary["idle_gaps"] = labelled["idle_gaps"]
    return summary, launches
