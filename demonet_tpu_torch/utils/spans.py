"""Named spans at the layer boundaries of the predict and train steps, on
the profiler's clock.

`span(name)` wraps one layer of a step (`demonet.predict`,
`demonet.model.head`, `demonet.postprocess.topk`, ...). With no torch
profiler recording it returns one shared no-op: the cost is two flag
reads (compiling? profiling?) and no allocation, so the spans stay in
the steps whatever runs them. Under `torch.export`, `torch.compile` and
the branches of `torch.cond` (which Dynamo traces) it is the no-op too,
read as a constant, and nothing of a span reaches a traced graph.

While a profiler records, a span

  * opens a `_RecordFunctionFast` range of its name: a CPU op on the
    profiler's own timeline, which the trace shows around the ops and
    launches it holds. It is not a user annotation
    (`record_function`'s kind), so the profiler adds no device-side row
    for it, and the union of a trace's device intervals is the kernels'
    alone;
  * appends one record to an in-memory list: its name, its parent (the
    span open around it), its call (the number of the outermost span it
    runs under), its host start and end (`perf_counter_ns`), and its
    device start and end: timing events on the current CUDA stream where
    CUDA is in use, else the host clock, as the device's work is the
    host's there.

`summary()` waits for the events once and gives each name's calls and its
host, device and self device milliseconds a call; `reset()` clears the
records. Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_profiling = torch._C._autograd._profiler_enabled
_compiling = torch.compiler.is_compiling


# the span while no profiler records, or while Dynamo traces
OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "parent", "call", "host0", "host1", "dev0", "dev1")


_records: List[_Record] = []
_open: List[_Record] = []
_calls = 0


def _device_mark():
    """A timing event on the current CUDA stream, or off CUDA the host
    clock in ms. `torch.Event` takes the current stream in C++;
    `torch.cuda.Event.record()` would first build a Python stream object,
    most of a mark's host cost."""
    if torch.cuda.is_initialized():
        ev = torch.Event(device="cuda", enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns() * 1e-6


class _On:
    """The span while a profiler records (see the module doc)."""

    __slots__ = ("name", "range", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _calls
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        rec = _Record()
        rec.name = self.name
        rec.parent = _open[-1] if _open else None
        if rec.parent is None:
            _calls += 1
            rec.call = _calls
        else:
            rec.call = rec.parent.call
        rec.host1 = rec.dev1 = None
        rec.dev0 = _device_mark()
        rec.host0 = time.perf_counter_ns()
        _records.append(rec)
        _open.append(rec)
        self.record = rec
        return None

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.host1 = time.perf_counter_ns()
        rec.dev1 = _device_mark()
        if _open and _open[-1] is rec:
            _open.pop()
        self.range.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager around one layer of a step: the shared no-op
    `OFF` unless a torch profiler is recording. Names begin `demonet.`."""
    if _compiling() or not _profiling():
        return OFF
    return _On(name)


def reset() -> None:
    """Forget every record (a span open now still closes cleanly)."""
    _records.clear()
    _open.clear()


# (name, parent's index or -1, call, host ms, device start ms, device end ms)
Row = Tuple[str, int, int, float, float, float]


def _rows(records: Sequence[_Record]) -> List[Row]:
    """The closed records with their device marks turned into ms on one
    axis: CUDA events as the time since the first record's start event."""
    done = [r for r in records if r.dev1 is not None]
    index = {id(r): i for i, r in enumerate(done)}
    base = next((r.dev0 for r in done if not isinstance(r.dev0, float)),
                None)
    if base is not None:
        torch.cuda.synchronize()

    def ms(mark) -> float:
        return mark if isinstance(mark, float) else base.elapsed_time(mark)

    return [(r.name, index.get(id(r.parent), -1), r.call,
             (r.host1 - r.host0) * 1e-6, ms(r.dev0), ms(r.dev1))
            for r in done]


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def tally(rows: Sequence[Row]) -> Dict[str, dict]:
    """{name: {'calls', 'host_ms', 'device_ms', 'self_device_ms'}} of
    rows: `calls` the outermost spans the name ran under, the times summed
    over its rows and divided by them, so a call's. A row's self device
    time is its device time less the union of its children's, each
    clipped to it."""
    kids: Dict[int, List[Tuple[float, float]]] = {}
    for name, parent, call, host, s, e in rows:
        if parent >= 0:
            kids.setdefault(parent, []).append((s, e))
    out: Dict[str, dict] = {}
    calls: Dict[str, set] = {}
    for i, (name, parent, call, host, s, e) in enumerate(rows):
        inner = [(max(a, s), min(b, e)) for a, b in kids.get(i, [])
                 if b > s and a < e]
        t = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                  "device_ms": 0.0, "self_device_ms": 0.0})
        t["host_ms"] += host
        t["device_ms"] += e - s
        t["self_device_ms"] += (e - s) - _union(inner)
        calls.setdefault(name, set()).add(call)
    for name, t in out.items():
        n = t["calls"] = len(calls[name])
        for k in ("host_ms", "device_ms", "self_device_ms"):
            t[k] /= n
    return out


def summary() -> Dict[str, dict]:
    """`tally` of the records so far: each span's calls, and its host,
    device and self device ms a call. Waits once for the device."""
    return tally(_rows(_records))


def records() -> List[Tuple[str, Optional[str], int]]:
    """(name, parent's name or None, call) of each record, in the order
    the spans opened."""
    return [(r.name, r.parent.name if r.parent is not None else None,
             r.call) for r in _records]
