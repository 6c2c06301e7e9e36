"""What the program records of itself, read in the run's own process after
the window: the spans of its steps (`demonet_tpu_torch.utils.spans`) and
the seconds its kernel libraries took to build and load
(`demonet_tpu_torch.ops._build.seconds`).

The spans record only while a torch profiler runs: in a traced run, the
`trace.traced` segments after the window (both of them), so the readers
see those calls alone, nothing of the set-up or the untraced window. A
program without the recorder or the counter (an older tree) reads None,
and the run leaves the metric out.
"""

from __future__ import annotations

from typing import Optional

_UNREAD = object()


def summary(run) -> Optional[dict]:
    """The span summary of the run's traced calls, {name: {'calls',
    'host_ms', 'device_ms', 'self_device_ms'}} (ms a call), or None where
    the program has no recorder or recorded nothing. Read once a run and
    kept on it; the records are then cleared, so that a later run in the
    same process starts from none."""
    got = getattr(run, "program_spans", _UNREAD)
    if got is _UNREAD:
        try:
            from demonet_tpu_torch.utils import spans
        except ImportError:
            got = None
        else:
            got = spans.summary() or None
            spans.reset()
        run.program_spans = got
    return got


def device_ms(run, entry: str, name: str) -> Optional[float]:
    """Device ms a call (a request or a step) of the span `name`."""
    if run.entry != entry:
        return None
    row = (summary(run) or {}).get(name)
    return row["device_ms"] if row else None


def kernel_build_s(run) -> Optional[float]:
    """Seconds this process spent building (nvcc) and loading (ctypes) the
    program's kernel libraries: 0.0 where it used none."""
    try:
        from demonet_tpu_torch.ops import _build
    except ImportError:
        return None
    secs = getattr(_build, "seconds", None)
    if secs is None:
        return None
    return sum(v["build_s"] + v["load_s"] for v in secs.values())
