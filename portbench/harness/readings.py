"""What the metric readers in `portbench/metrics/` share: each reader
names the entry its cells run and takes one of these. A reading that
finds nothing to read is None, and the run leaves that metric out."""

from __future__ import annotations

from typing import Optional


def window_rate(run, entry: str) -> Optional[float]:
    """Images of every request or step of the window, over the window."""
    if run.entry != entry:
        return None
    return run.images / run.window_s


def step_host_ms(run, entry: str) -> Optional[float]:
    """Host time inside the program's step call, mean per call."""
    if run.entry != entry:
        return None
    return run.mean(run.step_host_s) * 1e3


def phase_mean(run, entry: str, phase: str) -> Optional[float]:
    """Device time of one phase of the step, mean per call (traced runs)."""
    if run.entry != entry or not run.phase_ms:
        return None
    return run.mean(run.phase_ms[phase])


def idle_pct(run, entry: str) -> Optional[float]:
    """Share of the traced span in which no kernel, copy or fill ran."""
    s = run.trace_summary
    if run.entry != entry or not s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(run, entry: str) -> Optional[float]:
    """The reference's model FLOPs per image (flops.py) times the images
    of the window, over the window, over the peak of the cell's compute
    dtype (traced runs)."""
    if run.entry != entry or not run.trace_summary:
        return None
    return (100.0 * run.flops_per_image * run.images / run.window_s
            / run.peak_flops)
