"""Share of the traced window in which no kernel, copy or fill ran on the
device (the union of their intervals, from torch.profiler)."""

from harness import readings


def read(run):
    return readings.idle_pct(run, "train")
