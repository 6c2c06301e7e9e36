"""Device time of the SSD forward inside the predict step, mean per request:
CUDA events from a forward pre-hook and a forward hook on the program's
model."""

from harness import readings


def read(run):
    return readings.phase_mean(run, "serve", "forward")
