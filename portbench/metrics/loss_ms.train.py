"""Device time of `models/losses.py::multibox_loss` (matching, mining,
the terms) in the train step, mean per step: CUDA events put by the
step's own `on_phase` hook."""

from harness import readings


def read(run):
    return readings.phase_mean(run, "train", "loss")
