"""Serving throughput: the images of every request whose detections reached
the host, over the whole window."""

from harness import readings


def read(run):
    return readings.window_rate(run, "serve")
