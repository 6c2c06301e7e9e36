"""Training throughput of a cell whose step the host's launch rate paces:
the images of every step the window ran, over the window, which ends when
the device has finished them."""

from harness import readings


def read(run):
    return readings.window_rate(run, "train")
