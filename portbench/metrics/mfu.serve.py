"""The whole step's share of the card's peak: the reference's model FLOPs
per image (flops.py; forward, and for training the backward too) times
the images of the window, over the window, over the peak of the cell's
compute dtype."""

from harness import readings


def read(run):
    return readings.mfu(run, "serve")
