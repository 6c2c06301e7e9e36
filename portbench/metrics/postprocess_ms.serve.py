"""Device time from the end of the forward to the end of the predict step
(`postprocess_detections`), mean per request, by CUDA events."""

from harness import readings


def read(run):
    return readings.phase_mean(run, "serve", "postprocess")
