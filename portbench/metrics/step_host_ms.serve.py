"""Host time inside the program's serve step call, mean per call: the
host's issue time where the step does not wait for the device."""

from harness import readings


def read(run):
    return readings.step_host_ms(run, "serve")
