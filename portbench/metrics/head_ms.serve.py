"""Device time of the model's head (its convs and the flattening of its
levels) inside the predict step, mean per request of the traced calls: the
program's span `demonet.model.head` (harness/program_spans.py)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, "serve", "demonet.model.head")
