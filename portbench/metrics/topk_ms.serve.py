"""Device time of the postprocess's per-class top-k (the stable sort, or K3),
mean per request of the traced calls: the program's span
`demonet.postprocess.topk` (harness/program_spans.py)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, "serve", "demonet.postprocess.topk")
