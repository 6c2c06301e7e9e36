"""Device time of the postprocess's decode (softmax, box decode and clip),
mean per request of the traced calls: the program's span
`demonet.postprocess.decode` (harness/program_spans.py)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, "serve", "demonet.postprocess.decode")
