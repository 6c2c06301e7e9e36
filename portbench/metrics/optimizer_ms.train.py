"""Device time of the train step's optimizer update (SGD at the step's rate),
mean per step of the traced calls: the program's span
`demonet.train.optimizer` (harness/program_spans.py)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, "train", "demonet.train.optimizer")
