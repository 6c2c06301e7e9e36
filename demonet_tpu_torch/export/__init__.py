"""Model export (counterpart of demonet_tpu/export/).

The artifact is a `torch.export` program of preprocess -> model ->
postprocess (`program.py`), with the hand-written kernels inside it as
custom ops; `python -m demonet_tpu_torch.export.cli` writes one. The
Caffe export writes a deploy prototxt and caffemodel of the raw heads:
hand-built per family (`caffe.py`) or read off the model's
`torch.export` graph (`tracing.py`), checked by running it
(`caffe_eval.py`); `--format caffe` on the CLI. The C++ runner's input is
an AOTInductor package of the same program (`aoti.py`, the CLI's
`--aoti`), which `csrc/aoti_runner.cc` runs with no Python, K1 and K2
registered from C++ (`csrc/aoti_ops.cc`).
"""

from demonet_tpu_torch.export.program import (  # noqa: F401
    export_detector,
    load_exported,
    save_exported,
)
