"""Model export (counterpart of demonet_tpu/export/).

The artifact is a `torch.export` program of preprocess -> model ->
postprocess (`program.py`), with the hand-written kernels inside it as
custom ops; `python -m demonet_tpu_torch.export.cli` writes one. The JAX
package's Caffe export and its C++ runner's inputs are not ported.
"""

from demonet_tpu_torch.export.program import (  # noqa: F401
    export_detector,
    load_exported,
    save_exported,
)
