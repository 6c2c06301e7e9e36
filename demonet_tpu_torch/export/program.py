"""`torch.export` artifacts of detectors (counterpart of
demonet_tpu/export/stablehlo.py).

`export_detector` traces preprocess -> model -> postprocess into one
`torch.export.ExportedProgram`, the weights held in it; `save_exported`
writes it to a `.pt2` file and `load_exported` reads it back. Run it as
`load_exported(path).module()(images)`: images (B, H, W, 3) float32 in
[0, 1] at the network size, on the device it was exported on, give the
padded detections {'boxes', 'scores', 'labels', 'valid'} that
`engine.evaluate.make_predict_step` gives, bit for bit on the same
device.

The postprocess's kernels are custom ops (`ops/library.py`), so the
program holds K1 (`demonet_tpu_torch::nms_keep_batch`) and K2
(`::gather_rows_batch`) as nodes: on the card the artifact launches the
hand-written kernels, on the CPU it runs their plain versions. The fused
postprocess keeps its guards on the device and chooses its branch with
nested `torch.cond`s (`models/detection.py::_fused_switch`), as the JAX
artifact bakes in its `lax.switch`.

The batch size is static, as in the JAX artifact. The top-k is the exact
one: the JAX `export_detector` passes no `topk_impl`, so no artifact
reaches K3.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from demonet_tpu_torch.models.detection import (
    Detector,
    SSDConfig,
    postprocess_detections,
    preprocess,
)
from demonet_tpu_torch.ops import library  # noqa: F401 (registers the ops)


class _Inference(nn.Module):
    """The traced function: images -> detections, or the raw heads."""

    def __init__(self, model: nn.Module, anchors: torch.Tensor,
                 config: SSDConfig, with_postprocess: bool,
                 postprocess_impl: str):
        super().__init__()
        self.model = model
        self.register_buffer("anchors", anchors)
        self.config = config
        self.with_postprocess = with_postprocess
        self.postprocess_impl = postprocess_impl

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = preprocess(images, self.config, resize=False)
        outputs = self.model(x)
        if not self.with_postprocess:
            return outputs
        return postprocess_detections(
            outputs["cls_logits"], outputs["bbox_regression"], self.anchors,
            self.config, impl=self.postprocess_impl)


def export_detector(detector: Detector, batch_size: int = 1,
                    with_postprocess: bool = True,
                    postprocess_impl: str = "reference"
                    ) -> torch.export.ExportedProgram:
    """Export the inference pipeline as a `torch.export.ExportedProgram`.

    Args:
      detector: a `Detector` (a classifier raises TypeError, as the JAX
        function takes detectors only), its weights in its module. The
        program takes float32 (batch_size, H, W, 3) images on the
        detector's device and computes in the detector's dtype.
      with_postprocess: include decode and NMS (the deployable artifact).
        False exports the trunk and heads only: {'cls_logits': (B, A, C),
        'bbox_regression': (B, A, 4)}.
      postprocess_impl: "reference" or "fused" (the trained-model fast
        postprocess, its branch chosen inside the program).

    The module is traced in eval mode under `torch.no_grad()` and left in
    the mode it was in. The program keeps no example input.
    """
    if not isinstance(detector, Detector):
        raise TypeError("export_detector takes a Detector; got "
                        f"{type(detector).__name__} (classifiers have no "
                        "detection pipeline to export)")
    device = detector.device
    program = _Inference(
        detector.model, torch.as_tensor(detector.anchors, device=device),
        detector.config, with_postprocess, postprocess_impl)
    h, w = detector.config.size
    images = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                         device=device)
    training = detector.model.training
    detector.model.eval()
    try:
        with torch.no_grad():
            exported = torch.export.export(program, (images,))
    finally:
        detector.model.train(training)
    # the all-zero example batch would be saved with the program (39 MB
    # at b32 and 320x320): the artifact keeps its weights only
    exported.example_inputs = None
    return exported


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program to a `.pt2` file (`torch.export.save`)."""
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Read a program written by `save_exported` (`torch.export.load`).

    The kernels' custom ops are registered first (this module imports
    `ops/library.py`): a program that holds them cannot load without.
    """
    return torch.export.load(path)
