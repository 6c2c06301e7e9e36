"""Predict step (counterpart of demonet_tpu/engine/evaluate.py).

`make_predict_step` gives the callable the JAX package jits:
(model, images, original_sizes) -> padded detections, run eagerly under
`torch.inference_mode()`. The evaluation loop waits for the data slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from demonet_tpu_torch.models.detection import (
    Detector,
    postprocess_detections,
    preprocess,
)


def make_predict_step(
    detector: Detector,
    nms_impl: str = "auto",
    topk_impl: str = "exact",
    impl: str = "reference",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """(model, images, original_sizes) -> padded detections.

    `images` are (B, H, W, 3) at the network size, uint8 or float in
    [0, 1], on the model's device. The anchors are put on that device
    once, here. The model runs in eval mode, whatever mode it was left in
    (a train step leaves it in train mode), as the JAX package's predict
    passes train=False.
    """
    anchors = torch.as_tensor(detector.anchors, device=detector.device)
    config = detector.config

    def step(model: torch.nn.Module, images: torch.Tensor,
             original_sizes: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        if model.training:
            model.eval()
        with torch.inference_mode():
            x = preprocess(images, config, resize=False)
            outputs = model(x)
            return postprocess_detections(
                outputs["cls_logits"], outputs["bbox_regression"], anchors,
                config, original_sizes, nms_impl=nms_impl,
                topk_impl=topk_impl, impl=impl)

    return step
