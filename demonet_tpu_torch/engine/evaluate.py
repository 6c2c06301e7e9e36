"""Predict step and evaluation loop (counterpart of
demonet_tpu/engine/evaluate.py; reference engine.evaluate,
demonet/engine.py:71-111).

`make_predict_step` gives the callable the JAX package jits:
(model, images, original_sizes) -> padded detections, run eagerly under
`torch.inference_mode()`. `evaluate` runs it over a loader's batches,
reads each batch's detections from the device in one transfer, and feeds
the evaluator (COCO mAP or VOC AP) on the host.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from demonet_tpu_torch.engine.state import TrainState
from demonet_tpu_torch.models.detection import (
    Detector,
    postprocess_detections,
    preprocess,
)
from demonet_tpu_torch.parallel.mesh import check_mesh
from demonet_tpu_torch.utils.logging import MetricLogger
from demonet_tpu_torch.utils.spans import span


def make_predict_step(
    detector: Detector,
    mesh: Optional[Any] = None,
    nms_impl: str = "auto",
    topk_impl: str = "exact",
    impl: str = "reference",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """(model, images, original_sizes) -> padded detections.

    With a mesh (`parallel.DataMesh`) each rank passes its own rows and
    gets their detections, as the JAX package's sharded predict step
    returns each process its rows: prediction needs no communication.

    `images` are (B, H, W, 3) at the network size, uint8 or float in
    [0, 1], on the model's device. The anchors are put on that device
    once, here. The model runs in eval mode, whatever mode it was left in
    (a train step leaves it in train mode), as the JAX package's predict
    passes train=False. A bf16 model's head outputs are cast to float32
    before the postprocess, so its detections are float32 too.

    Each call is a `demonet.predict` span (`utils/spans.py`) holding
    `demonet.preprocess`, `demonet.forward` and `demonet.postprocess`;
    the model and the postprocess open their own spans inside these.
    """
    if mesh is not None:
        check_mesh(mesh)
    anchors = torch.as_tensor(detector.anchors, device=detector.device)
    config = detector.config

    def step(model: torch.nn.Module, images: torch.Tensor,
             original_sizes: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        with span("demonet.predict"):
            if model.training:
                model.eval()
            with torch.inference_mode():
                with span("demonet.preprocess"):
                    x = preprocess(images, config, resize=False)
                with span("demonet.forward"):
                    outputs = model(x)
                with span("demonet.postprocess"):
                    return postprocess_detections(
                        outputs["cls_logits"], outputs["bbox_regression"],
                        anchors, config, original_sizes, nms_impl=nms_impl,
                        topk_impl=topk_impl, impl=impl)

    return step


def detections_to_numpy(dets: Mapping[str, Any],
                        image_ids: np.ndarray) -> List[Dict]:
    """Padded detections (numpy arrays or tensors) -> per-image numpy
    dicts of the valid rows (the reference's List[{boxes, labels,
    scores}] shape, generalized_ssd.py:392-396)."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    boxes, scores = host(dets["boxes"]), host(dets["scores"])
    labels, valid = host(dets["labels"]), host(dets["valid"])
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append({
            "image_id": int(image_ids[i]),
            "boxes": boxes[i][v],
            "scores": scores[i][v],
            "labels": labels[i][v],
        })
    return out


def _read_detections(dets: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The padded detections on the host, in one device-to-host copy:
    boxes, score, label and valid packed as float32 columns (labels are
    small integers, exact in float32), split and cast back on the host."""
    packed = torch.cat([
        dets["boxes"].float(), dets["scores"].float()[..., None],
        dets["labels"].float()[..., None], dets["valid"].float()[..., None],
    ], dim=-1).cpu().numpy()
    return {"boxes": packed[..., :4], "scores": packed[..., 4],
            "labels": packed[..., 5].astype(np.int32),
            "valid": packed[..., 6] > 0.5}


def evaluate(
    predict_step: Callable,
    model: Union[nn.Module, TrainState],
    data_loader,
    evaluator,
    mesh: Optional[Any] = None,
    print_freq: int = 100,
):
    """Run inference over the loader, feed the evaluator, summarize
    (reference engine.py:71-111). `model` is the module `predict_step`
    takes, or a `TrainState` holding it (the JAX package takes a
    variables tree or a TrainState). Batches are copied to the model's
    device; the images of `batch_valid` False (the loader's padding of
    the last batch) are dropped.

    With a mesh (`parallel.DataMesh`) each rank evaluates its own rows
    (its loader shards by the mesh's data index) into its own evaluator;
    then the meters and the evaluators' detections are merged across the
    ranks of the mesh's data group (`synchronize_between_processes(
    group)`), so every rank summarizes the whole set, and the model
    replicas of a 2-D mesh each as a 1-D mesh would."""
    group = None
    if mesh is not None:
        group = check_mesh(mesh).group
    if isinstance(model, TrainState):
        model = model.model
    device = next(model.parameters()).device

    logger = MetricLogger(delimiter="  ")
    header = "Test:"
    for batch in logger.log_every(data_loader, print_freq, header):
        t0 = time.time()
        images = torch.as_tensor(batch["images"]).to(device, non_blocking=True)
        sizes = torch.as_tensor(batch["original_sizes"]).to(
            device, non_blocking=True)
        dets = _read_detections(predict_step(model, images, sizes))
        model_time = time.time() - t0

        t0 = time.time()
        results = detections_to_numpy(dets, np.asarray(batch["image_ids"]))
        # drop padded images (loader pads the last partial batch)
        if "batch_valid" in batch:
            bv = np.asarray(batch["batch_valid"])
            results = [r for r, ok in zip(results, bv) if ok]
        evaluator.update(results)
        evaluator_time = time.time() - t0
        logger.update(model_time=model_time, evaluator_time=evaluator_time)

    logger.synchronize_between_processes(group)
    print("Averaged stats:", logger)
    evaluator.synchronize_between_processes(group)
    evaluator.accumulate()
    evaluator.summarize()
    return evaluator
