"""Train step and epoch loop (counterpart of demonet_tpu/engine/train.py).

The step runs eagerly: preprocess, forward in train mode, MultiBox loss
(matching and hard-negative mining on the device), backward, the SGD
update at the step's learning rate (computed on the host from the host
step count) and the BN statistics' update, which the train-mode forward
makes; with a data-parallel mesh, over the global batch of every rank.
Nothing in it waits for the device: the metrics come back as
device tensors, and the epoch loop reads them every `print_freq` steps.
A bfloat16 model (the builders' `dtype`) trains in the same step: its
float32 parameters get float32 gradients through the casts in its convs.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from demonet_tpu_torch.engine.state import TrainState
from demonet_tpu_torch.models.detection import Detector, to_float
from demonet_tpu_torch.models.layers import (
    global_batch_stats,
    hold_running_stats,
)
from demonet_tpu_torch.models.losses import multibox_loss
from demonet_tpu_torch.parallel.mesh import check_mesh, shard_batch
from demonet_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from demonet_tpu_torch.utils.spans import span

Batch = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]
_KEYS = ("images", "gt_boxes", "gt_labels", "gt_valid")


def _remat_contexts():
    """The forward runs as it is; its recompute in the backward pass holds
    the BN running statistics back."""
    return contextlib.nullcontext(), hold_running_stats()


def make_train_step(
    detector: Detector,
    mesh: Optional[Any] = None,
    normalize_in_step: bool = True,
    donate: bool = True,
    remat: bool = False,
    steps_per_call: int = 1,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Build the train step: (state, batch) -> (state, metrics).

    Batch: images (B, H, W, 3) float in [0, 1] (uint8 is scaled on the
    device); gt_boxes (B, G, 4) xyxy pixels; gt_labels (B, G); gt_valid
    (B, G) bool; tensors (or numpy arrays), best already on the model's
    device (anything else is copied there without waiting). The state is
    updated in place and returned. Metrics: 'bbox_regression',
    'classification' and their sum 'loss', 0-d device tensors.

    steps_per_call = K > 1 gives a step over batches with a leading K axis
    that applies K updates and returns each metric stacked on a leading K
    axis, as the JAX package's scanned step does.

    The step takes an optional `on_phase(name)` callback, called after
    each of 'forward', 'loss', 'backward' and 'optimizer' (of the last
    sub-step); it lets a caller put CUDA events between them.

    Each (sub-)step is a `demonet.train_step` span (`utils/spans.py`)
    holding `demonet.train.upload`, `demonet.forward` (with the model's
    spans), `demonet.loss` (with `demonet.loss.match` and
    `demonet.loss.mine`), `demonet.train.backward`, with a mesh
    `demonet.train.allreduce`, and `demonet.train.optimizer`; each
    `on_phase` call follows the end of its span.

    `remat` recomputes the activations in the backward pass instead of
    keeping them, as the JAX package's `jax.checkpoint` over the whole
    train-mode apply: `torch.utils.checkpoint` over the whole model, its
    recompute inside `layers.hold_running_stats()`, so that the BN
    statistics move once a step. It takes steps_per_call > 1 too.
    `donate` has no meaning here: the state is updated in place, so
    nothing is copied for it to save.

    `mesh` (a `parallel.DataMesh`) makes it one step over the global batch,
    the ranks' batches in rank order, as the JAX package's mesh step: each
    rank passes its own rows; the train-mode BN takes its statistics over
    the global batch (`layers.global_batch_stats`, re-issued in the remat
    recompute), the loss divides by the global positive count, and after
    the backward one flat SUM all-reduce carries the gradients and the
    loss terms, so that every rank applies the gradient of the global
    loss (the sum over ranks, not DDP's mean) and returns the global
    metrics. Every rank holds the same state after it. A mesh of one
    process with no process group communicates nothing.
    """
    del donate
    group = None
    if mesh is not None:
        group = check_mesh(mesh).group
    device = detector.device
    config = detector.config
    anchors = torch.as_tensor(detector.anchors, dtype=torch.float32,
                              device=device)
    mean = torch.tensor(config.image_mean, dtype=torch.float32, device=device)
    std = torch.tensor(config.image_std, dtype=torch.float32, device=device)

    def _mark(on_phase, name):
        if on_phase is not None:
            on_phase(name)

    def step(state: TrainState, batch: Batch, on_phase=None
             ) -> Tuple[TrainState, Metrics]:
        with span("demonet.train_step"):
            return _step(state, batch, on_phase)

    def _step(state: TrainState, batch: Batch, on_phase
              ) -> Tuple[TrainState, Metrics]:
        model = state.model
        if not model.training:
            model.train()
        with span("demonet.train.upload"):
            b = {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
                 for k in _KEYS}
        images = b["images"]
        if normalize_in_step:
            images = (to_float(images) - mean) / std
        with global_batch_stats(group):
            with span("demonet.forward"):
                if remat:
                    outputs = checkpoint(model, images, use_reentrant=False,
                                         context_fn=_remat_contexts)
                else:
                    outputs = model(images)
            _mark(on_phase, "forward")
            with span("demonet.loss"):
                losses = multibox_loss(
                    outputs["cls_logits"], outputs["bbox_regression"],
                    anchors, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                    iou_thresh=config.iou_thresh,
                    neg_to_pos_ratio=config.neg_to_pos_ratio,
                    box_coder_weights=config.box_coder_weights, group=group)
                total = losses["bbox_regression"] + losses["classification"]
            _mark(on_phase, "loss")
            with span("demonet.train.backward"):
                model.zero_grad(set_to_none=True)
                total.backward()
        _mark(on_phase, "backward")
        metrics = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            with span("demonet.train.allreduce"):
                metrics = _all_reduce_grads(model, metrics, group)
            metrics["loss"] = (metrics["bbox_regression"]
                               + metrics["classification"])
        else:
            metrics["loss"] = total.detach()
        with span("demonet.train.optimizer"):
            state.optimizer.step_at(state.step)
            state.step += 1
        _mark(on_phase, "optimizer")
        return state, metrics

    if steps_per_call == 1:
        return step

    def multi(state: TrainState, batches: Batch, on_phase=None
              ) -> Tuple[TrainState, Metrics]:
        rows = []
        for i in range(steps_per_call):
            state, m = step(state, {k: batches[k][i] for k in _KEYS},
                            on_phase if i == steps_per_call - 1 else None)
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return multi


def _all_reduce_grads(model: torch.nn.Module, metrics: Metrics, group
                      ) -> Metrics:
    """One SUM all-reduce of every gradient and the metrics, flattened
    into one buffer of the gradients' dtype (one bucket); the gradients
    are written back in place. Returns the summed metrics in their own
    dtypes."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].to(grads[0].dtype)
                                     for k in keys])])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads]
                                         + [len(keys)])):
        g.copy_(part.view_as(g))
    summed = flat[-len(keys):]
    return {k: summed[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def train_one_epoch(
    train_step: Callable,
    state: TrainState,
    data_loader,
    epoch: int,
    print_freq: int = 20,
    lr_schedule: Optional[Callable[[int], float]] = None,
    mesh: Optional[Any] = None,
    metrics_writer=None,
    multi_step: Optional[Callable] = None,
    steps_per_call: int = 1,
) -> TrainState:
    """One pass over data_loader with MetricLogger output; returns the state.

    The metrics stay on the device and are read, in one transfer, every
    print_freq steps and at the end of the epoch. A non-finite loss then
    prints that step's metrics and exits with status 1 (at most
    print_freq - 1 steps after it happened). With multi_step (a
    make_train_step(..., steps_per_call=K) step), batches are stacked in
    windows of K and run by it; the short tail of the epoch runs single
    steps. The metrics writer (anything with `write(step, metrics)`) gets
    every step, with its learning rate, and is flushed at the end of the
    epoch where it has a `flush()`.

    With a mesh (`parallel.DataMesh`), each batch or window is this rank's
    rows (`shard_batch`) and the steps are mesh steps: their metrics are
    the global ones on every rank, so every rank stops at the same step
    on a non-finite loss (a rank that stopped alone would leave the
    others waiting in a collective).
    """
    if mesh is not None:
        check_mesh(mesh)
    logger = MetricLogger(delimiter="  ")
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    step0 = state.step
    # [(step numbers, metrics)]: each metric has a leading axis of the
    # steps' count where there is more than one
    pending = []

    def _drain():
        if not pending:
            return
        flat_steps = [s for steps, _ in pending for s in steps]
        keys = list(pending[0][1])
        table = torch.cat([
            torch.stack([m[k].reshape(len(steps)) for k in keys], dim=1)
            for steps, m in pending]).tolist()       # the one device read
        pending.clear()
        for step_no, row in zip(flat_steps, table):
            scalars = dict(zip(keys, row))
            lr = lr_schedule(step_no) if lr_schedule is not None else 0.0
            if not math.isfinite(scalars["loss"]):
                print(f"Loss is {scalars['loss']}, stopping training")
                print(scalars)
                sys.exit(1)
            logger.update(lr=lr, **scalars)
            if metrics_writer is not None:
                metrics_writer.write(step_no, dict(scalars, lr=lr))

    k = steps_per_call if multi_step is not None else 1
    window = []

    def _run_window():
        nonlocal state, step0
        if len(window) == k and k > 1:
            stacked = {key: torch.stack([torch.as_tensor(b[key])
                                         for b in window]) for key in _KEYS}
            if mesh is not None:
                stacked = shard_batch(stacked, mesh, axis=1)
            state, metrics = multi_step(state, stacked)
            pending.append((list(range(step0 + 1, step0 + 1 + k)), metrics))
            step0 += k
        else:  # single steps: k == 1, or the epoch's short tail
            for b in window:
                if mesh is not None:
                    b = shard_batch({key: b[key] for key in _KEYS}, mesh)
                state, metrics = train_step(state, b)
                step0 += 1
                pending.append(([step0], metrics))
        window.clear()

    for batch in logger.log_every(data_loader, print_freq, header,
                                  pre_print=_drain):
        window.append(batch)
        if len(window) == k:
            _run_window()

    _run_window()
    _drain()
    if hasattr(metrics_writer, "flush"):
        metrics_writer.flush()
    return state
