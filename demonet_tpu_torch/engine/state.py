"""Train state, optimizer and LR schedule (counterpart of
demonet_tpu/engine/state.py).

The recipe: SGD, momentum 0.9, weight decay 1e-4 on every parameter (BN
scale and bias included), a linear warmup from lr / 1000 over
min(1000, steps_per_epoch - 1) steps, and MultiStep decay by 0.1 at
epochs 16 and 22, all indexed by the optimizer step.

An optimizer here is built in two stages, as the JAX package's is: a
recipe (`make_optimizer`, possibly masked by `utils.freeze`) that is
later bound to the model's named parameters (`create_train_state`). The
step counter is a host int in `TrainState`, so the learning rate of each
update is computed on the host and never read from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]
NamedParameters = Iterable[Tuple[str, nn.Parameter]]


def make_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    milestones: Sequence[int] = (16, 22),
    gamma: float = 0.1,
    warmup_iters: int = 1000,
    warmup_factor: float = 1.0 / 1000.0,
) -> Schedule:
    """step -> learning rate: linear warmup times the MultiStep factor.

    The decay applies from step m * steps_per_epoch on (that step already
    has it). The arithmetic is in float32, as the JAX schedule's is once
    XLA has compiled it into the train step: the division by the warmup
    length becomes a multiplication by its float32 reciprocal, and the
    warmup blend one fused multiply-add (emulated in float64: the product
    of two float32 values is exact there). Every step's rate is then
    bit-equal to the rate the JAX train step applies.
    """
    f32, f64 = np.float32, np.float64
    warmup_iters = min(warmup_iters, max(1, steps_per_epoch - 1))
    inv_warmup = f32(1.0) / f32(warmup_iters)
    boundaries = sorted({m * steps_per_epoch: gamma for m in milestones}
                        .items())

    def schedule(step: int) -> float:
        v = f32(base_lr)
        for threshold, scale in boundaries:
            if step >= threshold:
                v = f32(scale) * v
        alpha = min(f32(step) * inv_warmup, f32(1.0))
        factor = f32(f64(f32(1.0) - alpha) * f64(f32(warmup_factor))
                     + f64(alpha))
        return float(v * factor)

    return schedule


class SGD(torch.optim.SGD):
    """torch SGD whose learning rate follows a step-indexed schedule.

    The update is the JAX package's chain of decayed weights then SGD
    with momentum: g + wd * p enters the momentum buffer, and p -= lr *
    buffer. `step_at(step)` sets the learning rate of update number
    `step` (from 0) and applies it.
    """

    def __init__(self, params: Iterable[nn.Parameter],
                 learning_rate: Union[Schedule, float], momentum: float,
                 weight_decay: float):
        self.lr_schedule = (learning_rate if callable(learning_rate)
                            else lambda step: float(learning_rate))
        super().__init__(params, lr=self.lr_schedule(0), momentum=momentum,
                         weight_decay=weight_decay)

    def step_at(self, step: int) -> None:
        lr = self.lr_schedule(step)
        for group in self.param_groups:
            group["lr"] = lr
        self.step()


Optimizer = Callable[[NamedParameters], SGD]


def make_optimizer(
    learning_rate: Union[Schedule, float],
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
) -> Optimizer:
    """The SGD recipe: named parameters -> `SGD` over all of them."""
    def build(named: NamedParameters) -> SGD:
        return SGD([p for _, p in named], learning_rate, momentum,
                   weight_decay)

    return build


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer (momentum
    buffers) and the number of updates applied. A train step updates all
    three in place."""

    model: nn.Module
    optimizer: SGD
    step: int = 0


def create_train_state(detector, tx: Optimizer) -> TrainState:
    """Bind the recipe to the detector's model as it stands. The port's
    builders draw the weights when they build the model (from their
    `seed`), so no RNG is taken here."""
    return TrainState(detector.model, tx(detector.model.named_parameters()))
