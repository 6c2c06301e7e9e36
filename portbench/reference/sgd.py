"""The training recipe: SGD with momentum and coupled weight decay, and a
step-indexed learning rate (torchvision's detection recipe): a linear
warmup from lr * warmup_factor over min(warmup_iters, steps_per_epoch -
1) steps, times gamma at each milestone epoch.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch


def learning_rate(step: int, base_lr: float, steps_per_epoch: int,
                  milestones: Sequence[int], gamma: float,
                  warmup_iters: int = 1000,
                  warmup_factor: float = 1.0 / 1000.0) -> float:
    """The rate of update number `step` (from 0)."""
    lr = base_lr
    for m in milestones:
        if step >= m * steps_per_epoch:
            lr *= gamma
    alpha = min(step / min(warmup_iters, max(1, steps_per_epoch - 1)), 1.0)
    return lr * (warmup_factor * (1.0 - alpha) + alpha)


class SGD:
    """buf = g + wd * p on the first update, momentum * buf + g + wd * p
    after; p -= lr * buf. Every parameter decays, BN's included.
    `buffers`, one per parameter (None for none yet), resumes from momentum
    buffers that earlier updates left."""

    def __init__(self, params: Iterable[torch.nn.Parameter], momentum: float,
                 weight_decay: float,
                 buffers: Sequence[Optional[torch.Tensor]] = ()):
        self.params = list(params)
        self.momentum, self.wd = momentum, weight_decay
        self.buf: Dict[int, torch.Tensor] = {
            i: b.detach().to(torch.float32).clone()
            for i, b in enumerate(buffers) if b is not None}

    @torch.no_grad()
    def step(self, lr: float) -> None:
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            d = p.grad + self.wd * p
            if i in self.buf:
                self.buf[i].mul_(self.momentum).add_(d)
            else:
                self.buf[i] = d.clone()
            p.sub_(lr * self.buf[i])
