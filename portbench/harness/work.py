"""Peaks of the card and the work arithmetic the roofline shares use.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W power limit (the run prints the card's own
limit beside its numbers).
"""

from __future__ import annotations

from typing import Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
# peak FLOP/s of a compute dtype as the configuration states it: float32
# runs with TF32 off, outside the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
FP32_OPS_PER_S = PEAK_FLOPS["float32"]
# one IoU test: 4 min/max, 2 subtractions, 2 clamps, a product, the union's
# 2 additions, its clamp, the division and the comparison
OPS_PER_IOU = 14


def nms_work(keep: torch.Tensor, scores: torch.Tensor, thr: float
             ) -> Tuple[float, float]:
    """Bytes and operations a greedy NMS over (P, K) score-sorted problems
    needs on these inputs: every score read, the boxes of live candidates
    read, the mask written; a kept candidate tested against every earlier
    kept one, a suppressed live one at least once, and each live box's
    area."""
    live = scores > thr
    n_live = int(live.sum())
    kept = keep.sum(dim=1).double()
    pairs = float((kept * (kept - 1) / 2).sum()) + (n_live - float(kept.sum()))
    nbytes = scores.numel() * 4 + n_live * 16 + keep.numel()
    return float(nbytes), pairs * OPS_PER_IOU + n_live * 3


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
