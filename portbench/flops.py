"""A step's model FLOPs per image, counted on the reference net.

`torch.utils.flop_counter.FlopCounterMode` over the reference's forward
(`serve`) or forward and backward (`train`) of one image on the meta
device: the products of the convs, 2 per multiply-add, the backward's
gradients of inputs and weights included. Counted on the reference and
not the program, so that `mfu.*` reads the same work whatever kernels
the program runs; elementwise work, BN, the loss and the postprocess are
not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import nets


def flops_per_image(cfg: dict, entry: str) -> float:
    net = nets.build(cfg, "meta")
    h, w = cfg["size"]
    x = torch.empty((1, h, w, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        if entry == "serve":
            with torch.no_grad():
                net.eval()(x)
        elif entry == "train":
            out = net.train()(x)
            (out["cls_logits"].sum() + out["bbox_regression"].sum()).backward()
        else:
            raise ValueError(f"entry {entry!r}")
    return float(counter.get_total_flops())
