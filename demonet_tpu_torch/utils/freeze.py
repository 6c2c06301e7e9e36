"""Backbone freezing as an optimizer mask (counterpart of
demonet_tpu/utils/freeze.py).

A mask maps each parameter name of the model to True (trainable) or
False (frozen). `masked_optimizer` builds the optimizer over the
trainable parameters only, so a frozen one gets no update, no weight
decay and no momentum buffer. Its gradient is still computed (as in the
JAX package) and its BN running statistics still update in train mode.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from torch import nn

from demonet_tpu_torch.engine.state import NamedParameters, Optimizer


def validate_trainable_layers(
    pretrained: bool,
    trainable_layers: Optional[int],
    max_value: int,
    default_value: int,
) -> int:
    """Without pretrained weights everything trains; otherwise the count
    defaults to default_value and must lie in [0, max_value]."""
    if not pretrained:
        if trainable_layers is not None and trainable_layers != max_value:
            print("Changing trainable_backbone_layers has no effect without "
                  "pretrained weights; training all layers.")
        return max_value
    if trainable_layers is None:
        trainable_layers = default_value
    if not (0 <= trainable_layers <= max_value):
        raise ValueError(
            f"trainable_layers {trainable_layers} not in [0, {max_value}]")
    return trainable_layers


def mobilenet_trainable_mask(model: nn.Module, trainable_layers: int,
                             num_blocks: int = 15) -> Dict[str, bool]:
    """Freeze MobileNetV3 trunk stages from the bottom, SSDLite-style.

    `trainable_layers` counts stages from the top: 0 freezes the whole
    trunk, 6 trains everything. Stage 5 is `last_conv`; stages 1-4 open at
    blocks 1, 3, 6 and 12; the stem trains only at 6. The extras and the
    head always train. Keyed by `model.named_parameters()` names.
    """
    stage_starts = (1, 3, 6, 12)

    def trainable(name: str) -> bool:
        if "trunk" not in name or trainable_layers >= 6:
            return True
        if trainable_layers <= 0:
            return False
        if "last_conv" in name:
            return True
        if "stem" in name:
            return False
        m = re.search(r"blocks\.(\d+)\.", name)
        if not m:
            return True
        stage = sum(1 for s in stage_starts if int(m.group(1)) >= s)
        return stage > 4 - (trainable_layers - 1)

    return {name: trainable(name) for name, _ in model.named_parameters()}


def masked_optimizer(tx: Optimizer, trainable_mask: Dict[str, bool]
                     ) -> Optimizer:
    """The recipe `tx` bound to the parameters the mask marks trainable."""
    def build(named: NamedParameters):
        return tx([(n, p) for n, p in named if trainable_mask[n]])

    return build
