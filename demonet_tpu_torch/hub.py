"""Hub-style model loading (counterpart of demonet_tpu/hub.py; reference
hubconf.py:1-44).

    from demonet_tpu_torch import hub
    det = hub.load("ssd_lite_mobilenet_v2",
                   weights="ckpts/ssd_lite_mobilenet_v2_199.pth")
    dets = det.predict(images_uint8_nhwc)

Names resolve through the registry of `models.builders.get_model`, and
the weights come from a torch .pth file in the reference's layout
(`utils.torch_weights`) or from a checkpoint directory of the port's
train CLI (`utils.checkpoints`).
"""

from __future__ import annotations

import os
from typing import Any, Optional

from demonet_tpu_torch.models.builders import (
    MODEL_REGISTRY,
    get_model,
    resolve_device,
)


def list_models() -> list:
    return sorted(MODEL_REGISTRY)


def load(name: str, weights: Optional[str] = None, seed: int = 0,
         pretrained: bool = False, device=None, **kwargs: Any):
    """Build a model and, if asked, load its weights.

    Returns the model with its weights in it: a `Detector` (whose
    `.model` holds them) or a classifier module. The JAX package returns
    a (model, variables) pair because its modules keep the two apart; a
    PyTorch module holds its own.

    `weights` is a .pth/.pt file (converted from the reference's layout)
    or a checkpoint directory (`checkpoint_<epoch>/` of the train CLI);
    anything else raises ValueError. `pretrained=True` resolves the
    published checkpoint from the local weights cache
    (`utils.pretrained`). Without weights the model keeps its seeded
    random ones. `kwargs` go to the builder: `dtype=torch.bfloat16` for
    bf16 compute (the weights stay float32, so any of these sources
    loads), `num_classes`, a detector's config fields. `device`: `cuda` unless the caller names another; with
    no GPU and no device asked for, it raises.
    """
    if pretrained and not weights:
        from demonet_tpu_torch.utils.pretrained import resolve_weights

        weights = resolve_weights(name)
    model = get_model(name, device=resolve_device(device), seed=seed,
                      **kwargs)
    module = getattr(model, "model", model)   # a Detector holds its module
    if weights:
        if weights.endswith((".pth", ".pt")):
            from demonet_tpu_torch.utils.torch_weights import (
                load_torch_checkpoint,
                load_torch_weights,
            )

            load_torch_weights(module, name, load_torch_checkpoint(weights))
        elif os.path.isdir(weights):
            from demonet_tpu_torch.utils.checkpoints import load_variables

            module.load_state_dict(load_variables(weights))
        else:
            raise ValueError(f"unrecognized weights source {weights!r}")
    return model


def ssd_lite_mobilenet_v2(pretrained: bool = False,
                          pretrained_path: Optional[str] = None,
                          image_size: int = 320, score_thresh: float = 0.5,
                          num_classes: int = 21, device=None):
    """The reference hub entry's signature (hubconf.py:25-44), plus
    `device`; `pretrained=True` resolves the cached v0 checkpoint that the
    reference loads from ./checkpoints (hubconf.py:22)."""
    return load("ssd_lite_mobilenet_v2", weights=pretrained_path,
                pretrained=pretrained, device=device,
                size=(image_size, image_size), score_thresh=score_thresh,
                num_classes=num_classes)
