"""Both sides of a cell: the program's detector and the reference net,
given the same weights.

The program is built through its registry (`models.builders.get_model`)
at the configuration's registry name and builder arguments, in the cell's
compute dtype; the weights the benchmark made (or read from the npz) are
then put into it. The reference is built from the configuration file
alone and takes the same weights, read again by its own loader where
they come from the npz.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from harness import manifest, weights
from reference import boxes as ref_boxes
from reference import nets
from reference import npz as ref_npz

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CONFIG_FIELDS = ("num_classes", "score_thresh", "nms_thresh",
                  "detections_per_img", "topk_candidates", "iou_thresh")


def set_fp32_exact() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_anchors(net: nets.Net, cfg: dict, device) -> torch.Tensor:
    size = tuple(cfg["size"])
    return torch.as_tensor(ref_boxes.default_boxes(
        net.grid_sizes(size), size, cfg["aspect_ratios"],
        cfg.get("min_ratio", 0.15), cfg.get("max_ratio", 0.9),
        cfg.get("scales"), cfg.get("steps")), device=device)


def normalise(images: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 NHWC frames scaled to [0, 1], less the mean, over the std."""
    x = images.to(torch.float32) * np.float32(1.0 / 255.0)
    mean = torch.tensor(cfg["image_mean"], dtype=torch.float32,
                        device=x.device)
    std = torch.tensor(cfg["image_std"], dtype=torch.float32, device=x.device)
    return (x - mean) / std


def reference_state(cell: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of the cell: the configuration's npz, checked, or
    drawn on the device from the seed, or from the workload file's
    `weights_seed` where it has one: the same weights in every run, so
    that work which hangs on them (the scores NMS sees live) is the same
    whatever the run's seed."""
    cfg = cell["config"]
    if cell["weights"] == "npz":
        w = cfg["weights"]
        arrays = weights.npz_arrays(os.path.join(manifest.ROOT, w["npz"]),
                                    w["sha256"])
        return {k: v.to(device) for k, v in ref_npz.state_dict(arrays).items()}
    if cell["weights"] != "seeded":
        raise ValueError(f"weights {cell['weights']!r}")
    return weights.seeded_state(nets.build(cfg, device), cfg["init"],
                                cell.get("weights_seed", seed))


def program(cell: dict, state: Dict[str, torch.Tensor], device):
    """The program's detector with `state` in it."""
    from demonet_tpu_torch.models.builders import get_model

    cfg = cell["config"]
    det = get_model(cfg["registry"], device=device,
                    dtype=DTYPES[cell["dtype"]], **cfg["builder_args"])
    got = det.config
    want = {k: cfg[k] for k in _CONFIG_FIELDS}
    have = {k: getattr(got, k) for k in _CONFIG_FIELDS}
    if have != want or list(got.size) != list(cfg["size"]) or list(
            got.box_coder_weights) != list(cfg["box_coder_weights"]):
        raise ValueError(f"the program's {cfg['registry']} runs {got}, "
                         f"not the configuration file's {want}")
    weights.load_into(det.model, state)
    return det


def reference(cell: dict, state: Dict[str, torch.Tensor], device
              ) -> Tuple[nets.Net, torch.Tensor]:
    """The reference net in float32 with `state`, in eval mode, and its
    anchors."""
    net = nets.build(cell["config"], device)
    weights.load_into(net, state)
    return net.eval(), reference_anchors(net, cell["config"], device)


class Launches:
    """The program's launch counters of K1 (NMS), K2 (row gather) and K3
    (sparse top-k)."""

    def __init__(self):
        from demonet_tpu_torch.ops.gather import gather_rows_batch
        from demonet_tpu_torch.ops.nms import nms_keep_batch
        from demonet_tpu_torch.ops.topk import topk_sparse

        self.ops = {"k1_nms": nms_keep_batch, "k2_gather": gather_rows_batch,
                    "k3_topk": topk_sparse}
        self.reset()

    def reset(self) -> None:
        self.start = {k: f.launches for k, f in self.ops.items()}

    def per_call(self, n: int) -> Dict[str, float]:
        """Launches of each per call, over the n calls since reset."""
        return {k: (f.launches - self.start[k]) / n
                for k, f in self.ops.items()}
