"""Checkpoint save and restore (counterpart of
demonet_tpu/utils/checkpoints.py), epoch by epoch.

The layout is the JAX package's: `<output_dir>/checkpoint_<epoch>/` beside
`checkpoint_<epoch>.meta.json` ({"epoch", "metadata"}). The directory holds
one `torch.save` file, `state.pt`, in place of orbax's tree: the model's
state_dict (parameters and BN statistics), the optimizer's (momentum
buffers and learning rate) and the step. Only rank 0 writes, and the
file is written under another name and renamed, so a reader never sees
half of one; the other ranks wait for it at a barrier. A bf16 model keeps float32 parameters, statistics and
momentum, so its checkpoint is a float32 one: it resumes into a float32
model and the reverse, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from demonet_tpu_torch.engine.state import TrainState
from demonet_tpu_torch.parallel.dist import is_main_process, sync_devices

_STATE = "state.pt"


def save_checkpoint(
    output_dir: str,
    state: TrainState,
    epoch: int,
    metadata: Optional[Dict] = None,
) -> str:
    """Write checkpoint_<epoch>/ under output_dir (rank 0 only); returns
    its path on every rank, once it is written (every rank waits for rank
    0 at a barrier, so none reads it back early)."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint_{epoch}")
    if is_main_process():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _STATE + ".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, tmp)
        os.replace(tmp, os.path.join(path, _STATE))
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": epoch, "metadata": metadata or {}}, f)
    sync_devices("checkpoint")
    return path


def _read(path: str, map_location) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), _STATE),
                      map_location=map_location, weights_only=True)


def load_checkpoint(path: str, state: TrainState
                    ) -> Tuple[TrainState, int, Dict]:
    """Restore (state, epoch, metadata) into `state`, a train state built
    as the saved one was (same model, same optimizer recipe and mask),
    in place. Tensors land on the model's device."""
    device = next(state.model.parameters()).device
    saved = _read(path, device)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    epoch, metadata = 0, {}
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            side = json.load(f)
        epoch, metadata = int(side.get("epoch", 0)), side.get("metadata", {})
    return state, epoch, metadata


def load_variables(path: str) -> Dict[str, torch.Tensor]:
    """The inference weights of a training checkpoint (the model's
    state_dict, on the CPU), whatever optimizer it was trained with: for
    `model.load_state_dict`."""
    return _read(path, "cpu")["model"]


def load_npz_variables(path: str) -> Dict[str, Any]:
    """Flat .npz variables ('params/.../kernel' keys, the layout of
    bench_assets/ssdlite320_shapes_trained.npz) -> the nested
    {'params': ..., 'batch_stats': ...} tree with float32 leaves that
    `utils.weights.load_jax_variables` takes."""
    variables: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = variables
            parts = key.split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = np.asarray(z[key], np.float32)
    return variables


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The checkpoint_<epoch> path of the highest epoch, or None."""
    if not os.path.isdir(output_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(output_dir):
        if name.startswith("checkpoint_"):
            try:
                e = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if e > best_epoch:
                best, best_epoch = os.path.join(output_dir, name), e
    return best
