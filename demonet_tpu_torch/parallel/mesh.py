"""The data-parallel mesh (counterpart of demonet_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ("data", "model") mesh of
every device: the batch is sharded on its leading axis, the parameters,
optimizer state and anchors are replicated, and XLA inserts the
all-reduces. Here one process drives one device, as PyTorch programs do:
a `DataMesh` names the process group, this process's rank and the device
it runs on. Each process holds only its own rows of the step's batch
(its loader shards by process), so the step's global batch is the ranks'
local batches concatenated in rank order, as `shard_batch` assembles it
in a multi-process JAX run. The mesh-taking functions (the train step,
the epoch loop, evaluation) compute what the JAX step computes over that
global batch, with the collectives written out (`parallel.dist`).

The JAX package's second mesh axis ("model", `model_axis > 1`) changes
no result there; here it raises (ROADMAP Queue 1, item 10b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from demonet_tpu_torch.parallel.dist import (
    _initialized,
    local_rank,
    process_count,
    process_index,
)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One process's place in the data-parallel mesh. `group` is the
    process group (None: a single process with no group, where nothing is
    communicated); `device` is the device this process drives."""

    group: Any
    rank: int
    world_size: int
    device: torch.device


def data_mesh(devices: Optional[Sequence[torch.device]] = None,
              model_axis: int = 1) -> DataMesh:
    """The mesh over every process of the group (or this one alone).
    `devices`: this process's device, in a sequence of one; by default
    `cuda:LOCAL_RANK` (with no GPU it raises: pass the CPU)."""
    if model_axis != 1:
        raise NotImplementedError(
            f"data_mesh(model_axis={model_axis}): the 2-D (data, model) "
            "mesh is not ported (ROADMAP Queue 1, item 10b)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=[torch.device('cpu')]")
        device = torch.device("cuda", local_rank())
    else:
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(f"one process drives one device, got {devices}")
        device = torch.device(devices[0])
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    group = dist.group.WORLD if _initialized() else None
    return DataMesh(group, process_index(), process_count(), device)


def check_mesh(mesh: Any) -> DataMesh:
    """`mesh` itself, if it is a DataMesh; else TypeError."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a DataMesh (parallel.data_mesh()), "
                        f"got {type(mesh).__name__}")
    return mesh


def batch_sharding(mesh: DataMesh) -> Tuple[int, int]:
    """(part, parts): this process holds part `rank` of the `world_size`
    parts of the batch's leading axis (the JAX package's
    PartitionSpec("data"))."""
    check_mesh(mesh)
    return mesh.rank, mesh.world_size


def replicate(model_or_state: Any, mesh: DataMesh) -> Any:
    """Rank 0's parameters, buffers and (for a TrainState) momentum
    buffers and step count, broadcast to every rank in place; returns
    the argument."""
    check_mesh(mesh)
    if mesh.group is None:
        return model_or_state
    model = getattr(model_or_state, "model", model_or_state)
    tensors = list(model.state_dict().values())
    optimizer = getattr(model_or_state, "optimizer", None)
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                buf = optimizer.state.get(p, {}).get("momentum_buffer")
                if buf is not None:
                    tensors.append(buf)
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)
    if optimizer is not None:
        step = torch.tensor([model_or_state.step], dtype=torch.int64,
                            device=mesh.device)
        dist.broadcast(step, src=0, group=mesh.group)
        model_or_state.step = int(step)
    return model_or_state


def shard_batch(batch: Any, mesh: DataMesh, axis: int = 0) -> Any:
    """This process's rows of the step's batch, on its device.

    Each process holds only its own rows (the loader shards by process),
    on whichever axis is the batch axis (`axis=1` for the K-stacked
    windows of `make_train_step(steps_per_call=K)`): the rows are this
    rank's part of the global batch as they are, so nothing is cut or
    gathered; arrays and tensors are copied to the mesh's device without
    waiting. A dict maps over its values."""
    check_mesh(mesh)
    del axis
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return torch.as_tensor(batch).to(mesh.device, non_blocking=True)


def host_local_values(tree: Any) -> Any:
    """This process's rows as numpy (inverse of shard_batch)."""
    if isinstance(tree, dict):
        return {k: host_local_values(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
