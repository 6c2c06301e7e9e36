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

The JAX package's second axis, "model" (`model_axis` = M > 1), shards
nothing there: the parameters are replicated and the batch is split over
"data" only, so the M devices of one data shard compute the same step.
Here rank r sits at data index r // M and model index r % M, where the
JAX package's `reshape(n // M, M)` puts device r; the ranks of one data
index hold the same rows, and every collective of a step or an
evaluation runs over the mesh's `group`, the D = world / M ranks that
share this rank's model index. So each model replica computes what a
1-D mesh of D ranks computes, and the replicas end a step bit-equal.
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
    """One process's place in the (data, model) mesh. `group` is the
    process group of this rank's data axis, the ranks with its model
    index (None: a single process with no group, where nothing is
    communicated); `rank` and `world_size` are this process's in the
    whole group; `data_index` of `data_size` is the part of the batch
    this rank holds, and `model_index` of `model_axis` its replica;
    `device` is the device this process drives."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    model_axis: int = 1
    data_index: int = 0
    data_size: int = 1
    model_index: int = 0


def mesh_coordinates(rank: int, world_size: int, model_axis: int
                     ) -> Tuple[int, int]:
    """(data index, model index) of `rank` in a mesh of `world_size`
    processes with `model_axis` replicas per data shard: the place the
    JAX package's `reshape(n // model_axis, model_axis)` gives device
    `rank`. A world that model_axis does not divide raises ValueError."""
    if model_axis < 1 or world_size % model_axis:
        raise ValueError(f"{world_size} devices not divisible by "
                         f"model_axis={model_axis}")
    return divmod(rank, model_axis)


def data_mesh(devices: Optional[Sequence[torch.device]] = None,
              model_axis: int = 1) -> DataMesh:
    """The (data, model) mesh over every process of the group (or this
    one alone); model_axis = 1 gives pure data parallelism. `devices`:
    this process's device, in a sequence of one; by default
    `cuda:LOCAL_RANK` (with no GPU it raises: pass the CPU). With
    model_axis > 1 every rank must call it, at the same point: it
    creates the data groups of all model indices, in order."""
    rank, world = process_index(), process_count()
    data_index, model_index = mesh_coordinates(rank, world, model_axis)
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
    group = None
    if _initialized():
        group = dist.group.WORLD
        if model_axis > 1:
            groups = [dist.new_group(list(range(m, world, model_axis)))
                      for m in range(model_axis)]
            group = groups[model_index]
    return DataMesh(group, rank, world, device, model_axis, data_index,
                    world // model_axis, model_index)


def check_mesh(mesh: Any) -> DataMesh:
    """`mesh` itself, if it is a DataMesh; else TypeError."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a DataMesh (parallel.data_mesh()), "
                        f"got {type(mesh).__name__}")
    return mesh


def batch_sharding(mesh: DataMesh) -> Tuple[int, int]:
    """(part, parts): this process holds part `data_index` of the
    `data_size` parts of the batch's leading axis (the JAX package's
    PartitionSpec("data")); a loader shards so, with num_shards=parts
    and shard_index=part."""
    check_mesh(mesh)
    return mesh.data_index, mesh.data_size


def replicate(model_or_state: Any, mesh: DataMesh) -> Any:
    """Rank 0's parameters, buffers and (for a TrainState) momentum
    buffers and step count, broadcast in place to every rank of the
    mesh, both axes; returns the argument."""
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
        dist.broadcast(t, src=0)
    if optimizer is not None:
        step = torch.tensor([model_or_state.step], dtype=torch.int64,
                            device=mesh.device)
        dist.broadcast(step, src=0)
        model_or_state.step = int(step)
    return model_or_state


def shard_batch(batch: Any, mesh: DataMesh, axis: int = 0) -> Any:
    """This process's rows of the step's batch, on its device.

    Each process holds only its own rows (the loader shards by the mesh's
    data index, `batch_sharding`; the model replicas of one data index
    hold the same rows),
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
