"""Process bootstrap and collectives (counterpart of
demonet_tpu/parallel/dist.py).

On `torch.distributed`: one process per device, NCCL between CUDA
devices, gloo between CPU processes (and, where NCCL cannot run, between
CUDA tensors: it copies them through the host). Without a process group
every function here answers for one process of rank 0, as the JAX
package's do without `jax.distributed`:

  * `initialize` bootstraps from its arguments or from the launcher's
    variables (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), and does nothing when there are neither;
  * `sync_devices` is a barrier; `all_gather_arrays` gathers a numpy
    array from every process of a group (all by default), byte for
    byte, whatever its dtype;
  * `all_reduce_sum` is a SUM all-reduce that autograd differentiates:
    its backward is the SUM all-reduce of the gradient, so that each
    rank's backward of its share of a global loss gives its share of the
    global gradient.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK), else its
    rank, else 0: the CUDA device it drives."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group. No-op for a single process: neither
    arguments nor launcher variables.

    `coordinator_address` is an init method URL (`tcp://host:port`,
    `file:///path`) or a bare `host:port`; None reads MASTER_ADDR and
    MASTER_PORT. `num_processes` and `process_id` default to WORLD_SIZE
    and RANK. `backend` defaults to NCCL where there is a GPU and gloo
    where there is none; with NCCL the process drives `cuda:LOCAL_RANK`.
    A collective that waits longer than `timeout_s` raises instead of
    hanging.
    """
    launched = all(k in os.environ for k in _LAUNCHER_VARS)
    if coordinator_address is None and num_processes is None \
            and not launched:
        return
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    world = int(os.environ["WORLD_SIZE"] if num_processes is None
                else num_processes)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def leave() -> None:
    """Leave the process group, if this process joined one (at the end of
    a CLI run)."""
    if _initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count(group=None) -> int:
    """The number of processes in `group` (None: all of them)."""
    return dist.get_world_size(group) if _initialized() else 1


def is_main_process() -> bool:
    """Rank gate for printing and checkpointing."""
    return process_index() == 0


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_devices(name: str = "barrier") -> None:
    """Global barrier (`name` is for the reader; the JAX package's barrier
    takes one)."""
    del name
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_gather_arrays(x: np.ndarray, group=None) -> np.ndarray:
    """Gather a same-shape host array from every process of `group`
    (None: all of them); returns (num_processes, *shape), in the group's
    rank order. The bytes travel as uint8, so every dtype comes back bit
    for bit."""
    x = np.asarray(x)
    n = process_count(group)
    if n == 1:
        return x[None]
    raw = torch.from_numpy(
        np.ascontiguousarray(x).reshape(-1).view(np.uint8).copy()).to(
        _comm_device())
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    out = torch.stack(parts).cpu().numpy()
    return out.view(x.dtype).reshape((len(parts),) + x.shape)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x; dx = the sum over ranks of dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM all-reduce of `x` over `group` (None: every process), as
    one collective in the forward and one in the backward. Every rank
    must call it in the same order."""
    return _AllReduceSum.apply(x, group)
