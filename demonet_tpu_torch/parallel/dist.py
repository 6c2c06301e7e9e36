"""Process rank utilities (counterpart of demonet_tpu/parallel/dist.py).

On `torch.distributed` when a process group is initialised, else one
process of rank 0. The bootstrap, barriers and gathers wait for the
distributed slice.
"""

from __future__ import annotations

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    """Rank gate for printing and checkpointing."""
    return process_index() == 0
