"""Data parallelism on torch.distributed (counterpart of
demonet_tpu/parallel/): the process bootstrap and collectives
(`dist.py`) and the data-parallel mesh (`mesh.py`)."""

from demonet_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    batch_sharding,
    data_mesh,
    host_local_values,
    replicate,
    shard_batch,
)
from demonet_tpu_torch.parallel.dist import (  # noqa: F401
    all_gather_arrays,
    all_reduce_sum,
    initialize,
    is_main_process,
    process_count,
    process_index,
    sync_devices,
)
