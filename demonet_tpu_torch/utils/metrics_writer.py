"""Structured training metrics (counterpart of
demonet_tpu/utils/metrics_writer.py): one JSON object per step appended
to <output_dir>/metrics.jsonl, on rank 0 only. The JAX package's optional
TensorBoard stream has no port.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from demonet_tpu_torch.parallel.dist import is_main_process


class MetricsWriter:
    """Append scalar metrics to <output_dir>/metrics.jsonl."""

    def __init__(self, output_dir: str):
        self.enabled = is_main_process()
        self.path = os.path.join(output_dir, "metrics.jsonl")
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "train") -> None:
        if not self.enabled:
            return
        record = {"step": int(step), "time": time.time(),
                  **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
