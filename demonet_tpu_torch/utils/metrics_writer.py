"""Structured training metrics (counterpart of
demonet_tpu/utils/metrics_writer.py): one JSON object per step appended
to <output_dir>/metrics.jsonl, on rank 0 only, and, with
tensorboard=True, the same scalars as TensorBoard events under
<output_dir>/tb through `torch.utils.tensorboard` when the `tensorboard`
package imports (JSONL only otherwise, as the JAX package does without
tensorflow).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from demonet_tpu_torch.parallel.dist import is_main_process


class MetricsWriter:
    """Append scalar metrics to <output_dir>/metrics.jsonl (and to a
    TensorBoard event file when asked and possible: `tensorboard` says
    whether that stream is live)."""

    def __init__(self, output_dir: str, tensorboard: bool = False):
        self.enabled = is_main_process()
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._tb = None
        if not self.enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        if tensorboard:
            # imported only when asked: it may pull in tensorflow
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._tb = SummaryWriter(os.path.join(output_dir, "tb"))

    @property
    def tensorboard(self) -> bool:
        """Whether scalars also go to TensorBoard events."""
        return self._tb is not None

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "train") -> None:
        if not self.enabled:
            return
        record = {"step": int(step), "time": time.time(),
                  **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
