"""Console logging of training (counterpart of demonet_tpu/utils/logging.py):
smoothed meters and the iteration logger with ETA, iteration and data
times and the device's peak memory. `synchronize_between_processes` sums
each meter's count and total over the processes (the global averages),
as the JAX package's does.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import numpy as np
import torch

from demonet_tpu_torch.parallel.dist import (
    all_gather_arrays,
    is_main_process,
    process_count,
)


class SmoothedValue:
    """Track a series of values; report the window's median and average
    and the global average."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, group=None):
        """Sum count and total across the processes of `group` (None: all
        of them), in float64 (the window stays this process's own)."""
        if process_count(group) == 1:
            return
        agg = all_gather_arrays(
            np.asarray([self.count, self.total], np.float64),
            group).sum(axis=0)
        self.count = int(agg[0])
        self.total = float(agg[1])

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


def _device_mem_mb() -> Optional[float]:
    """Peak memory allocated on the current CUDA device, in MB; None when
    CUDA was never initialised in this process (a CPU run)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    """Iteration logger with ETA and timing meters."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'")

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self, group=None):
        """Every meter's count and total summed across the processes of
        `group` (None: all of them; every process must hold the same
        meters, in the same order)."""
        for meter in self.meters.values():
            meter.synchronize_between_processes(group)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", pre_print=None):
        """Yield items, printing the meters every print_freq items and at
        the last one (rank 0 only).

        pre_print: optional zero-argument callable run before each print
        (on every rank); the train loop uses it to read the device's
        metrics into the meters only there, not after every step.
        """
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space = len(str(total)) if total else 6
        main = is_main_process()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            due = i % print_freq == 0 or (total and i == total - 1)
            if due and pre_print is not None:
                pre_print()
            if due and main:
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta = str(datetime.timedelta(seconds=int(eta_seconds)))
                else:
                    eta = "?"
                mem = _device_mem_mb()
                mem_str = f"  mem: {mem:.0f}MB" if mem is not None else ""
                count = f"[{i:{space}d}/{total}]" if total else f"[{i}]"
                print(self.delimiter.join([
                    header, count, f"eta: {eta}", str(self),
                    f"time: {iter_time}", f"data: {data_time}"]) + mem_str)
            i += 1
            end = time.time()

        elapsed = time.time() - start_time
        if main:
            print(f"{header} Total time: "
                  f"{str(datetime.timedelta(seconds=int(elapsed)))} "
                  f"({elapsed / max(i, 1):.4f} s / it)")
