"""Device-side marks and waits, with host-clock stand-ins off the card.

On a GPU a mark is a CUDA event recorded on the current stream, and the
time between two marks is the device's; elsewhere (the CPU tests) a mark
is the host clock.
"""

from __future__ import annotations

import time

import torch


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        """Milliseconds from mark a to mark b (both waited for)."""
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def wait(self) -> None:
        """Until the device has done all the current stream holds."""
        if self.cuda:
            torch.cuda.current_stream().synchronize()

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def free(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
