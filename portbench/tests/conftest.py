"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`card` that need a CUDA device and skip without one.

    python -m pytest portbench/tests -q

from the root of a checkout.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """Skip the test where no CUDA device is there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


def shrink(cell: dict) -> None:
    """A cell at a size a CPU test holds: batch 2, a pool of 3 batches, a
    train window's checked step among its first 2."""
    t = cell["traffic"]
    t.update(batch=2, pool=3, trace_requests=2)
    if t["entry"] == "serve":
        t["reference_rows"] = 2
    else:
        t.update(setup_steps=3, window_check_span=2)
