"""Set-up's share spent on the program's kernel libraries: nvcc's wall time
for each library built in this process plus each `ctypes` load
(`ops/_build.py`'s `seconds`); 0.0 where the cell's step uses none."""

from harness import program_spans


def read(run):
    return program_spans.kernel_build_s(run)
