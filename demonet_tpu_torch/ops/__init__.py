"""Box geometry, NMS and row gather, with the CUDA kernels' wrappers.

Kernels are built and loaded at their first call on a CUDA tensor
(`_build.py`), never on import.
"""
