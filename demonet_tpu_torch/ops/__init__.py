"""Box geometry, NMS, row gather, sparse top-k and the fused
inverted-residual block, with the CUDA kernels' wrappers.

Kernels are built and loaded at their first call on a CUDA tensor
(`_build.py`), never on import.
"""
