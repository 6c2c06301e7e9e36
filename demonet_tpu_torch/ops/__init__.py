"""Box geometry, NMS, row gather, sparse top-k and the fused
inverted-residual block, with the CUDA kernels' wrappers.

Kernels are built and loaded at their first call on a CUDA tensor
(`_build.py`), never on import. Importing this package registers the
kernels as `torch.library` custom ops (`library.py`): an exported program
that holds them loads only after `import demonet_tpu_torch.ops`.
"""

from demonet_tpu_torch.ops import library  # noqa: F401 (registers the ops)
