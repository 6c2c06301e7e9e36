"""Batched row gather, out[b, r] = table[b, idx[b, r]] (counterpart of
demonet_tpu/ops/gather_pallas.py and the XLA gather in
demonet_tpu/models/detection.py::_gather_rows).

`gather_rows_batch` is the wrapper of the hand-written CUDA kernel
`csrc/gather.cu`, with the contract of the TPU kernel
demonet_tpu/ops/gather_pallas.py::gather_rows_batch. It calls the custom
op `demonet_tpu_torch::gather_rows_batch` (`ops/library.py`): on a CUDA
tensor the op launches the kernel; on a CPU tensor it runs
`gather_rows_batch_plain` (`torch.gather`). Both copy bits, so both are
bit-equal to `jnp.take_along_axis`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from demonet_tpu_torch.ops import _build


def gather_rows_batch_plain(table: torch.Tensor, idx: torch.Tensor,
                            coord_major: bool = False) -> torch.Tensor:
    """(B, N, D) table, (B, R) idx -> (B, R, D), or (B, D, R)."""
    d = table.shape[-1]
    out = torch.gather(table, 1, idx.long()[..., None].expand(-1, -1, d))
    return out.transpose(1, 2).contiguous() if coord_major else out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("gather").gather_rows_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows_batch_cuda(table: torch.Tensor, idx: torch.Tensor,
                           coord_major: bool) -> torch.Tensor:
    """The launch of `csrc/gather.cu`: the CUDA implementation of the op
    `demonet_tpu_torch::gather_rows_batch` (`ops/library.py`). Counts one
    in `gather_rows_batch.launches`, inside an exported program too."""
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_batch: table and idx must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("gather_rows_batch: table must be 16-byte aligned")
    b, n, d = table.shape
    r = idx.shape[1]
    shape = (b, d, r) if coord_major else (b, r, d)
    out = torch.empty(shape, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         b, n, r, int(coord_major), stream)
    _build.check(code, "gather_rows_batch")
    gather_rows_batch.launches += 1
    return out


def gather_rows_batch(table: torch.Tensor, idx: torch.Tensor,
                      coord_major: bool = False) -> torch.Tensor:
    """Batched exact row gather: out[b, r] = table[b, idx[b, r]].

    Args:
      table: (B, N, 4) float32.
      idx: (B, R) int32 in [0, N). Not range-checked, as on the TPU: a
        check would synchronize the host with the device.
      coord_major: return (B, 4, R) instead of (B, R, 4).

    It calls the op `demonet_tpu_torch::gather_rows_batch`
    (`ops/library.py`): a CUDA tensor goes to the kernel `csrc/gather.cu`
    (`gather_rows_batch_cuda`, contiguous tensors only; counts one in
    `gather_rows_batch.launches`), a CPU tensor to
    `gather_rows_batch_plain`.
    """
    if table.ndim != 3 or table.shape[-1] != 4 or idx.ndim != 2 \
            or idx.shape[0] != table.shape[0]:
        raise ValueError(f"gather_rows_batch: table {tuple(table.shape)} and "
                         f"idx {tuple(idx.shape)} are not (B, N, 4) and (B, R)")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("gather_rows_batch takes a float32 table and int32 "
                        f"indices, got {table.dtype} and {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"gather_rows_batch: table on {table.device}, idx "
                         f"on {idx.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows_batch: no kernel for {table.device}")
    return torch.ops.demonet_tpu_torch.gather_rows_batch(table, idx,
                                                         bool(coord_major))


gather_rows_batch.launches = 0
