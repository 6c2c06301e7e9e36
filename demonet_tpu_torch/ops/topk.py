"""Chunk-skipping exact top-k of thresholded scores (counterpart of
demonet_tpu/ops/topk_pallas.py).

`topk_sparse` is the wrapper of the hand-written CUDA kernel
`csrc/topk.cu`, which replaces the TPU kernel
demonet_tpu/ops/topk_pallas.py::topk_sparse. On a CUDA tensor it launches
the kernel; on a CPU tensor it runs `topk_sparse_plain`, the plain PyTorch
version of the same function.

Output contract, per row of the last axis:
  * every entry with score > thresh is bit-equal to a stable descending
    sort of the row: the values, indices and tie order (ascending index)
    that `lax.top_k` gives;
  * every other slot is padding, (-inf, index 0). Index 0 is always in
    range, and a postprocess that re-masks with `score > thresh` never
    reads the padding.

The kernel and the plain version agree bit for bit on every entry,
padding included. The JAX version's padding carries other in-range
indices, and its whole-call fallback to `lax.top_k` returns the true
below-threshold values there; the two differ only in those dead slots.
The kernel decides per row: a row whose live 128-wide chunks fit in
`slots` of them sorts those chunks; a denser row finds its k-th largest
score by radix select, cuts the ties at it in ascending index order and
sorts only the k it keeps. It needs no fallback. Rows of up to 4,096
scores are held in registers; longer ones (the VGG SSDs' 8,732 and
24,732 anchors) take the kernel's second launch shape, which reads the
row from device memory in sweeps, with the same branches and the same
result. No row length goes to the plain version on a CUDA tensor.

The JAX package's `topk_sparse_xla` is the same function written in XLA
operations, faster than the Pallas kernel on the TPU; it has no separate
counterpart here: both of its `topk_impl` names reach `topk_sparse`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from demonet_tpu_torch.ops import _build

CHUNK = 128
# the register launch holds one row of at most this many scores, 16 per
# thread (ssdlite320: A = 3,234); longer rows take the long-row launch
MAX_ROW = 4096


def topk_sparse_plain(scores: torch.Tensor, k: int,
                      thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., A) float32 -> (..., k) float32 scores and int32 indices:
    a stable descending sort of the masked row, padding rewritten to
    (-inf, 0)."""
    neg = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    masked = torch.where(scores > thresh, scores, neg)
    values, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    values, idx = values[..., :k], idx[..., :k]
    live = values > thresh
    return values, torch.where(live, idx, 0).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _kernel(entry: str = "topk_sparse"):
    """The C entry point: `topk_sparse` (the register launch) or
    `topk_sparse_long` (rows over MAX_ROW)."""
    fn = getattr(_build.load("topk"), entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def topk_sparse(scores: torch.Tensor, k: int, thresh: float,
                slots: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of the scores above `thresh`, per row of the last axis.

    Args:
      scores: (..., A) float32, any A >= k; contiguous on CUDA.
      k: entries per row, 1 <= k <= min(A, slots * 128).
      slots: 128-wide chunks the kernel's compact branch holds; a row
        with more live chunks takes the radix select.

    Returns (..., k) float32 scores and (..., k) int32 indices. A CUDA
    tensor goes to the kernel `csrc/topk.cu` (and counts one in
    `topk_sparse.launches`; rows over MAX_ROW take its long-row launch
    and count one in `topk_sparse.long_launches` too); a CPU tensor to
    `topk_sparse_plain`.
    """
    if scores.ndim < 1:
        raise ValueError("topk_sparse: scores must have a last axis")
    if scores.dtype != torch.float32:
        raise TypeError(f"topk_sparse takes float32 scores, got {scores.dtype}")
    a = scores.shape[-1]
    if k > slots * CHUNK:
        raise ValueError(f"k={k} exceeds kernel capacity {slots * CHUNK}; "
                         "raise slots")
    if not 1 <= k <= a:
        raise ValueError(f"topk_sparse: k={k} outside [1, A={a}]")
    if scores.device.type == "cpu":
        return topk_sparse_plain(scores, k, thresh)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_sparse: no kernel for {scores.device}")
    if not scores.is_contiguous():
        raise ValueError("topk_sparse: scores must be contiguous")
    lead = scores.shape[:-1]
    p = scores.numel() // a
    out_sc = torch.empty((*lead, k), dtype=torch.float32, device=scores.device)
    out_idx = torch.empty((*lead, k), dtype=torch.int32, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        entry = "topk_sparse" if a <= MAX_ROW else "topk_sparse_long"
        code = _kernel(entry)(scores.data_ptr(), out_sc.data_ptr(),
                              out_idx.data_ptr(), p, a, k, thresh, slots,
                              stream)
    _build.check(code, entry)
    topk_sparse.launches += 1
    if a > MAX_ROW:
        topk_sparse.long_launches += 1
    return out_sc, out_idx


topk_sparse.launches = 0
topk_sparse.long_launches = 0
