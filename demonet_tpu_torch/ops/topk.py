"""Chunk-skipping exact top-k of thresholded scores (counterpart of
demonet_tpu/ops/topk_pallas.py).

`topk_sparse` is the wrapper of the hand-written CUDA kernel
`csrc/topk.cu`, which replaces the TPU kernel
demonet_tpu/ops/topk_pallas.py::topk_sparse. It calls the custom op
`demonet_tpu_torch::topk_sparse` (`ops/library.py`): on a CUDA tensor the
op launches the kernel; on a CPU tensor it runs `topk_sparse_plain`, the
plain PyTorch version of the same function.

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

The reference postprocess hands the op the softmax output as it lies:
the view `scores[..., 1:].transpose(1, 2)` of the (B, A, C) scores, one
row per (image, foreground class), a row's entries C floats apart
(`class_major`). A CUDA tensor in that layout takes the kernel's third
launch shape, the class-tile launch: a block copies the (A x T) scores of
T consecutive classes of one image into shared memory and runs each row
through the long-row launch's branches there, T and the warp groups
running them chosen from A, k and the device's shared memory
(`class_tile_plan`: 4 x 12 rows at A = 3,234, 4 x 4 at 8,732, 1 x 2 at
24,732 on an H100). Where not one row fits (A above ~53,500 on an H100,
no model of the repository), the rows are copied contiguous and take the
long-row launch. On a CPU tensor, any layout runs the plain version.

The JAX package's `topk_sparse_xla` is the same function written in XLA
operations, faster than the Pallas kernel on the TPU; it has no separate
counterpart here: both of its `topk_impl` names reach `topk_sparse`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from demonet_tpu_torch.ops import _build

CHUNK = 128
# the register launch holds one row of at most this many scores, 16 per
# thread (ssdlite320: A = 3,234); longer rows take the long-row launch
MAX_ROW = 4096


def topk_sparse_plain(scores: torch.Tensor, k: int,
                      thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., A) float32 -> (..., k) float32 scores and int32 indices,
    contiguous: a stable descending sort of the masked row, padding
    rewritten to (-inf, 0)."""
    neg = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    masked = torch.where(scores > thresh, scores, neg)
    values, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    values = values[..., :k].contiguous()   # the kernel's layout
    live = values > thresh
    return values, torch.where(live, idx[..., :k], 0).to(torch.int32)


_ARGTYPES = {
    "topk_sparse": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p),
    "topk_sparse_classes": (ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                            ctypes.c_int, ctypes.c_void_p),
    "topk_classes_plan": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_longlong)),
}
_ARGTYPES["topk_sparse_long"] = _ARGTYPES["topk_sparse"]


@functools.lru_cache(maxsize=None)
def _kernel(entry: str = "topk_sparse"):
    """The C entry point: `topk_sparse` (the register launch),
    `topk_sparse_long` (rows over MAX_ROW), `topk_sparse_classes` (the
    class-tile launch) or `topk_classes_plan`."""
    fn = getattr(_build.load("topk"), entry)
    fn.argtypes = list(_ARGTYPES[entry])
    fn.restype = ctypes.c_int
    return fn


def class_major(scores: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(pitch, batch stride) in elements where `scores` is a (B, R, A)
    view whose rows lie side by side and whose entries lie `pitch` apart,
    as `x[..., 1:].transpose(1, 2)` of a contiguous (B, A, C) tensor `x`
    (pitch C, batch stride A * C); None for any other layout, contiguous
    rows included."""
    if scores.ndim != 3 or scores.is_contiguous():
        return None
    sb, sr, sa = scores.stride()
    if scores.shape[1] > 1 and sr != 1:
        return None
    return sa, sb


def class_tile_plan(a: int, k: int, slots: int, rows: int
                    ) -> Tuple[int, int, int]:
    """(rows a block holds, warp groups, dynamic shared bytes) of the
    class-tile launch for rows of `a` scores on the current CUDA device
    (`csrc/topk.cu::topk_classes_plan`); rows 0 where not one fits."""
    return _class_tile_plan(torch.cuda.current_device(), a, k, slots, rows)


@functools.lru_cache(maxsize=None)
def _class_tile_plan(device: int, a: int, k: int, slots: int, rows: int
                     ) -> Tuple[int, int, int]:
    tile, groups, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    _build.check(_kernel("topk_classes_plan")(
        a, k, slots, rows, ctypes.byref(tile), ctypes.byref(groups),
        ctypes.byref(smem)), "topk_classes_plan")
    return tile.value, groups.value, smem.value


def topk_sparse(scores: torch.Tensor, k: int, thresh: float,
                slots: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of the scores above `thresh`, per row of the last axis.

    Args:
      scores: (..., A) float32, any A >= k; on CUDA contiguous, or a
        `class_major` (B, R, A) view of the softmax output.
      k: entries per row, 1 <= k <= min(A, slots * 128).
      slots: 128-wide chunks the kernel's compact branch holds; a row
        with more live chunks takes the radix select.

    Returns (..., k) float32 scores and (..., k) int32 indices. It calls
    the op `demonet_tpu_torch::topk_sparse` (`ops/library.py`): a CUDA
    tensor goes to the kernel `csrc/topk.cu` (`topk_sparse_cuda`; counts
    one in `topk_sparse.launches`; contiguous rows over MAX_ROW take its
    long-row launch and count one in `topk_sparse.long_launches` too, a
    class-major view its class-tile launch and one in
    `topk_sparse.class_tile_launches`); a CPU tensor to
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
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_sparse: no kernel for {scores.device}")
    return torch.ops.demonet_tpu_torch.topk_sparse(scores, k, float(thresh),
                                                   slots)


def topk_sparse_cuda(scores: torch.Tensor, k: int, thresh: float,
                     slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of `csrc/topk.cu`: the CUDA implementation of the op
    `demonet_tpu_torch::topk_sparse` (`ops/library.py`). Counts one in
    `topk_sparse.launches`, and one in `long_launches` for contiguous rows
    over MAX_ROW or in `class_tile_launches` for a `class_major` view."""
    a = scores.shape[-1]
    lead = scores.shape[:-1]
    p = scores.numel() // a
    out_sc = torch.empty((*lead, k), dtype=torch.float32, device=scores.device)
    out_idx = torch.empty((*lead, k), dtype=torch.int32, device=scores.device)
    layout = class_major(scores)
    if layout is None and not scores.is_contiguous():
        raise ValueError("topk_sparse: scores must be contiguous, or a "
                         "(B, R, A) view with rows side by side")
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        if layout is not None and class_tile_plan(a, k, slots,
                                                  lead[1])[0] == 0:
            scores, layout = scores.contiguous(), None
        if layout is not None:
            entry = "topk_sparse_classes"
            code = _kernel(entry)(scores.data_ptr(), out_sc.data_ptr(),
                                  out_idx.data_ptr(), lead[0], lead[1], a,
                                  *layout, k, thresh, slots, stream)
        else:
            entry = "topk_sparse" if a <= MAX_ROW else "topk_sparse_long"
            code = _kernel(entry)(scores.data_ptr(), out_sc.data_ptr(),
                                  out_idx.data_ptr(), p, a, k, thresh, slots,
                                  stream)
    _build.check(code, entry)
    topk_sparse.launches += 1
    if entry == "topk_sparse_long":
        topk_sparse.long_launches += 1
    elif entry == "topk_sparse_classes":
        topk_sparse.class_tile_launches += 1
    return out_sc, out_idx


topk_sparse.launches = 0
topk_sparse.long_launches = 0
topk_sparse.class_tile_launches = 0
