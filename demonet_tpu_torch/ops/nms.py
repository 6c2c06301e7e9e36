"""Greedy non-maximum suppression over batches of score-sorted problems
(counterpart of demonet_tpu/ops/nms.py and ops/nms_pallas.py).

`nms_keep_batch` is the wrapper of the hand-written CUDA kernel
`csrc/nms.cu`, with the contract of the TPU kernel
demonet_tpu/ops/nms_pallas.py::nms_keep_batch. On a CUDA tensor it
launches the kernel; on a CPU tensor it runs `nms_keep_batch_plain`, the
plain PyTorch version of the same function, which the tests hold bit for
bit against the JAX reference `jax.vmap(nms_mask)`.

The kernel works on an IoU bitmask (bit j of row i: j > i overlaps i)
swept in score order. It has three launch shapes, all exact: "block"
(K <= 512; a block per problem computes the mask rows of the kept
candidates only, as it walks the chain), "tiled" (K <= 8,192; the whole
mask in a device-memory scratch that the wrapper allocates, built by a
grid over 64 x 64 tiles on every SM, then swept by one warp per problem)
and "long" (any K above; the same mask, swept by a block per problem
that keeps the removed bitset in shared memory and reads the rows in
64-bit column pieces). The wrapper takes the block launch up to
K = 512, where there are many problems (the reference postprocess:
P = B * 90, K = 300), the tiled one above, where there are few long ones
(the fused path: P = B, K = 1,024 or 2,048), and the long one above
8,192 (the public NMS of many boxes): `launch_shape(K)`. The tiled and
long launches need P * K * ceil(K / 64) * 8 bytes of scratch
(`scratch_bytes`: 50 MB at P = 1, K = 20,000); a problem whose scratch
cannot be allocated raises MemoryError, saying so.

The public `nms_mask`, `nms` and `batched_nms` (counterparts of
demonet_tpu/ops/nms.py) take one unsorted problem of N boxes: they sort
it stably by score, run it through `nms_keep_batch` as P = 1, K = N (the
kernel on a CUDA tensor, the plain version on the CPU), and scatter the
keep mask back to the original order.

The IoU is computed term by term as the reference writes it:
inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0),
union = area_j + area_i - inter, iou = inter / max(union, 1e-9), and a
candidate is suppressed on a strict `iou > iou_threshold`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from demonet_tpu_torch.ops import _build

# mask rows of 64-bit words. The block launch holds a problem's boxes and
# bitset in shared memory; the tiled one sweeps with 4 words a lane at
# most; the long one takes any K above
WORD = 64
BLOCK_MAX_K = 512
MAX_K = 8192
_LAUNCH = {"block": 1, "tiled": 2, "long": 3}


def nms_keep_batch_plain(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float,
                         score_threshold: float) -> torch.Tensor:
    """Keep mask (P, K) for P problems of K candidates, each sorted by
    descending score; entries with score <= score_threshold are padding.

    A scan over the candidates, vectorized across the P problems: step i
    lets every still-kept candidate i suppress the later ones it overlaps.
    """
    p, k, _ = boxes.shape
    valid = scores > score_threshold
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    suppressed = ~valid
    later = torch.arange(k, device=boxes.device)
    # the loop ends after the last valid candidate of any problem
    bound = int((valid * (later + 1)).amax()) if p * k else 0
    for i in range(bound):
        kept_i = ~suppressed[:, i:i + 1]
        iw = (torch.minimum(x2, x2[:, i:i + 1])
              - torch.maximum(x1, x1[:, i:i + 1])).clamp(min=0.0)
        ih = (torch.minimum(y2, y2[:, i:i + 1])
              - torch.maximum(y1, y1[:, i:i + 1])).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (area + area[:, i:i + 1] - inter).clamp(min=1e-9)
        suppressed |= kept_i & (iou > iou_threshold) & (later > i)
    return ~suppressed


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("nms").nms_keep_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_shape(k: int) -> str:
    """The kernel's launch shape for problems of K candidates."""
    if k <= BLOCK_MAX_K:
        return "block"
    return "tiled" if k <= MAX_K else "long"


def scratch_bytes(p: int, k: int) -> int:
    """Device scratch of a launch over P problems of K candidates: the
    (P, K, ceil(K / 64)) int64 IoU bitmask of the tiled and long launches,
    none for the block launch."""
    if launch_shape(k) == "block":
        return 0
    return p * k * -(-k // WORD) * 8


def nms_keep_batch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float,
                   score_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask over a batch of independent problems.

    Args:
      boxes: (P, K, 4) float32 xyxy, score-sorted descending per problem.
      scores: (P, K) float32; entries <= score_threshold are padding.

    Returns (P, K) bool. A CUDA tensor goes to the kernel `csrc/nms.cu`,
    in the launch shape `launch_shape(K)`, and counts one in
    `nms_keep_batch.launches`; a CPU tensor to `nms_keep_batch_plain`.
    """
    if boxes.ndim != 3 or boxes.shape[-1] != 4 \
            or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_keep_batch: boxes {tuple(boxes.shape)} and "
                         f"scores {tuple(scores.shape)} are not (P, K, 4) "
                         "and (P, K)")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_keep_batch takes float32 boxes and scores, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"nms_keep_batch: boxes on {boxes.device}, scores "
                         f"on {scores.device}")
    if boxes.device.type == "cpu":
        return nms_keep_batch_plain(boxes, scores, iou_threshold,
                                    score_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_batch: no kernel for {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_keep_batch: boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep_batch: boxes must be 16-byte aligned")
    p, k, _ = boxes.shape
    shape = launch_shape(k)
    keep = torch.empty((p, k), dtype=torch.bool, device=boxes.device)
    scratch = None
    if shape != "block":   # the IoU bitmask: (P, K, ceil(K / 64)) words
        try:
            scratch = torch.empty((p, k, -(-k // WORD)), dtype=torch.int64,
                                  device=boxes.device)
        except torch.OutOfMemoryError as e:
            raise MemoryError(
                f"nms_keep_batch: P={p} problems of K={k} need "
                f"{scratch_bytes(p, k)} bytes of device scratch for the IoU "
                "bitmask, which cannot be allocated") from e
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         p, k, iou_threshold, score_threshold,
                         _LAUNCH[shape], stream)
    _build.check(code, "nms_keep_batch")
    nms_keep_batch.launches += 1
    return keep


nms_keep_batch.launches = 0


# scores at or below this are padding in the public API (the JAX default)
_NEG_INF = -1e30


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             score_threshold: float = _NEG_INF) -> torch.Tensor:
    """Greedy NMS keep mask of one problem, in the original box order.

    Args:
      boxes: (N, 4) float32 xyxy.
      scores: (N,) float32. Entries with score <= score_threshold are
        padding: never kept, never suppress anything.
      iou_threshold: j is suppressed when IoU(i, j) > threshold for an
        earlier-kept i.

    Candidates are ordered by descending score, ties by index (a stable
    sort of the negated score, padding last, as `jnp.argsort` orders
    them). On a CUDA tensor the ordered problem goes to the kernel; its
    tiled and long launches (N > 512) take N * ceil(N / 64) * 8 bytes of
    device scratch, and an N whose scratch cannot be allocated raises
    MemoryError.
    """
    n = boxes.shape[0]
    valid = scores > score_threshold
    key = -torch.where(valid, scores, scores.new_tensor(_NEG_INF))
    order = torch.sort(key, stable=True)[1]
    keep_sorted = nms_keep_batch(boxes[order][None].contiguous(),
                                 scores[order][None].contiguous(),
                                 iou_threshold, score_threshold)[0]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    return keep.index_put_((order,), keep_sorted)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int, score_threshold: float = _NEG_INF
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS: the indices of the kept boxes by descending score
    (ties by index), padded to `max_output` (<= N).

    Returns (indices (max_output,) int64, valid (max_output,) bool); the
    padding indices are 0 with valid False.
    """
    if max_output > boxes.shape[0]:
        raise ValueError(f"nms: max_output={max_output} exceeds the "
                         f"{boxes.shape[0]} boxes")
    keep = nms_mask(boxes, scores, iou_threshold, score_threshold)
    kept_scores = torch.where(keep, scores, scores.new_tensor(_NEG_INF))
    top_scores, idx = torch.sort(kept_scores, descending=True, stable=True)
    top_scores, idx = top_scores[:max_output], idx[:max_output]
    valid = top_scores > _NEG_INF / 2
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_threshold: float, max_output: int,
                score_threshold: float = _NEG_INF
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS: boxes of different `labels` never suppress each
    other. Each class is moved to its own coordinate range (label times
    the largest valid coordinate plus one) and one class-agnostic `nms`
    runs over all of them."""
    live = torch.where(scores > score_threshold, boxes.amax(dim=-1),
                       boxes.new_tensor(0.0))
    max_coord = live.amax() if live.numel() else boxes.new_tensor(0.0)
    offsets = labels.to(boxes.dtype)[:, None] * (max_coord + 1.0)
    return nms(boxes + offsets, scores, iou_threshold, max_output,
               score_threshold)
