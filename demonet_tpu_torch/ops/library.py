"""The hand-written kernels as `torch.library` custom ops, in the namespace
`demonet_tpu_torch`.

  * `demonet_tpu_torch::nms_keep_batch(boxes, scores, iou_threshold,
    score_threshold) -> (P, K) bool`  (K1, `csrc/nms.cu`);
  * `demonet_tpu_torch::gather_rows_batch(table, idx, coord_major)
    -> (B, R, 4) or (B, 4, R) float32`  (K2, `csrc/gather.cu`);
  * `demonet_tpu_torch::topk_sparse(scores, k, thresh, slots)
    -> ((..., k) float32, (..., k) int32)`  (K3, `csrc/topk.cu`).

Each op's CPU implementation is its kernel's plain PyTorch version, its
CUDA implementation the kernel's launch (which counts the launch), and its
fake implementation gives the output shapes and dtypes, so `torch.export`
traces the op as one node of the program without running either. The
public wrappers (`ops/nms.py::nms_keep_batch`,
`ops/gather.py::gather_rows_batch`, `ops/topk.py::topk_sparse`) check
their arguments and call the op: eager serving, the public NMS,
evaluation and an exported program all take this one route.

`demonet_tpu_torch/ops/__init__.py` imports this module, so importing any
of the ops modules registers the ops, once per process. An exported
program that holds them loads only after that import
(`export/program.py::load_exported` makes it).

The implementations are looked up in their modules at each call, so a
caller that puts another function in a module's place (a test watching
the plain version) is seen.
"""

from typing import Tuple

import torch
from torch import Tensor

from demonet_tpu_torch.ops import gather, nms, topk

NAMESPACE = "demonet_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::nms_keep_batch", mutates_args=(),
                         device_types="cpu")
def nms_keep_batch(boxes: Tensor, scores: Tensor, iou_threshold: float,
                   score_threshold: float) -> Tensor:
    return nms.nms_keep_batch_plain(boxes, scores, iou_threshold,
                                    score_threshold)


@nms_keep_batch.register_kernel("cuda")
def _nms_keep_batch_cuda(boxes, scores, iou_threshold, score_threshold):
    return nms.nms_keep_batch_cuda(boxes, scores, iou_threshold,
                                   score_threshold)


@nms_keep_batch.register_fake
def _nms_keep_batch_fake(boxes, scores, iou_threshold, score_threshold):
    return scores.new_empty(scores.shape, dtype=torch.bool)


@torch.library.custom_op(f"{NAMESPACE}::gather_rows_batch", mutates_args=(),
                         device_types="cpu")
def gather_rows_batch(table: Tensor, idx: Tensor,
                      coord_major: bool) -> Tensor:
    return gather.gather_rows_batch_plain(table, idx, coord_major)


@gather_rows_batch.register_kernel("cuda")
def _gather_rows_batch_cuda(table, idx, coord_major):
    return gather.gather_rows_batch_cuda(table, idx, coord_major)


@gather_rows_batch.register_fake
def _gather_rows_batch_fake(table, idx, coord_major):
    b, r, d = idx.shape[0], idx.shape[1], table.shape[-1]
    return table.new_empty((b, d, r) if coord_major else (b, r, d))


@torch.library.custom_op(f"{NAMESPACE}::topk_sparse", mutates_args=(),
                         device_types="cpu")
def topk_sparse(scores: Tensor, k: int, thresh: float,
                slots: int) -> Tuple[Tensor, Tensor]:
    return topk.topk_sparse_plain(scores, k, thresh)


@topk_sparse.register_kernel("cuda")
def _topk_sparse_cuda(scores, k, thresh, slots):
    return topk.topk_sparse_cuda(scores, k, thresh, slots)


@topk_sparse.register_fake
def _topk_sparse_fake(scores, k, thresh, slots):
    shape = (*scores.shape[:-1], k)
    return (scores.new_empty(shape, dtype=torch.float32),
            scores.new_empty(shape, dtype=torch.int32))
