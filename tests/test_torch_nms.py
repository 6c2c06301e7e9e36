"""Port vs JAX package: batched greedy NMS (demonet_tpu_torch.ops.nms).

The plain version `nms_keep_batch_plain`, which the kernel wrapper runs on
CPU tensors, must give keep masks bit-equal to `jax.vmap(nms_mask)`. The
CUDA kernel itself (csrc/nms.cu) is held to the plain version on the card
by chip_smoke.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.ops.nms import nms_mask
from demonet_tpu_torch.ops import nms as port_nms

_THR = -5e29  # the postprocess's score threshold for padding


def _random_problems(seed, p, k, valid_prefix=None):
    rng = np.random.RandomState(seed)
    centers = rng.rand(p, k, 2).astype(np.float32) * 100
    wh = rng.rand(p, k, 2).astype(np.float32) * 40 + 2
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    scores = -np.sort(-rng.rand(p, k).astype(np.float32), axis=1)
    if valid_prefix is not None:
        scores[:, valid_prefix:] = -1e30
    return boxes, scores


def _jax_keep(boxes, scores, iou):
    ref = jax.vmap(functools.partial(nms_mask, iou_threshold=iou,
                                     score_threshold=_THR))
    return np.asarray(ref(boxes, scores))


def _port_keep(boxes, scores, iou):
    return port_nms.nms_keep_batch(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), iou,
                                   _THR).numpy()


@pytest.mark.parametrize("seed,p,k,prefix,iou", [
    (0, 6, 40, None, 0.5),
    (1, 5, 64, 23, 0.55),
    (2, 3, 300, 150, 0.55),   # the main path's K
    (3, 4, 16, 0, 0.5),       # nothing valid
    (4, 4, 16, 1, 0.5),       # a single valid candidate
    (5, 2, 50, None, 0.1),    # heavy suppression
])
def test_plain_nms_bit_equal_to_jax(seed, p, k, prefix, iou):
    boxes, scores = _random_problems(seed, p, k, prefix)
    np.testing.assert_array_equal(_port_keep(boxes, scores, iou),
                                  _jax_keep(boxes, scores, iou))


def test_identical_boxes_chain():
    boxes = np.tile(np.asarray([[0.0, 0.0, 10.0, 10.0]], np.float32),
                    (6, 1))[None]
    scores = -np.sort(-np.random.RandomState(0).rand(1, 6).astype(
        np.float32), axis=1)
    keep = _port_keep(boxes, scores, 0.5)
    assert keep[0].tolist() == [True] + [False] * 5
    np.testing.assert_array_equal(keep, _jax_keep(boxes, scores, 0.5))


def test_iou_exactly_at_threshold_is_kept():
    # IoU([0,0,2,1], [0,0,1,1]) = 1 / (2 + 1 - 1) = 0.5 exactly: the strict
    # `>` keeps the second box; at a lower threshold it goes.
    boxes = np.asarray([[[0, 0, 2, 1], [0, 0, 1, 1]]], np.float32)
    scores = np.asarray([[0.9, 0.8]], np.float32)
    assert _port_keep(boxes, scores, 0.5)[0].tolist() == [True, True]
    assert _port_keep(boxes, scores, 0.49)[0].tolist() == [True, False]
    for thr in (0.5, 0.49):
        np.testing.assert_array_equal(_port_keep(boxes, scores, thr),
                                      _jax_keep(boxes, scores, thr))


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    boxes, scores = _random_problems(7, 3, 20, 12)
    before = port_nms.nms_keep_batch.launches
    got = port_nms.nms_keep_batch(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), 0.5, _THR)
    want = port_nms.nms_keep_batch_plain(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), 0.5, _THR)
    assert got.dtype == torch.bool and got.shape == (3, 20)
    assert torch.equal(got, want)
    assert port_nms.nms_keep_batch.launches == before == 0


@pytest.mark.parametrize("boxes,scores,err", [
    (torch.zeros(2, 5, 3), torch.zeros(2, 5), ValueError),
    (torch.zeros(2, 5, 4), torch.zeros(2, 4), ValueError),
    (torch.zeros(2, 5, 4, dtype=torch.float64), torch.zeros(2, 5), TypeError),
    (torch.zeros(2, 5, 4, device="meta"), torch.zeros(2, 5, device="meta"),
     ValueError),
])
def test_wrapper_rejects_bad_inputs(boxes, scores, err):
    with pytest.raises(err):
        port_nms.nms_keep_batch(boxes, scores, 0.5, _THR)
