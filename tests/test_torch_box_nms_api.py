"""Port vs JAX package: the public box ops and NMS API
(demonet_tpu_torch/ops/boxes.py: generalized_box_iou,
remove_small_boxes_mask, masks_to_boxes; ops/nms.py: nms_mask, nms,
batched_nms).

Each runs on the same numpy inputs in both packages and must be
bit-equal: GIoU values, masks, keep masks, padded indices and validity.
The JAX functions run op by op, as written (jit lets XLA fuse GIoU's
divides into other roundings).
On the CPU the NMS goes through `nms_keep_batch`'s plain version as one
problem (P = 1, K = N) sorted by score; on the card the same call
launches the CUDA kernel, which chip_smoke.py holds to the plain version.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.ops import boxes as jax_boxes
from demonet_tpu_torch.ops import boxes as port_boxes
from demonet_tpu_torch.ops import nms as port_nms

# the module: demonet_tpu.ops exports its function `nms` under that name
jax_nms = importlib.import_module("demonet_tpu.ops.nms")


def _boxes(rng, n, spread=100.0, size=40.0):
    centers = rng.rand(n, 2).astype(np.float32) * spread
    wh = rng.rand(n, 2).astype(np.float32) * size
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- box ops ----------------------------------------------------------------

@pytest.mark.parametrize("seed,m,n,degenerate", [
    (0, 7, 9, False), (1, 1, 30, False), (2, 12, 12, True),
])
def test_generalized_box_iou_bit_equal(seed, m, n, degenerate):
    rng = np.random.RandomState(seed)
    b1, b2 = _boxes(rng, m), _boxes(rng, n)
    if degenerate:   # zero-area boxes and a repeated point: guarded divides
        b1[0] = [5, 5, 5, 5]
        b2[:2] = [[5, 5, 5, 5], [5, 5, 5, 5]]
        b1[1] = b2[3]
    got = port_boxes.generalized_box_iou(_t(b1), _t(b2)).numpy()
    # op by op, as written: under jit XLA fuses the divides and moves the
    # last bits of some entries (3 of 63 here)
    want = np.asarray(jax_boxes.generalized_box_iou(b1, b2))
    assert got.shape == (m, n)
    _equal(got, want)


def test_generalized_box_iou_batched_bit_equal():
    rng = np.random.RandomState(3)
    b1 = _boxes(rng, 2 * 5).reshape(2, 5, 4)
    b2 = _boxes(rng, 2 * 6).reshape(2, 6, 4)
    _equal(port_boxes.generalized_box_iou(_t(b1), _t(b2)).numpy(),
           jax_boxes.generalized_box_iou(b1, b2))


@pytest.mark.parametrize("min_size", [0.0, 1.0, 7.5])
def test_remove_small_boxes_mask_bit_equal(min_size):
    rng = np.random.RandomState(4)
    b = _boxes(rng, 40, size=15.0).reshape(4, 10, 4)
    b[0, 0] = [3, 3, 3 + min_size, 3 + min_size]   # sides exactly min_size
    got = port_boxes.remove_small_boxes_mask(_t(b), min_size).numpy()
    _equal(got, jax_boxes.remove_small_boxes_mask(b, min_size))
    assert got[0, 0]


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.float32])
def test_masks_to_boxes_bit_equal(dtype):
    rng = np.random.RandomState(5)
    masks = np.zeros((2, 4, 13, 17), dtype)
    masks[0, 0, 2:6, 3:9] = 1
    masks[0, 1] = rng.rand(13, 17) > 0.8
    masks[1, 2, 12, 16] = 1                 # one pixel in the last corner
    # masks[0, 2], [0, 3], [1, 0], ...: empty -> zeros
    got = port_boxes.masks_to_boxes(_t(masks)).numpy()
    want = np.asarray(jax_boxes.masks_to_boxes(jnp.asarray(masks)))
    assert got.dtype == np.float32 and got.shape == (2, 4, 4)
    _equal(got, want)
    assert got[1, 2].tolist() == [16.0, 12.0, 16.0, 12.0]
    assert not got[0, 2].any()


# -- the NMS API ------------------------------------------------------------

def _problem(case, seed=0):
    """(boxes, scores, iou_threshold, score_threshold) of a named case."""
    rng = np.random.RandomState(seed)
    if case == "random":
        return _boxes(rng, 200), rng.rand(200).astype(np.float32), 0.5, \
            jax_nms._NEG_INF
    if case == "duplicate_scores":   # ties broken by index
        b = _boxes(rng, 120, spread=60.0)
        s = rng.choice(np.float32([0.2, 0.5, 0.9]), 120).astype(np.float32)
        return b, s, 0.45, jax_nms._NEG_INF
    if case == "padded_at_threshold":   # score == threshold is padding
        b = _boxes(rng, 80)
        s = rng.rand(80).astype(np.float32)
        s[::3] = np.float32(0.3)
        s[1::7] = np.float32(-1e30)
        return b, s, 0.5, 0.3
    if case == "iou_at_threshold":   # IoU exactly 0.5: strict > keeps it
        b = np.asarray([[0, 0, 2, 1], [0, 0, 1, 1], [10, 10, 12, 11],
                        [10, 10, 11, 11], [10, 10, 11, 11]] * 2, np.float32)
        s = np.asarray([0.9, 0.8, 0.7, 0.6, 0.6] + [-1e30] * 5, np.float32)
        return b, s, 0.5, jax_nms._NEG_INF
    if case == "all_padding":
        return _boxes(rng, 10), np.full(10, -1e30, np.float32), 0.5, \
            jax_nms._NEG_INF
    raise ValueError(case)


_CASES = ("random", "duplicate_scores", "padded_at_threshold",
          "iou_at_threshold", "all_padding")


@pytest.mark.parametrize("case", _CASES)
def test_nms_mask_bit_equal(case):
    b, s, iou, thr = _problem(case)
    got = port_nms.nms_mask(_t(b), _t(s), iou, thr).numpy()
    want = jax.jit(jax_nms.nms_mask)(b, s, iou, thr)
    _equal(got, want)
    if case == "iou_at_threshold":
        assert got.tolist() == [True] * 4 + [False] * 6


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("max_output", [1, 5, 10])
def test_nms_bit_equal(case, max_output):
    b, s, iou, thr = _problem(case)
    idx, valid = port_nms.nms(_t(b), _t(s), iou, max_output, thr)
    want_idx, want_valid = jax.jit(jax_nms.nms, static_argnums=3)(
        b, s, iou, max_output, thr)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    _equal(idx.numpy(), want_idx)
    _equal(valid.numpy(), want_valid)


@pytest.mark.parametrize("case", _CASES)
def test_batched_nms_bit_equal(case):
    b, s, iou, thr = _problem(case, seed=1)
    labels = np.random.RandomState(7).randint(0, 4, len(s)).astype(np.int32)
    got = port_nms.batched_nms(_t(b), _t(s), _t(labels), iou, 10, thr)
    want = jax.jit(jax_nms.batched_nms, static_argnums=4)(
        b, s, labels, iou, 10, thr)
    _equal(got[0].numpy(), want[0])
    _equal(got[1].numpy(), want[1])


def test_batched_nms_keeps_other_classes():
    b = np.asarray([[0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 10, 10]],
                   np.float32)
    s = np.asarray([0.9, 0.8, 0.7], np.float32)
    labels = np.asarray([1, 2, 1], np.int64)
    idx, valid = port_nms.batched_nms(_t(b), _t(s), _t(labels), 0.5, 3)
    assert idx.tolist() == [0, 1, 0] and valid.tolist() == [True, True, False]


def test_nms_api_runs_one_sorted_problem_through_the_wrapper(monkeypatch):
    """nms_mask hands `nms_keep_batch` (the kernel's wrapper) one problem
    of all N candidates, sorted by descending score with ties by index,
    and scatters its keep mask back."""
    calls = []
    wrapper = port_nms.nms_keep_batch

    def spy(boxes, scores, iou, thr):
        calls.append((tuple(boxes.shape), scores.clone()))
        return wrapper(boxes, scores, iou, thr)

    monkeypatch.setattr(port_nms, "nms_keep_batch", spy)
    b, s, iou, thr = _problem("duplicate_scores")
    port_nms.nms(_t(b), _t(s), iou, 5, thr)
    assert len(calls) == 1 and calls[0][0] == (1, len(s), 4)
    sorted_scores = calls[0][1][0].numpy()
    assert (np.diff(sorted_scores) <= 0).all()
    _equal(sorted_scores, s[np.argsort(-s, kind="stable")])


def test_nms_max_output_over_n_raises():
    b, s, iou, thr = _problem("all_padding")
    with pytest.raises(ValueError, match="max_output"):
        port_nms.nms(_t(b), _t(s), iou, 11, thr)
