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


# -- word boundaries: the kernel's 64-bit mask words and its sweep -----------


def _marks(k):
    """Where the word-boundary problems put a chain and a pair: around
    candidate 64, and for K > 512 (the tiled launch) around 512 and 576."""
    return [min(64, k - 2)] + [m for m in (512, 576) if m + 1 < k]


def _word_boundary_problems(k, seed=11):
    """Three problems of K candidates: random boxes in [0, 100]^2, plus at
    each mark m an identical-box chain (m - 3, m - 2, m) and a pair at IoU
    0.5 exactly (m - 1, m + 1), across a 64-bit word boundary when m is a
    multiple of 64 and K > m, far from the random boxes and from the other
    marks. Problem 0 is valid throughout, 1 and 2 have shorter valid
    prefixes."""
    boxes, scores = _random_problems(seed, 3, k)
    marks = _marks(k)
    for n, m in enumerate(marks):
        d = 100.0 * n
        chain = [c for c in (m - 3, m - 2, m) if 0 <= c < k]
        boxes[:, chain] = [1000.0 + d, 1000.0, 1010.0 + d, 1010.0]
        boxes[:, m - 1] = [2000.0 + d, 0.0, 2002.0 + d, 1.0]
        if m + 1 < k:
            boxes[:, m + 1] = [2000.0 + d, 0.0, 2001.0 + d, 1.0]  # IoU 1 / 2
    scores[1, marks[-1] + 2:] = -1e30
    scores[2, k // 2:] = -1e30
    return boxes, scores


def _bitmask_keep(boxes, scores, iou, thr, long_sweep=False):
    """Test-only model of csrc/nms.cu: bit j of mask row i set when j > i
    and IoU(i, j) > iou (inter == 0 decided without the division), rows
    packed in 64-bit words, then a sweep in score order that carries the
    current word and ORs in the rows of kept candidates. (The kernel's
    block launch computes only the kept rows, as it sweeps; the rows it
    reads are these.) `long_sweep` models the long launch's order: the
    chain through a tile on the rows' diagonal words first, then the kept
    rows' later words OR-ed in, a column piece at a time."""
    p, k, _ = boxes.shape
    words = -(-k // 64)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    # [:, i, j]: row i, column j, in the reference's order of operations
    iw = (torch.minimum(x2[:, None, :], x2[:, :, None])
          - torch.maximum(x1[:, None, :], x1[:, :, None])).clamp(min=0.0)
    ih = (torch.minimum(y2[:, None, :], y2[:, :, None])
          - torch.maximum(y1[:, None, :], y1[:, :, None])).clamp(min=0.0)
    inter = iw * ih
    union = area[:, None, :] + area[:, :, None] - inter
    ratio = inter / union.clamp(min=1e-9)
    over = torch.where(inter == 0, torch.tensor(0.0 > iou), ratio > iou)
    over &= torch.ones(k, k, dtype=torch.bool).triu(1)
    weights = np.left_shift(np.uint64(1), np.arange(64, dtype=np.uint64))

    def pack(bits):                       # (..., k) bool -> (..., words)
        padded = np.zeros(bits.shape[:-1] + (words * 64,), np.uint64)
        padded[..., :k] = bits
        return (padded.reshape(bits.shape[:-1] + (words, 64))
                * weights).sum(-1, dtype=np.uint64)

    mask = pack(over.numpy())                              # (p, k, words)
    removed = pack(~(scores > thr).numpy())        # invalid from the start
    removed[:, -1] |= ~pack(np.ones(k, bool))[-1]  # and every j >= K
    for q in range(p):
        for w in range(words):
            cur = removed[q, w]
            kept = []
            for b in range(min(64, k - 64 * w)):
                if not (int(cur) >> b) & 1:
                    row = mask[q, 64 * w + b]
                    cur |= row[w]
                    kept.append(b)
                    if not long_sweep:
                        removed[q, w + 1:] |= row[w + 1:]
            removed[q, w] = cur
            if long_sweep:
                for piece in range(w + 1, words):
                    for b in kept:
                        removed[q, piece] |= mask[q, 64 * w + b, piece]
    bits = (removed[..., None] & weights) != 0
    return torch.from_numpy(~bits.reshape(p, words * 64)[:, :k])


# K = 576 and 1,024 take the kernel's tiled launch (K > 512)
@pytest.mark.parametrize("k", [63, 64, 65, 128, 300, 576, 1024])
@pytest.mark.parametrize("iou", [0.5, 0.49])
def test_plain_nms_word_boundaries_match_jax(k, iou):
    boxes, scores = _word_boundary_problems(k)
    keep = _port_keep(boxes, scores, iou)
    np.testing.assert_array_equal(keep, _jax_keep(boxes, scores, iou))
    for m in _marks(k):
        assert keep[0, m - 3] and not keep[0, [m - 2, m]].any()  # the chain
        if m + 1 < k:                    # the pair at IoU 0.5 exactly
            assert keep[0, m - 1] and keep[0, m + 1] == (iou >= 0.5)


@pytest.mark.parametrize("k", [63, 64, 65, 128, 300, 576, 1024])
@pytest.mark.parametrize("iou", [0.5, 0.49])
def test_bitmask_model_bit_equal_to_plain(k, iou):
    boxes, scores = (torch.from_numpy(t)
                     for t in _word_boundary_problems(k, seed=12))
    want = port_nms.nms_keep_batch_plain(boxes, scores, iou, _THR)
    assert torch.equal(_bitmask_keep(boxes, scores, iou, _THR), want)


@pytest.mark.parametrize("k", [65, 300, 576, 1024])
@pytest.mark.parametrize("iou", [0.5, 0.49])
def test_long_sweep_model_bit_equal_to_plain(k, iou):
    """The long launch's order of work (chain per tile, then the kept
    rows' later column pieces) keeps what the greedy scan keeps."""
    boxes, scores = (torch.from_numpy(t)
                     for t in _word_boundary_problems(k, seed=13))
    want = port_nms.nms_keep_batch_plain(boxes, scores, iou, _THR)
    assert torch.equal(
        _bitmask_keep(boxes, scores, iou, _THR, long_sweep=True), want)


def test_launch_shape_by_k():
    ks = (1, 300, 512, 513, 576, 1024, 2048, port_nms.MAX_K,
          port_nms.MAX_K + 1, 16384, 20000, 1 << 20)
    assert [port_nms.launch_shape(k) for k in ks] == \
        ["block"] * 3 + ["tiled"] * 5 + ["long"] * 4


def test_scratch_bytes_by_k():
    """The IoU bitmask of the tiled and long launches: P * K * ceil(K / 64)
    words of 8 bytes (50 MB for one problem of 20,000 boxes); the block
    launch takes none."""
    assert port_nms.scratch_bytes(2880, 300) == 0
    assert port_nms.scratch_bytes(32, 2048) == 32 * 2048 * 32 * 8
    assert port_nms.scratch_bytes(1, port_nms.MAX_K + 1) == 8193 * 129 * 8
    assert port_nms.scratch_bytes(1, 20000) == 20000 * 313 * 8 == 50_080_000
