"""Port vs JAX package: the chunk-skipping sparse top-k
(demonet_tpu_torch.ops.topk) and the reference postprocess's topk_impl
modes.

`topk_sparse` runs its plain version on CPU tensors. On every entry above
the threshold it must be bit-equal to the JAX `topk_sparse_xla`, the numpy
oracle `topk_sparse_reference` and `lax.top_k` (values, indices, tie
order); every other slot must be the padding (-inf, 0). The CUDA kernel
(csrc/topk.cu) is held to the plain version on every entry, padding
included, on the card by chip_smoke.py.

The reference core with every topk_impl name ('sparse', 'sparse_pallas',
'approx', 'exact'), each of which reaches K3 on the scores' class-major
view, must be bit-equal to the JAX core with topk_impl 'exact' given the
same scores and boxes. Parameter ids avoid the substring that
tests/conftest.py marks slow.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.models import detection as jax_det
from demonet_tpu.ops.boxes import clip_boxes_to_image, decode_boxes
from demonet_tpu.ops.topk_pallas import topk_sparse_reference, topk_sparse_xla
from demonet_tpu_torch.models import detection as port_det
from demonet_tpu_torch.ops import topk as port_topk


def _sparse_scores(rng, p, a, frac, thresh=1e-3):
    """Mostly-below-threshold scores with `frac` sparse spikes."""
    base = rng.random((p, a)).astype(np.float32) * thresh * 0.9
    n_hot = int(p * a * frac)
    if n_hot:
        pi = rng.integers(0, p, n_hot)
        ai = rng.integers(0, a, n_hot)
        base[pi, ai] = rng.random(n_hot).astype(np.float32) * 0.9 + thresh * 2
    return base


def _port(scores, k, thresh, slots):
    sc, idx = port_topk.topk_sparse(torch.from_numpy(scores), k, thresh,
                                    slots)
    assert sc.dtype == torch.float32 and idx.dtype == torch.int32
    return sc.numpy(), idx.numpy()


def _assert_contract(sc, idx, scores, k, thresh, slots):
    """Live entries bit-equal to every JAX formulation; padding (-inf, 0)."""
    ref_sc, ref_idx = topk_sparse_reference(scores, k, thresh)
    live = ref_sc > -np.inf
    np.testing.assert_array_equal(sc > thresh, live)
    np.testing.assert_array_equal(sc[live], ref_sc[live])
    np.testing.assert_array_equal(idx[live], ref_idx[live])
    assert np.all(sc[~live] == -np.inf) and np.all(idx[~live] == 0)
    t_sc, t_idx = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(sc[live], np.asarray(t_sc)[live])
    np.testing.assert_array_equal(idx[live], np.asarray(t_idx)[live])
    x_sc, x_idx = jax.jit(functools.partial(
        topk_sparse_xla, k=k, thresh=thresh, slots=slots))(jnp.asarray(scores))
    np.testing.assert_array_equal(sc[live], np.asarray(x_sc)[live])
    np.testing.assert_array_equal(idx[live], np.asarray(x_idx)[live])


@pytest.mark.parametrize("seed,frac", [(0, 0.001), (1, 0.01), (2, 0.0)])
def test_sparse_topk_matches_jax_above_threshold(seed, frac):
    rng = np.random.default_rng(seed)
    scores = _sparse_scores(rng, 24, 700, frac)
    sc, idx = _port(scores, 96, 1e-3, 4)
    assert sc.shape == idx.shape == (24, 96)
    _assert_contract(sc, idx, scores, 96, 1e-3, 4)


def test_sparse_topk_overflowing_rows_are_exact():
    """Dense scores: every row has more live chunks than slots (the
    kernel takes its radix select there; JAX falls back to lax.top_k)."""
    rng = np.random.default_rng(3)
    scores = rng.random((10, 700)).astype(np.float32)  # all above 1e-3
    sc, idx = _port(scores, 64, 1e-3, 2)
    t_sc, t_idx = jax.lax.top_k(jnp.asarray(scores), 64)
    np.testing.assert_array_equal(sc, np.asarray(t_sc))
    np.testing.assert_array_equal(idx, np.asarray(t_idx))
    _assert_contract(sc, idx, scores, 64, 1e-3, 2)


def test_sparse_topk_batched_shape():
    rng = np.random.default_rng(4)
    scores = _sparse_scores(rng, 6 * 5, 300, 0.01).reshape(6, 5, 300)
    sc, idx = _port(scores, 32, 1e-3, 3)
    assert sc.shape == (6, 5, 32) and idx.shape == (6, 5, 32)
    _assert_contract(sc.reshape(30, 32), idx.reshape(30, 32),
                     scores.reshape(30, 300), 32, 1e-3, 3)


def test_sparse_topk_capacity_guard():
    for fn in (lambda s: topk_sparse_xla(jnp.asarray(s), 300, 1e-3, slots=2),
               lambda s: port_topk.topk_sparse(torch.from_numpy(s), 300, 1e-3,
                                               2)):
        with pytest.raises(ValueError, match="capacity"):
            fn(np.zeros((4, 300), np.float32))


def test_sparse_topk_exact_score_ties():
    """Identical scores across chunks: ascending index, as lax.top_k."""
    scores = np.zeros((8, 512), np.float32)
    scores[:, [5, 200, 139, 260, 391]] = 0.25
    scores[:, 300] = 0.5
    sc, idx = _port(scores, 8, 1e-3, 6)
    assert (sc[:, :6] > 0).all() and (sc[:, 6:] == -np.inf).all()
    assert idx[0].tolist() == [300, 5, 139, 200, 260, 391, 0, 0]
    _assert_contract(sc, idx, scores, 8, 1e-3, 6)


def test_sparse_topk_live_chunk_counts_around_slots():
    """Rows with 0, slots and slots + 1 live chunks, a partial last chunk,
    and a live entry in it."""
    a, slots = 1250, 8                        # 10 chunks, the last partial
    scores = np.full((4, a), 5e-4, np.float32)
    for row, chunks in ((1, range(8)), (2, range(9)), (3, (0, 3, 9))):
        for c in chunks:
            scores[row, c * 128 + (7 * c) % 100] = 0.5 + 0.01 * c
    scores[3, a - 1] = 0.9                    # last entry of the row
    sc, idx = _port(scores, 300, 1e-3, slots)
    assert not (sc[0] > -np.inf).any()
    assert [(sc[r] > -np.inf).sum() for r in (1, 2, 3)] == [8, 9, 4]
    assert idx[3, 0] == a - 1
    _assert_contract(sc, idx, scores, 300, 1e-3, slots)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    scores = torch.from_numpy(_sparse_scores(np.random.default_rng(5), 6,
                                             400, 0.01))
    before = port_topk.topk_sparse.launches
    got = port_topk.topk_sparse(scores, 50, 1e-3, 2)
    want = port_topk.topk_sparse_plain(scores, 50, 1e-3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert port_topk.topk_sparse.launches == before == 0


@pytest.mark.parametrize("scores,k,slots,err", [
    (torch.zeros(2, 300, dtype=torch.float64), 10, 8, TypeError),
    (torch.zeros(2, 300), 301, 8, ValueError),      # k > A
    (torch.zeros(2, 300), 0, 8, ValueError),
    (torch.zeros(2, 5000), 1025, 8, ValueError),    # k > slots * 128, long row
    (torch.zeros(2, 300, device="meta"), 10, 8, ValueError),
])
def test_wrapper_rejects_bad_inputs(scores, k, slots, err):
    with pytest.raises(err):
        port_topk.topk_sparse(scores, k, 1e-3, slots)


def _core_case(regime):
    """Scores (B, A, C), boxes (B, A, 4) and config for the core test."""
    rng = np.random.default_rng({"dense": 20, "sparse": 21, "tied": 22}[regime])
    b, a, c, size = 2, 700, 6, (64, 64)
    logits = rng.normal(0.0, 1.0, (b, a, c)).astype(np.float32)
    if regime != "dense":    # background wins nearly everywhere
        logits[..., 0] += 12.0
        hot = rng.integers(0, a, 40)
        logits[:, hot, rng.integers(1, c, 40)] += 14.0
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    if regime == "tied":     # coarse scores: many exact ties to break
        scores = (np.round(scores * 40.0) / 40.0).astype(np.float32)
    xy = rng.random((a, 2)).astype(np.float32) * 56
    anchors = np.concatenate([xy - 6, xy + 6], -1).astype(np.float32)
    deltas = rng.normal(0.0, 0.5, (b, a, 4)).astype(np.float32)
    boxes = np.array(clip_boxes_to_image(
        decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)[None]), size))
    config = jax_det.SSDConfig(
        size=size, num_classes=c, score_thresh=0.001, nms_thresh=0.55,
        detections_per_img=300, topk_candidates=200)
    return scores, boxes, config


@pytest.mark.parametrize("topk_impl",
                         ["sparse", "sparse_pallas", "approx", "exact"],
                         ids=["sparse", "sparse-kernel", "approx", "exact"])
@pytest.mark.parametrize("regime", ["dense", "sparse", "tied"])
def test_core_topk_modes_bit_equal_to_jax_exact(regime, topk_impl):
    scores, boxes, config = _core_case(regime)
    sizes = np.asarray([[480, 640], [37, 50]], np.int32)
    core = jax.jit(functools.partial(
        jax_det._postprocess_reference_core, config=config,
        nms_impl="xla", topk_impl="exact", gather_impl="xla"))
    want = {k: np.asarray(v) for k, v in core(
        scores, boxes, original_sizes=jnp.asarray(sizes)).items()}
    got = port_det._postprocess_reference_core(
        torch.from_numpy(scores), torch.from_numpy(boxes),
        port_det.SSDConfig(**dataclasses.asdict(config)),
        torch.from_numpy(sizes), "auto", topk_impl, "auto")
    assert want["valid"].any()
    for key in ("boxes", "scores", "labels", "valid"):
        g = got[key].numpy()
        assert g.dtype == want[key].dtype, key
        np.testing.assert_array_equal(g, want[key], err_msg=key)


# -- dense rows: the kernel's radix select and its tie cut -------------------
#
# Rows of A = 1,250 (10 chunks, the last partial) with k = 96 and slots = 4:
# every case spreads its live entries over more than 4 chunks, so on the
# card each row takes the select branch of csrc/topk.cu.
_EDGE_A, _EDGE_K, _EDGE_SLOTS, _EDGE_THRESH = 1250, 96, 4, 1e-3


def _spread_cols(rng, n, a=_EDGE_A):
    """n >= 10 distinct columns, at least one in every 128-wide chunk."""
    chunks = -(-a // 128)
    first = np.minimum(np.arange(chunks) * 128 + rng.integers(0, 128, chunks),
                       a - 1)
    rest = rng.permutation(np.setdiff1d(np.arange(a), first))
    return np.concatenate([first, rest])[:n]


def _edge_topk_rows(case, p=6):
    """(P, A) float32 rows of one edge case, made from a seed."""
    rng = np.random.default_rng(40 + _TOPK_EDGES.index(case))
    k, a, t = _EDGE_K, _EDGE_A, _EDGE_THRESH
    rows = (rng.random((p, a)) * t * 0.9).astype(np.float32)
    for r in range(p):
        if case == "tie_at_kth":
            # 600 entries at the k-th value, 40 above it: 56 ties kept
            cols = _spread_cols(rng, 640 - r * 40)
            rows[r, cols[:40]] = 0.75 + rng.random(40).astype(np.float32) * 0.2
            rows[r, cols[40:]] = 0.5
        elif case in ("live_k_minus_1", "live_k", "live_k_plus_1"):
            n = k + {"live_k_minus_1": -1, "live_k": 0,
                     "live_k_plus_1": 1}[case]
            cols = _spread_cols(rng, n)
            vals = rng.random(n).astype(np.float32) * 0.9 + 2 * t
            vals[: n // 4] = vals[0]          # a run of ties
            rows[r, cols] = vals
        elif case == "one_exponent_bin":
            # every score in [0.5, 0.5 + 2**-8): sign, exponent and the top
            # mantissa bits alike, so the select works in its last passes
            ulps = rng.integers(0, 2**15, a).astype(np.uint32)
            rows[r] = (np.float32(0.5).view(np.uint32) + ulps).view(np.float32)
        elif case == "dense_uniform":
            rows[r] = rng.random(a).astype(np.float32)
    return rows


_TOPK_EDGES = ("tie_at_kth", "live_k_minus_1", "live_k", "live_k_plus_1",
               "one_exponent_bin", "dense_uniform")


def _order_key(x):
    """The kernel's uint32 key of each float32, as int64: order-preserving,
    -0.0 folded onto +0.0."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where((u & 0x80000000) != 0, (~u) & 0xFFFFFFFF,
                       u | 0x80000000)


def _radix_select_topk(scores, k, thresh):
    """Test-only model of csrc/topk.cu's select branch: radix select of the
    k-th largest key (8-bit digits from below the bits that the row's
    largest and smallest live key share, fewer in the last pass; all ties
    where those are equal), the tie cut in index order, and a sort of
    only the k kept entries; padding (-inf, 0)."""
    p, a = scores.shape
    dead = 0x007FFFFF                      # the key of -inf
    out_sc = torch.full((p, k), float("-inf"))
    out_idx = torch.zeros((p, k), dtype=torch.int32)
    for r in range(p):
        x = scores[r]
        live = x > thresh
        key = _order_key(x)
        n_live = int(live.sum())
        t_key, ties = dead, 0
        if n_live > k:
            hi, lo = int(key[live].max()), int(key[live].min())
            top = (hi ^ lo).bit_length() - 1       # -1: every key equal
            pmask = ~((2 << max(top, 0)) - 1) & 0xFFFFFFFF
            prefix, ties = hi & pmask, k
            low = top - 7
            while top >= 0:
                shift, bits = max(low, 0), min(8, 8 + low)
                part = live & ((key & pmask) == prefix)
                digit = (key[part] >> shift) & ((1 << bits) - 1)
                hist = torch.bincount(digit, minlength=256)
                at_or_above = hist.flip(0).cumsum(0).flip(0)
                d = int(torch.nonzero(at_or_above >= ties).max())
                ties -= int(at_or_above[d] - hist[d])
                prefix |= d << shift
                pmask |= ((1 << bits) - 1) << shift
                if shift == 0:
                    break
                low -= 8
            t_key = prefix if top >= 0 else hi
        gt = live & (key > t_key)
        eq = live & (key == t_key)
        eq_rank = torch.cumsum(eq.to(torch.int64), 0) - eq.to(torch.int64)
        cols = torch.nonzero(gt | (eq & (eq_rank < ties)))[:, 0]
        assert cols.numel() == min(n_live, k)
        vals = x[cols]
        order = torch.sort(vals, descending=True, stable=True)[1]
        out_sc[r, :cols.numel()] = vals[order]
        out_idx[r, :cols.numel()] = cols[order].to(torch.int32)
    return out_sc, out_idx


@pytest.mark.parametrize("case", _TOPK_EDGES)
def test_plain_topk_dense_edge_cases_match_jax(case):
    rows = _edge_topk_rows(case)
    sc, idx = _port(rows, _EDGE_K, _EDGE_THRESH, _EDGE_SLOTS)
    live_chunks = (np.pad(rows > _EDGE_THRESH, ((0, 0), (0, 30)))
                   .reshape(rows.shape[0], -1, 128).any(-1).sum(-1))
    assert (live_chunks > _EDGE_SLOTS).all()  # the select branch, every row
    _assert_contract(sc, idx, rows, _EDGE_K, _EDGE_THRESH, _EDGE_SLOTS)


@pytest.mark.parametrize("case",
                         _TOPK_EDGES + ("signed_zeros", "all_live_equal"))
def test_radix_select_model_bit_equal_to_plain(case):
    if case == "all_live_equal":
        # one value above the threshold, k of it and more: no pass, ties
        rows = np.full((6, _EDGE_A), 0.25, np.float32)
        rows[:, ::3] = 1e-4
        thresh = _EDGE_THRESH
    elif case == "signed_zeros":
        # below a negative threshold: -0.0 and +0.0 tie, negatives live
        rng = np.random.default_rng(47)
        rows = rng.choice(np.asarray([-0.0, 0.0, -0.5, 0.25, -1e-30, -2.0],
                                     np.float32), (6, _EDGE_A))
        thresh = -1.0
    else:
        rows, thresh = _edge_topk_rows(case), _EDGE_THRESH
    scores = torch.from_numpy(rows)
    want = port_topk.topk_sparse_plain(scores, _EDGE_K, thresh)
    got = _radix_select_topk(scores, _EDGE_K, thresh)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
