"""Port vs JAX package: the sparse top-k on rows longer than the CUDA
kernel's register launch holds (A > 4,096), at the VGG SSDs' anchor
counts, 8,732 (ssd300) and 24,732 (ssd512).

`topk_sparse` takes any row length: a CPU tensor runs the plain version,
a CUDA tensor the kernel's long-row launch (held bit-equal to the plain
version on the card by chip_smoke.py's `kernel_topk_long`). Here, on
every entry above the threshold, the port must equal the JAX
`topk_sparse` (the Pallas kernel in interpret mode, as the JAX package's
own tests run it; its dense fallback where a row overflows) and the numpy
oracle `topk_sparse_reference`; every other slot is the padding (-inf, 0).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.ops.topk_pallas import topk_sparse, topk_sparse_reference
from demonet_tpu_torch.ops import topk as port_topk

_K, _SLOTS, _THRESH = 300, 8, 1e-3
_P = 4


def _live(rng, n):
    return (_THRESH * 2 + rng.random(n) * 0.9).astype(np.float32)


def _rows(kind, a, seed):
    """(4, a) float32 rows of one kind, below the threshold elsewhere."""
    rng = np.random.default_rng(seed)
    x = (rng.random((_P, a)) * _THRESH * 0.9).astype(np.float32)
    n_chunks = -(-a // 128)
    tail0 = a // 128 * 128
    if kind == "within_slots":       # 1..8 live chunks, a few entries each
        for r in range(_P):
            for c in rng.choice(n_chunks, 2 * r + 1, replace=False):
                cols = c * 128 + rng.integers(0, min(128, a - c * 128), 5)
                x[r, cols] = _live(rng, 5)
    elif kind == "over_slots":       # more live chunks than slots, < k live
        for r in range(_P):
            chunks = rng.choice(n_chunks, 20 + 10 * r, replace=False)
            x[r, chunks * 128 + rng.integers(0, 28, len(chunks))] = _live(
                rng, len(chunks))
    elif kind == "dense":
        x = _live(rng, (_P, a))
    elif kind == "tie_at_kth":       # 40 above one value held by 600
        for r in range(_P):
            cols = rng.choice(a, 640, replace=False)
            x[r, cols[:40]] = 0.75 + rng.random(40).astype(np.float32) * 0.2
            x[r, cols[40:]] = 0.5
    elif kind == "k_plus_1":
        for r in range(_P):
            x[r, rng.choice(a, _K + 1, replace=False)] = _live(rng, _K + 1)
    elif kind == "tail":             # live scores past the last full chunk
        x[:, tail0:] = _live(rng, (_P, a - tail0))
        x[_P // 2:, ::61] = _live(rng, (_P - _P // 2, x[:, ::61].shape[1]))
    return x


@functools.lru_cache(maxsize=None)
def _jax_topk():
    return jax.jit(functools.partial(topk_sparse, k=_K, thresh=_THRESH,
                                     slots=_SLOTS, interpret=True))


@pytest.mark.parametrize("kind", ["empty", "within_slots", "over_slots",
                                  "dense", "tie_at_kth", "k_plus_1", "tail"])
@pytest.mark.parametrize("a", [8732, 24732])
def test_long_rows_live_entries_match_jax(a, kind):
    scores = _rows(kind, a, seed=a + len(kind))
    sc, idx = port_topk.topk_sparse(torch.from_numpy(scores), _K, _THRESH,
                                    _SLOTS)
    assert sc.shape == idx.shape == (_P, _K)
    assert sc.dtype == torch.float32 and idx.dtype == torch.int32
    sc, idx = sc.numpy(), idx.numpy()
    ref_sc, ref_idx = topk_sparse_reference(scores, _K, _THRESH)
    live = ref_sc > -np.inf
    assert (live.any() if kind != "empty" else not live.any())
    np.testing.assert_array_equal(sc > _THRESH, live)
    np.testing.assert_array_equal(sc[live], ref_sc[live])
    np.testing.assert_array_equal(idx[live], ref_idx[live])
    assert np.all(sc[~live] == -np.inf) and np.all(idx[~live] == 0)
    j_sc, j_idx = (np.asarray(v) for v in _jax_topk()(scores))
    np.testing.assert_array_equal(sc[live], j_sc[live])
    np.testing.assert_array_equal(idx[live], j_idx[live])


def test_long_rows_equal_the_plain_version_and_count_no_launch():
    """On the CPU the wrapper runs the plain version at any row length and
    counts no launch of either kernel shape."""
    scores = torch.from_numpy(_rows("tail", 8732, seed=1))
    before = (port_topk.topk_sparse.launches,
              port_topk.topk_sparse.long_launches)
    got = port_topk.topk_sparse(scores, _K, _THRESH, _SLOTS)
    want = port_topk.topk_sparse_plain(scores, _K, _THRESH)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (port_topk.topk_sparse.launches,
            port_topk.topk_sparse.long_launches) == before == (0, 0)
