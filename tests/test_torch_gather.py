"""Port vs JAX package: batched row gather (demonet_tpu_torch.ops.gather).

The plain version, which the kernel wrapper runs on CPU tensors, must be
bit-equal to `jnp.take_along_axis`, adversarial values included. The CUDA
kernel itself (csrc/gather.cu) is held to the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu_torch.ops import gather as port_gather


def _table_and_idx(b, n, r, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.random((b, n, 4)).astype(np.float32) * 640.0 - 320.0
    vals[0, 0] = [1e30, -1e-30, 3.14159274, 2.0 ** -20]
    vals[0, n - 1] = [-0.0, 1e-45, -1e30, np.float32(1e-38) / 3]  # denormals
    idx = rng.integers(0, n, (b, r)).astype(np.int32)
    idx[0, :3] = [0, n - 1, n - 1]
    return vals, idx


def _want(table, idx):
    return np.asarray(jnp.take_along_axis(jnp.asarray(table),
                                          jnp.asarray(idx)[..., None], axis=1))


@pytest.mark.parametrize("b,n,r", [
    (2, 3234, 700),     # candidate-gather shape class
    (2, 27000, 300),    # final-gather shape class
    (1, 129, 5),
])
@pytest.mark.parametrize("coord_major", [False, True])
def test_plain_gather_bit_equal_to_jax(b, n, r, coord_major):
    table, idx = _table_and_idx(b, n, r)
    got = port_gather.gather_rows_batch(torch.from_numpy(table),
                                        torch.from_numpy(idx),
                                        coord_major=coord_major).numpy()
    want = _want(table, idx)
    if coord_major:
        want = np.transpose(want, (0, 2, 1))
    assert got.shape == want.shape
    # compare bits, so -0.0 against 0.0 and NaN payloads would show
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    table, idx = _table_and_idx(2, 300, 50, seed=1)
    before = port_gather.gather_rows_batch.launches
    got = port_gather.gather_rows_batch(torch.from_numpy(table),
                                        torch.from_numpy(idx))
    want = port_gather.gather_rows_batch_plain(torch.from_numpy(table),
                                               torch.from_numpy(idx))
    assert torch.equal(got, want)
    assert port_gather.gather_rows_batch.launches == before == 0


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros(2, 5, 3), torch.zeros(2, 4, dtype=torch.int32), ValueError),
    (torch.zeros(2, 5, 4), torch.zeros(3, 4, dtype=torch.int32), ValueError),
    (torch.zeros(2, 5, 4), torch.zeros(2, 4, dtype=torch.int64), TypeError),
    (torch.zeros(2, 5, 4, device="meta"),
     torch.zeros(2, 4, dtype=torch.int32, device="meta"), ValueError),
])
def test_wrapper_rejects_bad_inputs(table, idx, err):
    with pytest.raises(err):
        port_gather.gather_rows_batch(table, idx)
