"""Port vs JAX package: the data-parallel train step
(`make_train_step(mesh=...)`, `parallel/mesh.py`, the global BN
statistics of `layers.global_batch_stats`, the loss's global N).

The reference is the JAX package's mesh step (`make_train_step(det,
mesh=data_mesh())`) on this suite's 8 virtual CPU devices, over a global
batch of 8 rows of ssdlite320_mobilenet_v3_large at 64x64 (4 classes),
in float64 (the builder's dtype=float64 under jax.enable_x64; see
tests/test_torch_train_step.py for why float64), two steps of SGD at the
recipe's lr 0.02 from the same variables, drawn as that file's no-mesh
gate draws them. (At that file's lr 0.05 this 8-row batch makes step 2
ill-conditioned in either framework alone: a 2.8e-8 change of the
parameters after step 1, the two frameworks' distance there, moves the
port's step-2 logits by 1.8e-5 and its step-2 weights by up to 7.6e-3,
while at the same parameters the two gradients agree to 1e-6 of their
scale; at 0.02 four batches of this kind stayed within 3.8e-6.) The port runs two gloo ranks (spawned,
tests/torch_dist_worker.py), each with 4 of the 8 rows. The halves of the
batch differ in their positive counts and in their BN batch means, so a
per-rank N or per-rank BN statistics would fail the comparison (the JAX
package's own test measures that kind of fault at 8x / 12.5 %,
tests/test_engine.py:184-192).

Tolerances (the no-mesh gate measured 1.2e-7 and 3.7e-6): loss terms
rtol 1e-6 after each step; every parameter and BN statistic atol 1e-5. Bit for bit: the two ranks' states; a group of one
rank against the step without a mesh; steps_per_call=2 and remat under
the mesh against the plain mesh step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.engine.state import TrainState as JaxTrainState
from demonet_tpu.engine.state import make_optimizer as jax_optimizer
from demonet_tpu.engine.train import make_train_step as jax_train_step
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu.parallel.mesh import data_mesh, replicate, shard_batch
from demonet_tpu_torch.models.losses import match_batch
from tests import torch_dist_worker as w
from tests.test_torch_train_step import _draw_variables
from tests.torch_parity import jax_state, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_RTOL_LOSS, _ATOL, _RTOL = 1e-6, 1e-5, 0.0
_KEYS = ("bbox_regression", "classification", "loss")


def _batch():
    """8 frames of rectangles on noise: rows 0-3 dark with one box each,
    rows 4-7 bright with three boxes each."""
    rng = np.random.default_rng(1)
    b, g = 8, 3
    images = np.zeros((b, *w._SIZE, 3), np.float32)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        bright = i >= 4
        images[i] = rng.random((*w._SIZE, 3)) * 0.2 + (0.6 if bright else 0.0)
        for j in range(3 if bright else 1):
            x0, y0 = rng.integers(0, 36, 2)
            bw, bh = rng.integers(10, 28, 2)
            x1, y1 = min(x0 + bw, 64), min(y0 + bh, 64)
            images[i, y0:y1, x0:x1] = rng.random(3) * 0.3
            boxes[i, j] = [x0, y0, x1, y1]
            labels[i, j] = rng.integers(1, w._CLASSES)
            valid[i, j] = True
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels,
            "gt_valid": valid}


@pytest.fixture(scope="module")
def jax_ref():
    """Variables, the batch, and the JAX mesh step's two steps on it: each
    step's metrics and the variables after each step."""
    with jax.enable_x64(True):
        jd = jax_ssdlite(num_classes=w._CLASSES, size=w._SIZE,
                         dtype=jnp.float64)
        variables = _draw_variables(
            jax.eval_shape(jd.init, jax.random.PRNGKey(0)),
            np.random.default_rng(0))
        v64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                     variables)
        mesh = data_mesh()
        state = jax.device_put(JaxTrainState.create(
            apply_fn=jd.model.apply, params=v64["params"],
            batch_stats=v64["batch_stats"],
            tx=jax_optimizer(w._LR, w._MOMENTUM, w._WD)), replicate(mesh))
        step = jax_train_step(jd, mesh=mesh, donate=False)
        batch = _batch()
        sharded = shard_batch(dict(batch, images=batch["images"].astype(
            np.float64)), mesh)
        assert len(sharded["images"].sharding.device_set) == 8
        metrics, after = [], []
        for _ in range(2):
            state, m = step(state, sharded)
            metrics.append({k: float(v) for k, v in m.items()})
            after.append(jax_state(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats})))
    return {"variables": variables, "batch": batch, "metrics": metrics,
            "after": after, "anchors": np.asarray(jd.anchors)}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    """The port's two gloo ranks: two mesh steps each, plain, with
    steps_per_call=2 and with remat."""
    return w.spawn(w.mesh_train_steps, 2, tmp_path_factory.mktemp("ranks"),
                   jax_ref["variables"], jax_ref["batch"])


def _assert_state_close(got, want, atol, rtol):
    assert got.keys() == want.keys()
    for name, value in got.items():
        torch.testing.assert_close(value.double(), want[name], atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


def test_batch_halves_differ_in_positives_and_bn_means(jax_ref):
    """What makes the comparison sharp: the two ranks' rows give
    different positive counts, and the first BN's per-channel batch means
    over each half lie more than 1e-2 apart."""
    b = jax_ref["batch"]
    matched = match_batch(torch.from_numpy(jax_ref["anchors"]),
                          torch.from_numpy(b["gt_boxes"]),
                          torch.from_numpy(b["gt_valid"]))
    positives = [int((matched[h * 4:(h + 1) * 4] >= 0).sum()) for h in (0, 1)]
    assert positives[0] != positives[1] and min(positives) > 0
    pd = w.port_detector(jax_ref["variables"])
    seen = []
    bn = pd.model.extractor.trunk.stem.bn
    hook = bn.register_forward_hook(lambda m, i, o: seen.append(i[0]))
    with torch.no_grad():
        pd.model.eval()((torch.from_numpy(b["images"]).double() - 0.5) / 0.5)
    hook.remove()
    x = seen[0]
    gap = (x[:4].mean((0, 2, 3)) - x[4:].mean((0, 2, 3))).abs().max()
    assert float(gap) > 1e-2


def test_two_rank_mesh_step_matches_jax_mesh_step(ranks, jax_ref):
    for r in ranks:
        plain = r["plain"]
        for step in (0, 1):
            want = jax_ref["metrics"][step]
            for key in _KEYS:
                np.testing.assert_allclose(plain["metrics"][step][key],
                                           want[key], rtol=_RTOL_LOSS,
                                           err_msg=f"step {step + 1} {key}")
            _assert_state_close(plain["states"][step], jax_ref["after"][step],
                                _ATOL, _RTOL)


def test_ranks_hold_bit_equal_states(ranks):
    a, b = ranks
    assert a["plain"]["metrics"] == b["plain"]["metrics"]
    for step in (0, 1):
        for name, value in a["plain"]["states"][step].items():
            assert torch.equal(value, b["plain"]["states"][step][name]), name


@pytest.mark.parametrize("variant", ["steps_per_call", "remat"])
def test_mesh_variant_equals_plain_mesh_step(ranks, variant):
    for r in ranks:
        assert r[variant]["metrics"] == r["plain"]["metrics"]
        for name, value in r[variant]["states"][1].items():
            assert torch.equal(value, r["plain"]["states"][1][name]), name


def test_one_rank_mesh_step_equals_plain_step(jax_ref, tmp_path):
    (r,) = w.spawn(w.one_rank_steps, 1, tmp_path, jax_ref["variables"],
                   jax_ref["batch"])
    assert r["mesh"]["metrics"] == r["plain"]["metrics"]
    for step in (0, 1):
        for name, value in r["mesh"]["states"][step].items():
            assert torch.equal(value, r["plain"]["states"][step][name]), name
