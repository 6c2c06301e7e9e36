"""Port vs JAX package: the 2-D (data, model) mesh
(`data_mesh(model_axis=M)`, parallel/mesh.py).

In the JAX package the "model" axis shards nothing: the parameters are
replicated and the batch is split over "data" alone, so the M devices of
one data shard compute the same step. The port puts rank r at data
index r // M and model index r % M, where `reshape(n // M, M)` puts
device r, and runs every collective of a step and of an evaluation over
the ranks of its model index.

The reference is tests/test_torch_dist_train.py's, built here again
while the port's ranks run: the JAX mesh step on this suite's 8 virtual
CPU devices, the flagship at 64x64 (4 classes) in
float64, its 8-row batch whose halves differ in positive counts and BN
means, two SGD steps at lr 0.02; its mesh is the 1-D one
(`data_mesh()`), which is the math a 2-D mesh stands for and which
agrees with the JAX unsharded step to 3e-14. The JAX package's own 2-D
mesh step (`data_mesh(model_axis=2)`) is no reference on this backend:
with jax 0.9.0 on XLA:CPU the gradient of a depthwise conv whose batch
is sharded over "data" comes out summed over "model" too, M times too
large (a jitted grad of one depthwise conv, relative error 1.0 on a
4 x 2 mesh and 3.0 on 2 x 4, 1.7e-7 on 8 x 1), so after one step its
depthwise kernels sit 0.15 from its own unsharded step's while the loss
agrees to 1e-15. (tests/test_engine.py's 2-D case takes its step during
the LR warmup, where that error is below its 5e-4 bound.)

The port runs 4 gloo ranks as a 2 x 2 mesh (tests/torch_dist_worker.py),
each data shard's two replicas on its 4 rows. Tolerances are
tests/test_torch_dist_train.py's: loss terms rtol 1e-6 after each step,
every parameter and BN statistic atol 1e-5; the replicas end each step
bit-equal, and so does every rank. The ranks' `evaluate(mesh=)` of the
trained flagship over 5 synthetic frames gives every rank, at 2 x 2, the
merged set and COCO summary of the 1-D mesh of the same 4 ranks,
exactly.
"""

import os

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
from demonet_tpu.parallel.mesh import data_mesh as jax_data_mesh
from demonet_tpu.parallel.mesh import replicate, shard_batch
from demonet_tpu_torch.parallel import data_mesh
from demonet_tpu_torch.parallel.mesh import mesh_coordinates
from tests import torch_dist_worker as w
from tests.test_torch_dist_train import (
    _ATOL,
    _KEYS,
    _RTOL,
    _RTOL_LOSS,
    _assert_state_close,
    _batch,
)
from tests.test_torch_train_step import _draw_variables
from tests.torch_parity import jax_state, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets", "ssdlite320_shapes_trained.npz")
_WORLD, _MODEL_AXIS = 4, 2
_FRAMES, _EVAL_BATCH = 5, 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4 gloo ranks on a 2 x 2 mesh (places, groups, two mesh steps,
    the sharded evaluations), run while XLA compiles the JAX reference:
    the JAX 1-D mesh step's metrics and variables after each of two
    steps from the same variables, on the same batch."""
    with jax.enable_x64(True):
        jd = jax_ssdlite(num_classes=w._CLASSES, size=w._SIZE,
                         dtype=jnp.float64)
        variables = _draw_variables(
            jax.eval_shape(jd.init, jax.random.PRNGKey(0)),
            np.random.default_rng(0))
        batch = _batch()
        started = w.start(w.mesh2d_steps_and_evaluate, _WORLD,
                          tmp_path_factory.mktemp("mesh2d"), _MODEL_AXIS,
                          variables, batch, _NPZ, _FRAMES, _EVAL_BATCH)
        v64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                     variables)
        mesh = jax_data_mesh()
        state = jax.device_put(JaxTrainState.create(
            apply_fn=jd.model.apply, params=v64["params"],
            batch_stats=v64["batch_stats"],
            tx=jax_optimizer(w._LR, w._MOMENTUM, w._WD)), replicate(mesh))
        step = jax_train_step(jd, mesh=mesh, donate=False)
        sharded = shard_batch(dict(batch, images=batch["images"].astype(
            np.float64)), mesh)
        metrics, after = [], []
        for _ in range(2):
            state, m = step(state, sharded)
            metrics.append({k: float(v) for k, v in m.items()})
            after.append(jax_state(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats})))
    return {"metrics": metrics, "after": after, "ranks": w.join(started)}


@pytest.fixture(scope="module")
def ranks(run):
    return run["ranks"]


@pytest.fixture(scope="module")
def jax_ref(run):
    return run


@pytest.mark.parametrize("model_axis", [1, 2, 4, 8])
def test_mesh_placement_matches_jax(model_axis):
    """Rank r sits where JAX's data_mesh puts device r."""
    devices = jax.devices()
    mesh = jax_data_mesh(devices, model_axis=model_axis)
    for r, d in enumerate(devices):
        (i, j), = zip(*np.nonzero(mesh.devices == d))
        assert mesh_coordinates(r, len(devices), model_axis) == (i, j)


@pytest.mark.parametrize("n,model_axis", [(1, 2), (3, 2), (8, 3)])
def test_mesh_refuses_an_indivisible_world_as_jax_does(n, model_axis):
    with pytest.raises(ValueError) as want:
        jax_data_mesh(jax.devices()[:n], model_axis=model_axis)
    with pytest.raises(ValueError) as got:
        mesh_coordinates(0, n, model_axis)
    assert str(got.value) == str(want.value)
    if n == 1:    # this process alone: a world of one
        with pytest.raises(ValueError, match=str(want.value)):
            data_mesh([torch.device("cpu")], model_axis=model_axis)


def test_ranks_sit_at_the_jax_places_with_their_data_groups(ranks):
    for r, res in enumerate(ranks):
        assert res["place"] == (r // _MODEL_AXIS, r % _MODEL_AXIS,
                                _WORLD // _MODEL_AXIS)
        assert res["group"] == list(range(r % _MODEL_AXIS, _WORLD,
                                          _MODEL_AXIS))


def test_2x2_mesh_steps_match_jax_mesh_step(ranks, jax_ref):
    for r in ranks:
        for step in (0, 1):
            want = jax_ref["metrics"][step]
            for key in _KEYS:
                np.testing.assert_allclose(
                    r["steps"]["metrics"][step][key], want[key],
                    rtol=_RTOL_LOSS, err_msg=f"step {step + 1} {key}")
            _assert_state_close(r["steps"]["states"][step],
                                jax_ref["after"][step], _ATOL, _RTOL)


def test_2x2_mesh_replicas_end_each_step_bit_equal(ranks):
    first = ranks[0]["steps"]
    for r in ranks[1:]:
        assert r["steps"]["metrics"] == first["metrics"]
        for step in (0, 1):
            for name, value in r["steps"]["states"][step].items():
                assert torch.equal(value, first["states"][step][name]), name


def test_2x2_mesh_evaluate_equals_1d_mesh_evaluate(ranks):
    for r in ranks:
        two_d, one_d = r["evaluate"][_MODEL_AXIS], r["evaluate"][1]
        assert two_d["merged"] == one_d["merged"] == list(range(_FRAMES))
        np.testing.assert_array_equal(two_d["stats"], one_d["stats"])
        assert np.isfinite(two_d["stats"]).all() and two_d["stats"][1] > 0
    # the replicas of a data shard fed their evaluators the same frames
    for d in range(_WORLD // _MODEL_AXIS):
        seen = [ranks[d * _MODEL_AXIS + m]["evaluate"][_MODEL_AXIS]["seen"]
                for m in range(_MODEL_AXIS)]
        assert all(s == seen[0] for s in seen) and seen[0]
