"""The full-width gate: one train step of ssdlite320_mobilenet_v3_large at
320x320 and 91 classes from the trained weights
(bench_assets/ssdlite320_shapes_trained.npz), in the port and in the JAX
package (its jitted train step), on B = 2 frames whose gt is rows 0-1 of
bench_assets/val_gt_320.npz (5 boxes, labels 4-6), drawn as filled
rectangles on seeded noise. SGD at lr 0.02, momentum 0.9, weight decay
1e-4; both in float32.

Tolerances, with what was measured on these inputs:

  * loss terms: rtol 2e-6 (measured 4.7e-7);
  * the matching: bit-equal;
  * gradients (the port's, against the JAX step's recovered from its
    update, (p0 - p1) / lr - wd * p0, which is itself good to a few ulps
    of p0 over lr): per tensor, beyond that and an atol of 1e-5, within
    1e-1 of the tensor's largest |gradient|. Measured: 5.5e-2 at most
    (block 11's depthwise conv). With B = 2 the BN layers' batch
    statistics make float32 gradients noisy in both frameworks: the
    port's float32 step is within 1.7e-2 of its float64 step here, so
    most of the gap is the JAX float32 step's. The atol covers gradients
    that are 0 in exact arithmetic (a BN bias whose output the next
    layer's batch statistics normalise again), which come out of both as
    float32 noise of ~1e-6;
  * every parameter and BN running mean and variance after the step:
    atol 2e-3 + rtol 2e-3 (largest difference 7.0e-4).

(In float64 the two steps agree to 2.5e-9 in every parameter; the JAX
float64 step takes ~90 s to compile and run on an 8-core CPU, so it is
left out.)
"""

import os

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.engine.state import TrainState as JaxTrainState
from demonet_tpu.engine.state import make_optimizer as jax_optimizer
from demonet_tpu.engine.train import make_train_step as jax_train_step
from demonet_tpu.models import losses as jax_losses
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.models.losses import match_batch
from demonet_tpu_torch.utils.checkpoints import load_npz_variables
from demonet_tpu_torch.utils.weights import load_jax_variables, torch_name
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets")
_LR, _MOMENTUM, _WD = 0.02, 0.9, 1e-4
_RTOL_LOSS = 2e-6
_GRAD_SHARE, _GRAD_ATOL = 1e-1, 1e-5
_EPS32 = float(np.finfo(np.float32).eps)
_ATOL, _RTOL = 2e-3, 2e-3


def _gt_frames():
    """Rows 0-1 of the bench gt and frames with those boxes filled."""
    with np.load(os.path.join(_ASSETS, "val_gt_320.npz")) as z:
        boxes, labels, valid = z["boxes"][:2], z["labels"][:2], z["valid"][:2]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 60, (2, 320, 320, 3)).astype(np.uint8)
    for i in range(2):
        for box, ok in zip(boxes[i], valid[i]):
            if ok:
                x0, y0, x1, y1 = np.round(box).astype(int)
                img[i, y0:y1, x0:x1] = rng.integers(40, 256, 3)
    return {"images": img.astype(np.float32) / np.float32(255.0),
            "gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.array(leaf, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[torch_name("/".join(k.key for k in path))] = torch.from_numpy(arr)
    return out


@pytest.fixture(scope="module")
def full():
    variables = load_npz_variables(os.path.join(
        _ASSETS, "ssdlite320_shapes_trained.npz"))
    batch = _gt_frames()
    jd = jax_ssdlite(num_classes=91)
    state = JaxTrainState.create(
        apply_fn=jd.model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_optimizer(_LR, _MOMENTUM, _WD))
    state, metrics = jax_train_step(jd, donate=False)(state, batch)
    after = _flat({"params": state.params, "batch_stats": state.batch_stats})
    matched = np.asarray(jax.jit(jax_losses.match_batch)(
        np.asarray(jd.anchors), batch["gt_boxes"], batch["gt_valid"]))

    pd = port_ssdlite(num_classes=91, device="cpu")
    load_jax_variables(pd.model, variables)
    start = {n: p.detach().clone() for n, p in pd.model.named_parameters()}
    pstate = create_train_state(pd, make_optimizer(_LR, _MOMENTUM, _WD))
    pstate, pmetrics = make_train_step(pd)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"batch": batch, "metrics": {k: float(v)
                                        for k, v in metrics.items()},
            "after": after, "matched": matched, "pd": pd, "start": start,
            "port_metrics": {k: float(v) for k, v in pmetrics.items()}}


def test_full_width_loss_terms_and_matching(full):
    for key, want in full["metrics"].items():
        np.testing.assert_allclose(full["port_metrics"][key], want,
                                   rtol=_RTOL_LOSS, err_msg=key)
    b = full["batch"]
    pd = full["pd"]
    matched = match_batch(torch.as_tensor(pd.anchors),
                          torch.from_numpy(b["gt_boxes"]),
                          torch.from_numpy(b["gt_valid"]))
    np.testing.assert_array_equal(matched.numpy(), full["matched"])
    assert (full["matched"] >= 0).sum() >= 5


def test_full_width_gradients(full):
    pd, start, after = full["pd"], full["start"], full["after"]
    worst = 0.0
    for name, p in pd.model.named_parameters():
        want = (start[name] - after[name]) / _LR - _WD * start[name]
        # what the recovery itself can miss by: a few ulps of p over lr
        floor = 4 * _EPS32 * float(start[name].abs().max()) / _LR
        diff = float((p.grad - want).abs().max())
        share = max(diff - floor - _GRAD_ATOL, 0.0) / float(want.abs().max())
        assert share <= _GRAD_SHARE, (name, diff, floor)
        worst = max(worst, diff / float(want.abs().max()))
    assert 0.0 < worst


def test_full_width_parameters_and_bn_statistics(full):
    got = {n: v for n, v in full["pd"].model.state_dict().items()
           if not n.endswith("num_batches_tracked")}
    assert got.keys() == full["after"].keys()
    for name, value in got.items():
        torch.testing.assert_close(value, full["after"][name], atol=_ATOL,
                                   rtol=_RTOL, msg=lambda m: f"{name}: {m}")
