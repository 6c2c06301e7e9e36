"""Port vs JAX package: ssd_lite_mobilenet_v2, the legacy SSDLite +
MobileNetV2 (models/mobilenetv2.py, layers.InvertedResidualV2,
features.MobileNetV2ExtraBlocks, heads.SSDLiteHead with bn_eps 1e-5 and
last_plain), on the same weights.

The JAX detectors are built once per module from `jax.eval_shape` and
numpy draws (tests/torch_parity.py), carried into the port by
`load_jax_variables`. The forward runs at 96x96 (6 maps down to 1x1,
B = 1), training at 64x64 (B = 2), the anchors and the postprocess at
the model's own 320x320 (A = 3,234). Tolerances, with what was measured:

  * the 6 feature maps and the head outputs: max |port - JAX| within 1e-4
    of max |JAX| (fp32, another summation order; measured 1.6e-5);
  * anchors: bit-equal;
  * detections from the same scores and boxes (score_thresh 0.5,
    topk_candidates 400, detections_per_img 100), reference, sparse
    top-k and fused: bit-equal;
  * one SGD step (lr 0.05, momentum 0.9, wd 1e-4), the port's and the
    JAX step both in float64, as the flagship's are compared (BN
    statistics of 2-72 values per channel cannot agree in float32
    between two frameworks): loss terms rtol 1e-6 (measured 2.6e-8: both
    encode the regression targets in float32, whose `log` differs by an
    ulp), every parameter and BN running statistic atol 1e-5 + rtol 1e-5,
    the flagship's (largest difference 9.7e-7). One step: the 1e-8 it leaves moves the
    hard-negative cut of a second step on these random weights (0.09 in
    a BN scale at B = 3), which is the mining's nature, not the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models import builders as jax_builders
from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models import builders
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_CLASSES = 6
_SMALL = (96, 96)
# the train step's size: the smallest at which every map exists (4x4 ...
# 1x1); the JAX package's float64 step costs less to run there
_TRAIN = (64, 64)


@pytest.fixture(scope="module")
def ref():
    jd = jax_builders.ssd_lite_mobilenet_v2(num_classes=_CLASSES, size=_SMALL)
    variables = tp.jax_variables(jd.init)
    pd = builders.ssd_lite_mobilenet_v2(num_classes=_CLASSES, size=_SMALL,
                                        device="cpu")
    load_jax_variables(pd.model, variables)

    def features_and_head(v, x):
        feats = jd.model.apply(
            v, x, method=lambda m, x: m.extractor(x, train=False))
        return feats, jd.apply(v, x)

    return {"jd": jd, "pd": pd, "variables": variables,
            "forward": jax.jit(features_and_head)}


@pytest.fixture(scope="module")
def full():
    """The detectors at 320x320: anchors and postprocess only."""
    return (jax_builders.ssd_lite_mobilenet_v2(num_classes=_CLASSES),
            builders.ssd_lite_mobilenet_v2(num_classes=_CLASSES,
                                           device="cpu"))


def test_v2_features_and_heads_match_jax(ref):
    x = tp.images(1, _SMALL)
    feats_j, heads_j = ref["forward"](ref["variables"], x)
    with torch.no_grad():
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        feats_p = ref["pd"].model.extractor(nchw)
        heads_p = ref["pd"].model(torch.from_numpy(x))
    assert [f.shape[1] for f in feats_p] == [96, 1280, 512, 256, 256, 64]
    assert len(feats_p) == len(feats_j) == 6
    for i, (p, j) in enumerate(zip(feats_p, feats_j)):
        tp.assert_close_to_scale(p.permute(0, 2, 3, 1).numpy(), j, 1e-4,
                                 f"map {i}")
    for key in ("cls_logits", "bbox_regression"):
        tp.assert_close_to_scale(heads_p[key].numpy(), heads_j[key], 1e-4,
                                 key)


def test_v2_anchors_and_config_match_jax(full):
    jd, pd = full
    assert pd.anchors.shape == (3234, 4)
    np.testing.assert_array_equal(pd.anchors, jd.anchors)
    assert pd.config == tp.port_det.SSDConfig(
        **{f: getattr(jd.config, f) for f in jd.config.__dataclass_fields__})
    assert (pd.config.score_thresh, pd.config.topk_candidates,
            pd.config.detections_per_img) == (0.5, 400, 100)


@pytest.mark.parametrize("impl,topk_impl", [
    ("reference", "exact"), ("reference", "sparse"), ("fused", "exact")],
    ids=["reference", "sparse_topk", "fused"])
@pytest.mark.parametrize("regime", ["dense", "sparse"])
def test_v2_predict_matches_jax(full, regime, impl, topk_impl):
    jd, pd = full
    logits, deltas = tp.head_logits(5, 3234, _CLASSES, regime=regime)
    if regime == "dense":       # many anchors above 0.5: too many for a tier
        logits[..., 1:] *= 2.5
    sizes = np.asarray([[480, 640], [320, 320]], np.int32)
    want, branch = tp.assert_predict_matches_jax(jd, pd, logits, deltas,
                                                 sizes, impl, topk_impl)
    assert 0 < int(want["valid"].sum())
    if impl == "fused":
        assert branch == ("fallback" if regime == "dense" else "tier_1024")


@pytest.fixture(scope="module")
def train_ref():
    """One step of the JAX package's float64 train step at 64x64, B = 2."""
    with jax.enable_x64(True):
        jd = jax_builders.ssd_lite_mobilenet_v2(num_classes=4, size=_TRAIN,
                                                dtype=jnp.float64)
        variables = tp.jax_variables(jd.init)
        batch = tp.train_batch(1, _TRAIN, 4, b=2)
        metrics, after = tp.jax_steps(jd, variables, batch, 1, np.float64)
    return {"variables": variables, "batch": batch, "metrics": metrics,
            "after": after}


def test_v2_train_step_matches_jax(train_ref):
    pd = builders.ssd_lite_mobilenet_v2(num_classes=4, size=_TRAIN,
                                        device="cpu")
    load_jax_variables(pd.model, train_ref["variables"])
    pd.model.double()
    batch = {k: torch.from_numpy(v) for k, v in train_ref["batch"].items()}
    batch["images"] = batch["images"].double()
    rtol_loss, atol, rtol = 1e-6, 1e-5, 1e-5
    state = create_train_state(pd, make_optimizer(tp.LR, tp.MOMENTUM, tp.WD))
    step = make_train_step(pd)
    for want in train_ref["metrics"]:
        state, m = step(state, batch)
        for key in ("bbox_regression", "classification", "loss"):
            np.testing.assert_allclose(float(m[key]), want[key],
                                       rtol=rtol_loss, err_msg=key)
    tp.assert_state_close(pd.model, tp.jax_state(train_ref["after"]), atol,
                          rtol)
    start = tp.jax_state(train_ref["variables"])
    stats = [n for n in start if n.endswith(("running_mean", "running_var"))]
    assert stats and not any(torch.equal(
        pd.model.state_dict()[n].double(), start[n]) for n in stats)
