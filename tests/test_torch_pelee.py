"""Port vs JAX package: pelee304, Pelee-SSD (models/peleenet.py,
heads.Pelee1x1Head, builders.pelee304), on the same weights.

The JAX detectors are built once per module from `jax.eval_shape` and
numpy draws (tests/torch_parity.py), carried into the port by
`load_jax_variables`. Forward and training run at 257x257, the smallest
size whose extras still reach a 1x1 map; being odd, it pads every
ceil-mode pool (stem 129 -> 65, transitions 65 -> 33 -> 17 -> 9). The
anchors, grids and postprocess run at the model's own 304x304, the only
size with the paper's steps (A = 2,976). Tolerances, with what was
measured:

  * average pool in ceil mode against the JAX function on sizes 5-76:
    the same shapes, values within 1e-6 (inputs N(0, 1); XLA adds a
    window's values in its own order, which changes with the padding, so
    the two differ by an ulp or two);
  * the 5 feature maps and the head outputs: max |port - JAX| within
    1e-4 of max |JAX| (measured 1.2e-6);
  * anchors: bit-equal; grids (19, 10, 5, 3, 1) at 304;
  * detections from the same scores and boxes (score_thresh 0.5,
    topk_candidates 400, detections_per_img 100), reference, sparse top-k
    and fused: bit-equal;
  * one SGD step in float64 against the JAX step in float64 (BN
    everywhere): loss terms rtol 1e-6 (measured 6.4e-9), every parameter
    and BN running statistic atol 1e-6 + rtol 1e-5 (largest difference
    4.5e-8). One step, as for ssd_lite_mobilenet_v2
    (tests/test_torch_mobilenetv2.py says why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models import builders as jax_builders
from demonet_tpu.models.peleenet import avg_pool_torch as jax_avg_pool
from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models import builders
from demonet_tpu_torch.models.builders import feature_grid_sizes
from demonet_tpu_torch.models.peleenet import avg_pool_torch
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_CLASSES = 6
_SMALL = (257, 257)


@pytest.fixture(scope="module")
def ref():
    jd = jax_builders.pelee304(num_classes=_CLASSES, size=_SMALL)
    variables = tp.jax_variables(jd.init)
    pd = builders.pelee304(num_classes=_CLASSES, size=_SMALL, device="cpu")
    load_jax_variables(pd.model, variables)

    def features_and_head(v, x):
        feats = jd.model.apply(
            v, x, method=lambda m, x: m.extractor(x, train=False))
        return feats, jd.apply(v, x)

    return {"jd": jd, "pd": pd, "variables": variables,
            "forward": jax.jit(features_and_head)}


@pytest.fixture(scope="module")
def full():
    """The detectors at 304x304: anchors, grids and postprocess only."""
    return (jax_builders.pelee304(num_classes=_CLASSES),
            builders.pelee304(num_classes=_CLASSES, device="cpu"))


@pytest.mark.parametrize("ceil", [True, False])
def test_avg_pool_matches_jax(ceil):
    """2x2 stride 2 (the transitions' pool) on every size 5-76 in one of
    the two axes (H = 5..40, W = 81 - H), odd and even."""
    pool = jax.jit(jax_avg_pool, static_argnums=(1, 2, 3))
    rng = np.random.default_rng(int(ceil))
    for h in range(5, 41):
        x = rng.normal(size=(1, h, 81 - h, 2)).astype(np.float32)
        want = np.asarray(pool(jnp.asarray(x), 2, 2, ceil))
        got = avg_pool_torch(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 2,
                             ceil).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape, (h, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=str(h))


def test_pelee_features_and_heads_match_jax(ref):
    x = tp.images(1, _SMALL)
    feats_j, heads_j = ref["forward"](ref["variables"], x)
    with torch.no_grad():
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        feats_p = ref["pd"].model.extractor(nchw)
        heads_p = ref["pd"].model(torch.from_numpy(x))
    assert len(feats_p) == len(feats_j) == 5
    for i, (p, j) in enumerate(zip(feats_p, feats_j)):
        tp.assert_close_to_scale(p.permute(0, 2, 3, 1).numpy(), j, 1e-4,
                                 f"map {i}")
    for key in ("cls_logits", "bbox_regression"):
        tp.assert_close_to_scale(heads_p[key].numpy(), heads_j[key], 1e-4,
                                 key)


def test_pelee_grids_anchors_and_config_match_jax(full):
    jd, pd = full
    grids = feature_grid_sizes(pd.model.extractor, (304, 304))
    assert grids == [(19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    assert pd.anchors.shape == (2976, 4)
    np.testing.assert_array_equal(pd.anchors, jd.anchors)
    assert pd.config == tp.port_det.SSDConfig(
        **{f: getattr(jd.config, f) for f in jd.config.__dataclass_fields__})


@pytest.mark.parametrize("impl,topk_impl", [
    ("reference", "exact"), ("reference", "sparse"), ("fused", "exact")],
    ids=["reference", "sparse_topk", "fused"])
@pytest.mark.parametrize("regime", ["dense", "sparse"])
def test_pelee_predict_matches_jax(full, regime, impl, topk_impl):
    jd, pd = full
    logits, deltas = tp.head_logits(7, 2976, _CLASSES, regime=regime)
    if regime == "dense":       # many anchors above 0.5: too many for a tier
        logits[..., 1:] *= 2.5
    sizes = np.asarray([[480, 640], [304, 304]], np.int32)
    want, branch = tp.assert_predict_matches_jax(jd, pd, logits, deltas,
                                                 sizes, impl, topk_impl)
    assert 0 < int(want["valid"].sum())
    if impl == "fused":
        assert branch == ("fallback" if regime == "dense" else "tier_1024")


def test_pelee_train_step_matches_jax():
    with jax.enable_x64(True):
        jd = jax_builders.pelee304(num_classes=4, size=_SMALL,
                                   dtype=jnp.float64)
        variables = tp.jax_variables(jd.init)
        batch = tp.train_batch(1, _SMALL, 4, b=2)
        metrics, after = tp.jax_steps(jd, variables, batch, 1, np.float64)
    pd = builders.pelee304(num_classes=4, size=_SMALL, device="cpu")
    load_jax_variables(pd.model, variables)
    pd.model.double()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b["images"] = b["images"].double()
    state = create_train_state(pd, make_optimizer(tp.LR, tp.MOMENTUM, tp.WD))
    step = make_train_step(pd)
    for want in metrics:
        state, m = step(state, b)
        for key in ("bbox_regression", "classification", "loss"):
            np.testing.assert_allclose(float(m[key]), want[key], rtol=1e-6,
                                       err_msg=key)
    tp.assert_state_close(pd.model, tp.jax_state(after), 1e-6, 1e-5)
    start = tp.jax_state(variables)
    stats = [n for n in start if n.endswith(("running_mean", "running_var"))]
    assert stats and not any(torch.equal(
        pd.model.state_dict()[n].double(), start[n]) for n in stats)
