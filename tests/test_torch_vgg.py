"""Port vs JAX package: ssd300_vgg16 and ssd512_vgg16 (models/vgg.py,
heads.SSDHead, the VGG builders) at their own sizes, 300x300 and
512x512, B = 1, 6 classes, on the same weights.

The JAX detectors are built once per module from `jax.eval_shape` and
numpy draws (tests/torch_parity.py), carried into the port by
`load_jax_variables`. The caffe-style normalisation (std 1/255) feeds
the trunk values of +-128, so conv1_1's drawn kernel is divided by 255
to keep the activations O(1). Tolerances, with what was measured:

  * max pool (pool3's ceil mode, pool5's 3x3 s1 p1, the 2x2 pools, and
    3x3 s2 p1 in ceil mode) on sizes 5-76: bit-equal;
  * anchors: bit-equal (A = 8,732 and 24,732);
  * head outputs: max |port - JAX| within 1e-4 of max |JAX| (fp32 convs
    summed in another order; measured 3e-6 at 300 and 512);
  * detections from the same scores and boxes, in the reference
    postprocess, topk_impl="sparse" and impl="fused" (A > 4,096: the
    plain version of K3's long rows): bit-equal;
  * one fp32 SGD step of ssd300 (no BN, so no float64 is needed): loss
    terms rtol 1e-6 (measured 9e-8); each parameter within 1e-2 of the
    largest change the step made to it (measured 2.4e-3: a gradient is a
    sum over 90,000 pixels, which the two frameworks add in other
    orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models import builders as jax_builders
from demonet_tpu.models.vgg import max_pool_torch as jax_max_pool
from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models import builders
from demonet_tpu_torch.models.detection import preprocess
from demonet_tpu_torch.models.vgg import max_pool_torch
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_CLASSES = 6


def _variables(jd):
    v = tp.jax_variables(jd.init)
    v["params"]["extractor"]["conv1_1"]["kernel"] /= 255.0
    return v


@pytest.fixture(scope="module", params=["ssd300_vgg16", "ssd512_vgg16"])
def ref(request):
    name = request.param
    jd = getattr(jax_builders, name)(num_classes=_CLASSES)
    variables = _variables(jd)
    pd = builders.get_model(name, num_classes=_CLASSES, device="cpu")
    load_jax_variables(pd.model, variables)
    return {"name": name, "jd": jd, "pd": pd, "variables": variables}


@pytest.mark.parametrize("k,s,p,ceil", [
    (2, 2, 0, True), (2, 2, 0, False), (3, 1, 1, False), (3, 2, 1, True)])
def test_max_pool_matches_jax(k, s, p, ceil):
    """Every size 5-76 in one of the two axes (H = 5..40, W = 81 - H), odd
    and even."""
    rng = np.random.default_rng(k * 10 + s + p)
    for h in range(5, 41):
        x = rng.normal(size=(1, h, 81 - h, 2)).astype(np.float32)
        want = np.asarray(jax_max_pool(jnp.asarray(x), k, s, p, ceil))
        got = max_pool_torch(torch.from_numpy(x).permute(0, 3, 1, 2), k, s,
                             p, ceil).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape, (h, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=str(h))


def test_vgg_anchors_and_heads_match_jax(ref):
    jd, pd = ref["jd"], ref["pd"]
    want_a = {"ssd300_vgg16": 8732, "ssd512_vgg16": 24732}[ref["name"]]
    assert pd.anchors.shape == jd.anchors.shape == (want_a, 4)
    np.testing.assert_array_equal(pd.anchors, jd.anchors)
    assert pd.config == tp.port_det.SSDConfig(
        **{f: getattr(jd.config, f) for f in jd.config.__dataclass_fields__})
    x = preprocess(torch.from_numpy(tp.images(1, pd.config.size)),
                   pd.config).numpy()
    want = jax.jit(jd.apply)(ref["variables"], x)
    with torch.no_grad():
        got = pd.model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression"):
        tp.assert_close_to_scale(got[key].numpy(), want[key], 1e-4, key)


@pytest.mark.parametrize("impl,topk_impl", [
    ("reference", "exact"), ("reference", "sparse"), ("fused", "exact")],
    ids=["reference", "sparse_topk", "fused"])
@pytest.mark.parametrize("regime", ["dense", "sparse"])
def test_vgg_predict_matches_jax(ref, regime, impl, topk_impl):
    """Dense logits: every row live, so K3's long rows take the radix
    select and the fused path its fallback; sparse: a few live entries
    per image, the compact branch and a fused tier."""
    jd, pd = ref["jd"], ref["pd"]
    a = pd.anchors.shape[0]
    logits, deltas = tp.head_logits(3, a, _CLASSES, regime=regime)
    sizes = np.asarray([[480, 640], [300, 300]], np.int32)
    want, branch = tp.assert_predict_matches_jax(jd, pd, logits, deltas,
                                                 sizes, impl, topk_impl)
    n_valid = int(want["valid"].sum())
    assert 0 < n_valid
    if regime == "dense":
        assert n_valid == want["valid"].size        # 200 a frame, all live
    if impl == "fused":
        assert branch == ("fallback" if regime == "dense" else "tier_1024")


def test_ssd300_train_step_matches_jax():
    jd = jax_builders.ssd300_vgg16(num_classes=4)
    variables = _variables(jd)
    batch = tp.train_batch(1, jd.config.size, 4, b=2)
    want, after = tp.jax_steps(jd, variables, batch, 1, np.float32)
    pd = builders.ssd300_vgg16(num_classes=4, device="cpu")
    load_jax_variables(pd.model, variables)
    state = create_train_state(pd, make_optimizer(tp.LR, tp.MOMENTUM, tp.WD))
    state, m = make_train_step(pd)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("bbox_regression", "classification", "loss"):
        np.testing.assert_allclose(float(m[key]), want[0][key], rtol=1e-6,
                                   err_msg=key)
    start, end = tp.jax_state(variables), tp.jax_state(after)
    got = pd.model.state_dict()
    assert got.keys() == end.keys()
    for name, w in got.items():
        moved = float((end[name] - start[name]).abs().max())
        err = float((w.double() - end[name]).abs().max())
        assert moved > 0 and err <= 1e-2 * moved, (name, err, moved)
