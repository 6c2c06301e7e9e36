"""Port vs JAX package: the ssdlite320_mobilenet_v3_large slice at a small
size (64x64 input, 5 classes, A = 144 anchors), on the same weights.

The JAX detector is built and jitted once per module (the `ref` fixture);
its variables are drawn with numpy and carried into the port by
`load_jax_variables`, so both run the same numbers. Tolerances:

  * feature maps and head outputs: max-abs 1e-4 (fp32; the convs sum in
    another order);
  * preprocess: 1e-6 (the bilinear resize's weights are computed apart in
    each framework);
  * the postprocess core, given the same softmaxed scores and decoded
    boxes: bit-equal (it is gathers, sorts and comparisons only);
  * end to end: equal valid counts and labels, scores within 1e-5, boxes
    within 1e-3 px, after sorting each image's detections by
    (-score, label).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.models import detection as jax_det
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.engine.evaluate import make_predict_step
from demonet_tpu_torch.models import detection as port_det
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_SIZE = (64, 64)
_CLASSES = 5


def _draw_variables(shapes, rng):
    """Numpy values for every leaf of the abstract JAX variable tree, drawn
    like the JAX package's initializers (He fan-out in the trunk, lecun in
    the SE convs, normal(0, 0.03) in the extras and head) so activations
    stay O(1); BN scale/var in [0.5, 1.5], biases and means N(0, 0.1)."""
    def fill(tree, path):
        out = {}
        for k, leaf in tree.items():
            if not hasattr(leaf, "shape"):
                out[k] = fill(leaf, path + (k,))
                continue
            s = leaf.shape
            if k in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, s)
            elif k in ("mean", "bias"):
                v = rng.normal(0.0, 0.1, s)
            elif "se" in path:
                v = rng.normal(0.0, np.sqrt(1.0 / np.prod(s[:-1])), s)
            elif "trunk" in path:
                v = rng.normal(0.0, np.sqrt(2.0 / (s[-1] * s[0] * s[1])), s)
            else:
                v = rng.normal(0.0, 0.03, s)
            out[k] = v.astype(np.float32)
        return out
    return {c: fill(shapes[c], (c,)) for c in shapes}


@pytest.fixture(scope="module")
def ref():
    jd = jax_ssdlite(num_classes=_CLASSES, size=_SIZE)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
    variables = _draw_variables(shapes, np.random.default_rng(0))
    pd = port_ssdlite(num_classes=_CLASSES, size=_SIZE, device="cpu")
    load_jax_variables(pd.model, variables)

    def features_and_head(v, x):
        feats = jd.model.apply(
            v, x, method=lambda m, x: m.extractor(x, train=False))
        return feats, jd.apply(v, x)

    return {
        "jd": jd, "pd": pd, "variables": variables,
        "forward": jax.jit(features_and_head),
        "predict": jax.jit(jd.predict),
    }


def _images(seed, dtype=np.float32, size=_SIZE, b=2):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (b, *size, 3)).astype(np.uint8)
    return rng.random((b, *size, 3)).astype(np.float32)


def test_features_match_jax(ref):
    x = _images(1)
    jax_feats, _ = ref["forward"](ref["variables"], x)
    with torch.no_grad():
        port_feats = ref["pd"].model.extractor(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(port_feats) == len(jax_feats) == 6
    for j, p in zip(jax_feats, port_feats):
        p = p.permute(0, 2, 3, 1).numpy()
        assert p.shape == j.shape
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=1e-4)


def test_head_outputs_match_jax(ref):
    x = _images(2)
    _, jax_out = ref["forward"](ref["variables"], x)
    with torch.no_grad():
        port_out = ref["pd"].model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression"):
        j = np.asarray(jax_out[key])
        assert port_out[key].shape == j.shape
        np.testing.assert_allclose(port_out[key].numpy(), j, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype,size", [
    (np.uint8, _SIZE), (np.float32, _SIZE),
    (np.uint8, (50, 70)), (np.float32, (50, 70)),
])
def test_preprocess_matches_jax(ref, dtype, size):
    x = _images(3, dtype, size)
    want = np.asarray(jax_det.preprocess(jnp.asarray(x), ref["jd"].config))
    got = port_det.preprocess(torch.from_numpy(x), ref["pd"].config).numpy()
    assert got.shape == want.shape == (2, *_SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _core_case(regime):
    """(logits, deltas, anchors, config) for one regime of the core test."""
    rng = np.random.default_rng({"dense": 10, "sparse": 11, "tied": 12,
                                 "padded": 13}[regime])
    b = 2
    if regime == "padded":   # (C-1) * k = 2 * 50 < 300 detections: padding
        c, a, topk = 3, 100, 50
        xy = rng.random((a, 2)).astype(np.float32) * 64
        anchors = np.concatenate([xy - 8, xy + 8], -1).astype(np.float32)
    else:
        c, a, topk = _CLASSES, 144, 300
        anchors = port_ssdlite(num_classes=c, size=_SIZE,
                               device="cpu").anchors
    logits = rng.normal(0.0, 1.0, (b, a, c)).astype(np.float32)
    if regime == "sparse":   # background wins nearly everywhere
        logits[..., 0] += 12.0
        hot = rng.integers(0, a, 12)
        logits[0, hot, rng.integers(1, c, 12)] += 14.0
    deltas = rng.normal(0.0, 1.0, (b, a, 4)).astype(np.float32)
    config = jax_det.SSDConfig(
        size=_SIZE, num_classes=c, image_mean=(0.5,) * 3,
        image_std=(0.5,) * 3, score_thresh=0.001, nms_thresh=0.55,
        detections_per_img=300, topk_candidates=topk)
    return logits, deltas, anchors, config


@pytest.mark.parametrize("regime", ["dense", "sparse", "tied", "padded"])
def test_postprocess_core_bit_equal_given_jax_scores(regime):
    logits, deltas, anchors, config = _core_case(regime)
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    if regime == "tied":     # coarse scores: many exact ties to break
        scores = (np.round(scores * 40.0) / 40.0).astype(np.float32)
    from demonet_tpu.ops.boxes import clip_boxes_to_image, decode_boxes
    boxes = np.array(clip_boxes_to_image(
        decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)[None]),
        config.size))
    sizes = np.asarray([[480, 640], [37, 50]], np.int32)

    core = jax.jit(functools.partial(
        jax_det._postprocess_reference_core, config=config,
        nms_impl="xla", topk_impl="exact", gather_impl="xla"))
    want = {k: np.asarray(v) for k, v in core(
        scores, boxes, original_sizes=jnp.asarray(sizes)).items()}
    got = port_det._postprocess_reference_core(
        torch.from_numpy(scores), torch.from_numpy(boxes),
        port_det.SSDConfig(**dataclasses.asdict(config)),
        torch.from_numpy(sizes), "auto", "exact", "auto")
    assert want["valid"].any()
    if regime == "padded":
        assert not want["valid"][:, 100:].any()
    if regime == "sparse":
        fg = scores[..., 1:] > config.score_thresh
        assert fg.any(axis=1).mean() < 0.5   # most (image, class) rows empty
    for key in ("boxes", "scores", "labels", "valid"):
        g = got[key].numpy()
        assert g.dtype == want[key].dtype, key
        np.testing.assert_array_equal(g, want[key], err_msg=key)


def _sorted_dets(d, i):
    v = d["valid"][i]
    s, lab, box = d["scores"][i][v], d["labels"][i][v], d["boxes"][i][v]
    order = np.lexsort((lab, -s))
    return s[order], lab[order], box[order]


def _assert_detections_match(want, got):
    assert np.array_equal(want["valid"].sum(1), got["valid"].sum(1))
    for i in range(want["valid"].shape[0]):
        ws, wl, wb = _sorted_dets(want, i)
        gs, gl, gb = _sorted_dets(got, i)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)


@pytest.mark.parametrize("regime", ["dense", "sparse"])
def test_predict_matches_jax_end_to_end(ref, regime):
    variables, pd = ref["variables"], ref["pd"]
    if regime == "sparse":   # a peaked, background-heavy head, as trained
        variables = jax.tree_util.tree_map(np.copy, variables)
        for lvl in range(6):
            pw = variables["params"]["head"][f"cls_{lvl}"]["pw"]
            pw["kernel"] *= 20.0
            pw["bias"][0::_CLASSES] += 10.0
        pd = port_ssdlite(num_classes=_CLASSES, size=_SIZE, device="cpu")
        load_jax_variables(pd.model, variables)
    images = _images(4, np.uint8)
    sizes = np.asarray([[480, 640], [64, 64]], np.int32)
    want = {k: np.asarray(v) for k, v in ref["predict"](
        variables, images, jnp.asarray(sizes)).items()}
    got = {k: v.numpy() for k, v in pd.predict(
        torch.from_numpy(images), torch.from_numpy(sizes)).items()}
    for key in want:
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
    n_valid = want["valid"].sum()
    assert 0 < n_valid < want["valid"].size
    if regime == "sparse":
        assert n_valid < want["valid"].size // 4
    _assert_detections_match(want, got)


def test_predict_step_equals_detector_predict(ref):
    pd = ref["pd"]
    images = torch.from_numpy(_images(5, np.uint8))
    sizes = torch.tensor([[100, 200], [64, 64]], dtype=torch.int32)
    step = make_predict_step(pd)
    got = step(pd.model, images, sizes)
    want = pd.predict(images, sizes)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_unported_modes_raise(ref):
    """The JAX package's TPU kernel routes have no port: nms_impl 'pallas'
    and 'xla' name the Pallas kernel and the XLA loop."""
    pd = ref["pd"]
    images = torch.from_numpy(_images(6, np.uint8))
    for nms_impl in ("pallas", "xla"):
        with pytest.raises(ValueError, match="nms_impl"):
            make_predict_step(pd, nms_impl=nms_impl)(pd.model, images)


@pytest.mark.parametrize("kwargs,match", [
    ({"impl": "bogus"}, "impl"),
    ({"topk_impl": "bogus"}, "topk_impl"),
    ({"impl": "fused", "nms_impl": "bogus"}, "nms_impl"),
], ids=["impl", "topk_impl", "fused-nms_impl"])
def test_unknown_modes_raise(ref, kwargs, match):
    pd = ref["pd"]
    images = torch.from_numpy(_images(6, np.uint8))
    with pytest.raises(ValueError, match=match):
        make_predict_step(pd, **kwargs)(pd.model, images)


@pytest.mark.parametrize("kwargs", [
    {"impl": "fused"}, {"topk_impl": "sparse"},
    {"topk_impl": "sparse_pallas"}, {"topk_impl": "approx"},
], ids=["fused", "sparse", "sparse-kernel", "approx"])
def test_serving_modes_equal_reference_step(ref, kwargs):
    """Every serving mode of the predict step gives the reference's
    detections, bit for bit, on the same images."""
    pd = ref["pd"]
    images = torch.from_numpy(_images(7, np.uint8))
    sizes = torch.tensor([[100, 200], [64, 64]], dtype=torch.int32)
    want = make_predict_step(pd)(pd.model, images, sizes)
    got = make_predict_step(pd, **kwargs)(pd.model, images, sizes)
    assert want["valid"].any()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_full_tail_matches_jax():
    """reduced_tail=False (the JAX builder's option): MobileNetV3-Large's
    full tail, 960 channels at C5 where the reduced tail has 480; the head
    outputs match the JAX model's on the same weights."""
    jd = jax_ssdlite(num_classes=_CLASSES, size=_SIZE, reduced_tail=False)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
    variables = _draw_variables(shapes, np.random.default_rng(1))
    pd = port_ssdlite(num_classes=_CLASSES, size=_SIZE, reduced_tail=False,
                      device="cpu")
    assert pd.model.extractor.out_channels[:2] == [672, 960]
    load_jax_variables(pd.model, variables)
    x = _images(8)
    want = jax.jit(jd.apply)(variables, x)
    with torch.no_grad():
        got = pd.model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4)
