"""Port vs JAX package: the `torch.export` artifact
(demonet_tpu_torch/export/program.py against demonet_tpu/export/stablehlo.py).

Every artifact here is saved to disk and loaded back before it runs. On
the CPU its kernels' custom ops run their plain versions, so:

  * the reloaded artifact is bit-equal to the port's eager predict step
    (`make_predict_step`) in the reference and fused modes, float32 and
    bf16; the fused program's `torch.cond` is held on each branch (tier
    1,024, tier 2,048 and the reference fallback), read from the shape of
    the NMS problem its K1 node ran on;
  * its raw heads are within the heads tolerance of
    tests/test_torch_model.py (max-abs 1e-4) of the JAX
    `export_detector(..., with_postprocess=False)` artifact's, on the
    same weights (`load_jax_variables`);
  * its detections match the JAX artifact's on tests/test_export.py's
    inputs as tests/test_torch_model.py matches detections: equal valid
    counts and labels, scores within 1e-5, boxes within 1e-3 px, each
    image's detections sorted by (-score, label).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.export.stablehlo import export_detector as jax_export
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.engine.evaluate import make_predict_step
from demonet_tpu_torch.export import (
    export_detector,
    load_exported,
    save_exported,
)
from demonet_tpu_torch.models import detection as port_det
from demonet_tpu_torch.models.builders import (
    mobilenet_v3_small,
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.ops import nms as port_nms
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import draw_variables, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_SIZE = (64, 64)


@pytest.fixture(scope="module")
def ref():
    """The 5-class detector of tests/test_export.py at 64x64, its JAX
    variables drawn with numpy and carried into the port."""
    jd = jax_ssdlite(num_classes=5, size=_SIZE)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
    variables = draw_variables(shapes, np.random.default_rng(0))
    pd = port_ssdlite(num_classes=5, size=_SIZE, device="cpu")
    load_jax_variables(pd.model, variables)
    return {"jd": jd, "pd": pd, "variables": variables}


def _reloaded(detector, tmp_path, **kwargs):
    path = str(tmp_path / "model.pt2")
    save_exported(export_detector(detector, **kwargs), path)
    return load_exported(path).module()


def _export_inputs(b):
    """tests/test_export.py's images: uniform [0, 1) from PRNGKey(1)."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(1),
                                       (b, *_SIZE, 3)))


def _sorted_dets(d, i):
    v = d["valid"][i]
    s, lab, box = d["scores"][i][v], d["labels"][i][v], d["boxes"][i][v]
    order = np.lexsort((lab, -s))
    return s[order], lab[order], box[order]


def test_raw_heads_match_jax_export(ref, tmp_path):
    x = _export_inputs(1)
    want = jax_export(ref["jd"], ref["variables"], batch_size=1,
                      with_postprocess=False, platforms=("cpu",)).call(x)
    program = _reloaded(ref["pd"], tmp_path, with_postprocess=False)
    with torch.no_grad():
        got = program(torch.from_numpy(x))
    assert sorted(got) == ["bbox_regression", "cls_logits"]
    for key in got:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4)


def test_artifact_matches_jax_artifact(ref, tmp_path):
    x = _export_inputs(2)
    want = {k: np.asarray(v) for k, v in jax_export(
        ref["jd"], ref["variables"], batch_size=2,
        platforms=("cpu",)).call(x).items()}
    program = _reloaded(ref["pd"], tmp_path, batch_size=2)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in program(torch.from_numpy(x)).items()}
    for key in want:
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
    assert np.array_equal(want["valid"].sum(1), got["valid"].sum(1))
    assert want["valid"].any()
    for i in range(2):
        ws, wl, wb = _sorted_dets(want, i)
        gs, gl, gb = _sorted_dets(got, i)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)


def test_all_zero_input_artifact(ref, tmp_path):
    """tests/test_export.py's no-detections case: an all-zero frame gives
    well-formed padded detections, equal to the eager step's."""
    pd = ref["pd"]
    x = torch.zeros((1, *_SIZE, 3))
    program = _reloaded(pd, tmp_path)
    with torch.no_grad():
        got = program(x)
    want = make_predict_step(pd)(pd.model, x)
    d = pd.config.detections_per_img
    assert got["boxes"].shape == (1, d, 4)
    assert bool(torch.isfinite(got["scores"]).all())
    for key in want:
        assert torch.equal(got[key], want[key]), key


# -- the port's own artifact against its eager step, every fused branch ------

_CLASSES = 21   # (C - 1) * A = 2,880 > 2,048 at 64x64: every branch reachable


@pytest.fixture(scope="module")
def voc_detector():
    """A 21-class detector at 64x64 with its class head spread (seeded
    noise on the head's weights), so that thresholds can put a batch in
    each fused tier; and a batch of 2 frames."""
    det = port_ssdlite(num_classes=_CLASSES, size=_SIZE, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in det.model.head.named_parameters():
            if "cls" in name:
                p.add_(0.5 * torch.randn(p.shape, generator=gen))
    x = torch.from_numpy(
        np.random.default_rng(7).random((2, *_SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        logits = det.model(port_det.preprocess(x, det.config))["cls_logits"]
    fg = torch.softmax(logits, -1)[..., 1:].reshape(2, -1)
    return det, x, torch.sort(fg, dim=1, descending=True).values


def _threshold(fg_sorted, live):
    """A score threshold under which the busiest image has `live` scores
    above it (and no image more), or None for the config's own."""
    if live is None:
        return None
    return float(fg_sorted[:, live].max())


@pytest.fixture
def nms_problems(monkeypatch):
    """The (P, K) shapes the NMS op's CPU implementation runs on."""
    seen = []
    plain = port_nms.nms_keep_batch_plain

    def spy(boxes, scores, *args):
        seen.append(tuple(scores.shape))
        return plain(boxes, scores, *args)

    monkeypatch.setattr(port_nms, "nms_keep_batch_plain", spy)
    return seen


@pytest.mark.parametrize("mode,live,branch", [
    ("reference", None, None),
    ("fused", 2500, "fallback"),
    ("fused", 1500, "tier_2048"),
    ("fused", 600, "tier_1024"),
])
def test_reloaded_artifact_bit_equal_to_eager(voc_detector, tmp_path,
                                              nms_problems, mode, live,
                                              branch):
    det, x, fg_sorted = voc_detector
    thr = _threshold(fg_sorted, live)
    if thr is not None:
        det = dataclasses.replace(det, config=dataclasses.replace(
            det.config, score_thresh=thr))
    counts = port_det._postprocess_fused.branches
    counts.clear()
    want = make_predict_step(det, impl=mode)(det.model, x)
    assert dict(counts) == ({branch: 1} if branch else {})
    assert want["valid"].any()
    eager_nms = list(nms_problems)

    program = _reloaded(det, tmp_path, batch_size=2, postprocess_impl=mode)
    nms_problems.clear()
    with torch.no_grad():
        got = program(x)
    # the program's branch: one NMS, over the same problems as eager's
    assert nms_problems == eager_nms
    want_k = {None: 144, "fallback": 144, "tier_1024": 1024,
              "tier_2048": 2048}[branch]
    assert nms_problems[0][1] == want_k
    assert not counts or dict(counts) == {branch: 1}   # nothing counted
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_bf16_artifact_bit_equal_to_eager(ref, tmp_path):
    det = port_ssdlite(num_classes=5, size=_SIZE, device="cpu",
                       dtype=torch.bfloat16)
    load_jax_variables(det.model, ref["variables"])
    x = torch.from_numpy(_export_inputs(2))
    want = make_predict_step(det)(det.model, x)
    program = _reloaded(det, tmp_path, batch_size=2)
    with torch.no_grad():
        got = program(x)
        heads = _reloaded(det, tmp_path, batch_size=2,
                          with_postprocess=False)(x)
    assert heads["cls_logits"].dtype == torch.bfloat16
    assert want["valid"].any()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_export_contract(ref):
    """A classifier raises TypeError, as the JAX function takes
    detectors only; an unknown postprocess raises; the module is left in
    the mode it was in, and the program keeps no example input."""
    with pytest.raises(TypeError, match="Detector"):
        export_detector(mobilenet_v3_small(num_classes=10, device="cpu"))
    pd = ref["pd"]
    with pytest.raises(ValueError, match="impl must be"):
        export_detector(pd, postprocess_impl="sparse")
    pd.model.train()
    try:
        exported = export_detector(pd, with_postprocess=False)
        assert pd.model.training
    finally:
        pd.model.eval()
    assert exported.example_inputs is None
