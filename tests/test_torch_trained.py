"""Port vs JAX package at full width with the trained weights: the
91-class ssdlite320_mobilenet_v3_large, bench_assets/
ssdlite320_shapes_trained.npz, on real validation frames (the sparse
regime a trained model gives: most (image, class) rows have no candidate
above the score threshold).

Same tolerances as tests/test_torch_model.py: head outputs within 1e-4
relative to their largest magnitude (fp32 convs summed in another order),
and detections with equal valid counts and labels, scores within 1e-5 and
boxes within 1e-3 px after sorting by (-score, label).
"""

import io
import os

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets")


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def trained():
    from PIL import Image

    with np.load(os.path.join(_ASSETS, "ssdlite320_shapes_trained.npz")) as z:
        flat = {k: np.asarray(z[k], np.float32) for k in z.files}
    with np.load(os.path.join(_ASSETS, "val_images_320.npz")) as z:
        images = np.stack([
            np.asarray(Image.open(io.BytesIO(z[k].tobytes())).convert("RGB"))
            for k in ("img0000", "img0001")])
    jd = jax_ssdlite(num_classes=91)
    pd = port_ssdlite(num_classes=91, device="cpu")
    load_jax_variables(pd.model, flat)
    return jd, _unflatten(flat), pd, images


def test_trained_detections_match_jax(trained):
    jd, variables, pd, images = trained
    assert images.shape == (2, 320, 320, 3) and images.dtype == np.uint8
    sizes = np.asarray([[480, 640], [320, 320]], np.int32)
    want = {k: np.asarray(v) for k, v in jax.jit(jd.predict)(
        variables, images, sizes).items()}
    got = {k: v.numpy() for k, v in pd.predict(
        torch.from_numpy(images), torch.from_numpy(sizes)).items()}
    n_valid = want["valid"].sum(1)
    assert np.array_equal(got["valid"].sum(1), n_valid)
    assert 0 < n_valid.max() < 300           # sparse: far below the cap
    for i in range(2):
        order = []
        for d in (want, got):
            v = d["valid"][i]
            s, lab, box = d["scores"][i][v], d["labels"][i][v], d["boxes"][i][v]
            o = np.lexsort((lab, -s))
            order.append((s[o], lab[o], box[o]))
        (ws, wl, wb), (gs, gl, gb) = order
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)


def test_trained_head_outputs_match_jax(trained):
    jd, variables, pd, images = trained
    x = images.astype(np.float32) / 255.0
    from demonet_tpu.models.detection import preprocess as jax_preprocess
    from demonet_tpu_torch.models.detection import preprocess

    want = jax.jit(lambda v, x: jd.apply(v, jax_preprocess(x, jd.config)))(
        variables, x)
    with torch.no_grad():
        got = pd.model(preprocess(torch.from_numpy(x), pd.config))
    for key in ("cls_logits", "bbox_regression"):
        w = np.asarray(want[key])
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * scale)
