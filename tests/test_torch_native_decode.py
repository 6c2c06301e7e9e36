"""Port vs JAX package: the native data-loader core (JPEG decode +
bilinear resize in C++ threads) and the loader's native_decode=True.

The port builds its own library from demonet_tpu_torch/csrc/imageio.cc
(g++ -O3, into demonet_tpu_torch/_build/); the JAX package loads its
committed build of cpp/imageio.cc. Both call the system libjpeg and do
the same float arithmetic (x86-64 g++ contracts no multiply-add without
-mfma, so -O3 rounds as the JAX build does): images and sizes must be
bit-equal, and so must the loader's batches over a small COCO tree. The
tests skip only where the library cannot be built here (no g++ or no
<jpeglib.h>), as the JAX package's test_native_imageio_roundtrip skips
without its library.
"""

import io
import json

import numpy as np
import pytest

from demonet_tpu.data import native as jax_native
from demonet_tpu.data.coco import CocoDetection as JaxCoco
from demonet_tpu.data.loader import DetectionLoader as JaxLoader
from demonet_tpu_torch.data import native
from demonet_tpu_torch.data.coco import CocoDetection
from demonet_tpu_torch.data.loader import DetectionLoader
from demonet_tpu_torch.data.synthetic import SyntheticDetection

_TOOLS = native.toolchain()
needs_build = pytest.mark.skipif(
    not (_TOOLS["g++"] and _TOOLS["jpeglib.h"]),
    reason=f"the native library needs g++ and <jpeglib.h>: {_TOOLS}")


def _jpeg(rng, h, w, gray=False, quality=90):
    from PIL import Image

    arr = rng.integers(0, 256, (h, w) if gray else (h, w, 3), np.uint8)
    arr[h // 4: h // 2, w // 3: w // 2] = 200   # an edge to interpolate
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    return [_jpeg(rng, 30, 40), _jpeg(rng, 300, 500), _jpeg(rng, 7, 5),
            _jpeg(rng, 64, 64, gray=True), _jpeg(rng, 123, 77, quality=40)]


def test_library_builds_into_the_port_and_not_from_the_jax_package():
    assert native.SOURCE.endswith("demonet_tpu_torch/csrc/imageio.cc")
    assert "/demonet_tpu_torch/_build/imageio-" in native.library_path()
    if _TOOLS["g++"] and _TOOLS["jpeglib.h"]:
        assert native.available(), native.build_error()
        assert native.build_error() is None


@needs_build
@pytest.mark.parametrize("out_hw", [(32, 32), (320, 320), (17, 45)])
def test_decode_one_bit_equal_to_jax(blobs, out_hw):
    assert jax_native.available()
    for blob in blobs:
        got, hw = native.decode_jpeg_resize(blob, *out_hw)
        want, want_hw = jax_native.decode_jpeg_resize(blob, *out_hw)
        assert hw == want_hw
        assert got.shape == (*out_hw, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@needs_build
@pytest.mark.parametrize("threads", [1, 3])
def test_decode_batch_bit_equal_to_jax(blobs, threads):
    got, hw = native.decode_jpeg_batch(blobs, 48, 64, threads)
    want, want_hw = jax_native.decode_jpeg_batch(blobs, 48, 64, threads)
    np.testing.assert_array_equal(hw, want_hw)
    assert hw.tolist() == [[30, 40], [300, 500], [7, 5], [64, 64], [123, 77]]
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() <= 1.0


@needs_build
def test_corrupt_jpeg_raises_as_in_jax(blobs):
    bad = [blobs[0], b"not a jpeg", blobs[1][:40]]
    for mod in (native, jax_native):
        with pytest.raises(ValueError, match="2 JPEG decodes failed"):
            mod.decode_jpeg_batch(bad, 8, 8, 2)
        with pytest.raises(ValueError, match="JPEG decode failed"):
            mod.decode_jpeg_resize(b"not a jpeg", 8, 8)


@pytest.fixture
def coco_tree(tmp_path):
    """COCO val2017 layout: 5 JPEGs of several sizes, boxes on 4 of them
    (one with more boxes than the loader's max_gt)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    root = tmp_path / "coco"
    (root / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    sizes = [(30, 40), (64, 48), (100, 150), (33, 33), (48, 80)]
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / "val2017" / f"{i}.jpg", quality=85)
        images.append({"id": 10 + i, "file_name": f"{i}.jpg", "height": h,
                       "width": w})
        for j in range(0 if i == 3 else (6 if i == 2 else 2)):
            x, y = float(rng.integers(0, w // 2)), float(rng.integers(0, h // 2))
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": 1 + j % 3,
                         "bbox": [x, y, w / 4, h / 4], "area": w * h / 16,
                         "iscrowd": 0})
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"c{c}"} for c in (1, 2, 3)]}, f)
    return root


def _loaders(root, **kw):
    ann = str(root / "annotations" / "instances_val2017.json")
    img = str(root / "val2017")
    return (DetectionLoader(CocoDetection(img, ann), **kw),
            JaxLoader(JaxCoco(img, ann), **kw))


@needs_build
@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_native_loader_batches_bit_equal_to_jax(coco_tree, image_dtype,
                                                prefetch):
    port, jax_loader = _loaders(
        coco_tree, batch_size=2, image_size=(40, 56), max_gt=4,
        native_decode=True, native_threads=3, image_dtype=image_dtype,
        prefetch=prefetch)
    got, want = list(port), list(jax_loader)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[-1]["batch_valid"].tolist() == [True, False]
    assert got[0]["original_sizes"].tolist() == [[30, 40], [64, 48]]
    assert got[1]["gt_valid"][0].sum() == 4     # 6 boxes cut to max_gt


@needs_build
def test_native_loader_refuses_what_jax_refuses(coco_tree, monkeypatch):
    for kw, match in (({"max_kp": 5}, "max_kp"),
                      ({"with_masks": True}, "max_kp/with_masks"),
                      ({"num_workers": 2}, "C\\+\\+ threads")):
        for make in _refusing(coco_tree, kw):
            with pytest.raises(ValueError, match=match):
                make()
    for loader in (DetectionLoader, JaxLoader):
        with pytest.raises(ValueError, match="raw_item"):
            loader(SyntheticDetection(n=2, image_size=(32, 32)), 2, (32, 32),
                   native_decode=True)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="cannot be built"):
        _refusing(coco_tree, {})[0]()


def _refusing(root, kw):
    ann = str(root / "annotations" / "instances_val2017.json")
    img = str(root / "val2017")
    args = dict(batch_size=2, image_size=(32, 32), native_decode=True, **kw)
    return (lambda: DetectionLoader(CocoDetection(img, ann), **args),
            lambda: JaxLoader(JaxCoco(img, ann), **args))
