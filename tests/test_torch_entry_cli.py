"""Port vs JAX package: the entry points a user reaches first, run as CLIs
on the CPU (`--device cpu`) beside the JAX package's:

  * predict (demonet_tpu_torch/predict.py) on the flagship at 320x320 from
    the trained bench_assets/ssdlite320_shapes_trained.npz, carried in as
    a synthesized reference .pth through --torch-weights, on seeded
    shapes frames written as JPEG, in both --postprocess modes: the same
    detections above 0.5 (labels equal, boxes within 1e-3 px, scores
    within 1e-5: fp32 convs summed in another order), and each saved
    image at its frame's own size;
  * eval_voc (demonet_tpu_torch/eval_voc.py) on a small VOCdevkit with
    ssd_lite_mobilenet_v2 from a synthesized .pth: every per-class AP and
    the mAP within 1e-6, the scored detections within the predict
    tolerances, and the det_test_<cls>.txt files written;
  * the train CLI's --test-only with --torch-weights, and with
    --pretrained from a weights cache (DEMONET_WEIGHTS_DIR on a temporary
    directory): the JAX CLI's COCO summary;
  * --tensorboard: metrics.jsonl, and an event file when the tensorboard
    package imports.

The JAX CLIs draw random weights before they load the file and throw
them away; here they draw zeros of the same shapes (`jax.eval_shape`),
which their eager flax init would take 20-45 s each to draw for nothing.
"""

import glob
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.models import detection as jax_detection
from demonet_tpu_torch import eval_voc as port_eval_voc
from demonet_tpu_torch import predict as port_predict
from demonet_tpu_torch import train as port_train
from demonet_tpu_torch.utils import pretrained
from demonet_tpu_torch.utils.checkpoints import load_npz_variables
from demonet_tpu_torch.utils.torch_weights import synthesize_torch_state_dict
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NPZ = os.path.join(_REPO, "bench_assets", "ssdlite320_shapes_trained.npz")
_FLAGSHIP = "ssdlite320_mobilenet_v3_large"
# the JAX CLIs, as modules (the packages export functions under the names)
jax_predict = importlib.import_module("demonet_tpu.predict")
jax_eval_voc = importlib.import_module("demonet_tpu.eval_voc")
jax_train = importlib.import_module("demonet_tpu.train")
jax_engine = importlib.import_module("demonet_tpu.engine")
jax_viz = importlib.import_module("demonet_tpu.utils.viz")


@pytest.fixture
def zero_jax_init(monkeypatch):
    """The JAX detectors' init as zeros of its shapes."""
    init = jax_detection.Detector.init

    def zeros(self, rng, *args, **kwargs):
        shapes = jax.eval_shape(lambda r: init(self, r, *args, **kwargs), rng)
        return jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(jax_detection.Detector, "init", zeros)


@pytest.fixture
def jax_evaluator(monkeypatch):
    """The evaluator of each JAX evaluation (the JAX CLIs return None)."""
    seen = []
    run = jax_engine.evaluate

    def spy(*args, **kwargs):
        seen.append(run(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(jax_engine, "evaluate", spy)
    return seen


def _save_pth(name, tree, path):
    torch.save({k: torch.from_numpy(v) for k, v in
                synthesize_torch_state_dict(name, tree).items()}, path)
    return path


@pytest.fixture(scope="module")
def trained_pth(tmp_path_factory):
    """The trained flagship npz as a reference-layout .pth."""
    path = str(tmp_path_factory.mktemp("weights") / "flagship.pth")
    return _save_pth(_FLAGSHIP, load_npz_variables(_NPZ), path)


def _shapes_frame(rng, h, w):
    """Noise with 1-3 filled rectangles (the frames the trained weights
    were trained on), uint8 HWC."""
    img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(int(rng.integers(1, 4))):
        bw, bh = rng.integers(w // 6, w // 2), rng.integers(h // 6, h // 2)
        x0, y0 = rng.integers(0, w - bw), rng.integers(0, h - bh)
        img[y0:y0 + bh, x0:x0 + bw] = rng.integers(40, 256, 3)
    return img


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    import cv2

    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("frames")
    paths = []
    for i, (h, w) in enumerate([(240, 400), (320, 320), (300, 260)]):
        p = str(d / f"frame{i}.jpg")
        assert cv2.imwrite(p, _shapes_frame(rng, h, w))
        paths.append(p)
    return paths


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_port_predict_matches_jax_predict(mode, trained_pth, jpegs, tmp_path,
                                          zero_jax_init, monkeypatch):
    import cv2

    seen = []
    select = jax_viz.select_top_predictions
    monkeypatch.setattr(jax_viz, "select_top_predictions",
                        lambda d, t: seen.append(select(d, t)) or seen[-1])
    argv = ["--torch-weights", trained_pth, "--images", *jpegs,
            "--postprocess", mode]
    jax_predict.main(jax_predict.get_args_parser().parse_args(
        [*argv, "--output-dir", str(tmp_path / "jax")]))
    got = port_predict.main(port_predict.get_args_parser().parse_args(
        [*argv, "--output-dir", str(tmp_path / "port"), "--device", "cpu"]))
    assert len(got) == len(seen) == len(jpegs)
    assert sum(len(g["scores"]) for g in got) >= 3
    for g, w, path in zip(got, seen, jpegs):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-5)
        assert (g["scores"] > 0.5).all() and g["valid"].all()
        out = cv2.imread(str(tmp_path / "port" / os.path.basename(path)))
        assert out.shape == cv2.imread(path).shape


@pytest.fixture
def voc_root(tmp_path):
    """The VOCdevkit of tests/test_e2e_voc.py: 3 frames of 80x60, a cat
    each."""
    from PIL import Image

    root = tmp_path / "VOCdevkit" / "VOC2007"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = []
    for i in range(3):
        name = f"{i:06d}"
        names.append(name)
        Image.fromarray(
            (rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(
                root / "JPEGImages" / f"{name}.jpg")
        xml = f"""<annotation>
          <size><width>80</width><height>60</height><depth>3</depth></size>
          <object><name>cat</name><difficult>0</difficult>
            <bndbox><xmin>{10 + i}</xmin><ymin>10</ymin>
                    <xmax>{40 + i}</xmax><ymax>40</ymax></bndbox>
          </object>
        </annotation>"""
        (root / "Annotations" / f"{name}.xml").write_text(xml)
    (root / "ImageSets" / "Main" / "test.txt").write_text(
        "\n".join(names) + "\n")
    return str(tmp_path / "VOCdevkit")


def test_port_eval_voc_matches_jax_eval_voc(voc_root, tmp_path, zero_jax_init,
                                            jax_evaluator):
    from demonet_tpu.models import builders as jax_builders

    shapes = jax_builders.ssd_lite_mobilenet_v2(num_classes=21, size=(96, 96))
    tree = tp.jax_variables(shapes.init, 5)
    pth = _save_pth("ssd_lite_mobilenet_v2", tree, str(tmp_path / "v2.pth"))
    # batch 8: the JAX CLI shards it over the tests' 8 CPU devices
    argv = ["--data-path", voc_root, "--image-size", "96", "--batch-size",
            "8", "--torch-weights", pth]
    jax_eval_voc.main(jax_eval_voc.get_args_parser().parse_args(argv))
    results = tmp_path / "results"
    got = port_eval_voc.main(port_eval_voc.get_args_parser().parse_args(
        [*argv, "--device", "cpu", "--results-dir", str(results)]))
    want = jax_evaluator[-1].aps
    assert got.use_07_metric and set(got.aps) == set(want)
    for cls, ap in want.items():
        assert abs(got.aps[cls] - ap) <= 1e-6, (cls, got.aps[cls], ap)
    # random weights find no cat (every AP is 0): the detections that the
    # evaluators scored are held to each other as well, at the frames'
    # own sizes
    dets = jax_evaluator[-1]._dets
    assert sorted(got._dets) == sorted(dets) == [0, 1, 2]
    for i, w in dets.items():
        g = got._dets[i]
        assert len(w["labels"]) == 100
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-5)
        assert g["boxes"][:, 2].max() <= 80 and g["boxes"][:, 3].max() <= 60
    assert os.path.exists(results / "det_test_cat.txt")
    assert len(glob.glob(str(results / "det_test_*.txt"))) == 20


@pytest.fixture(scope="module")
def jax_summary(trained_pth, tmp_path_factory):
    """The JAX train CLI's --test-only --torch-weights COCO summary."""
    seen = []
    mp = pytest.MonkeyPatch()
    run, init = jax_engine.evaluate, jax_detection.Detector.init
    mp.setattr(jax_engine, "evaluate",
               lambda *a, **k: seen.append(run(*a, **k)) or seen[-1])
    mp.setattr(jax_detection.Detector, "init",
               lambda self, rng, *a, **k: jax.tree_util.tree_map(
                   lambda s: np.zeros(s.shape, s.dtype),
                   jax.eval_shape(lambda r: init(self, r, *a, **k), rng)))
    try:
        jax_train.main(jax_train.get_args_parser().parse_args(
            _TEST_ONLY + ["--torch-weights", trained_pth, "--output-dir",
                          str(tmp_path_factory.mktemp("jax_cli"))]))
    finally:
        mp.undo()
    return seen[-1].stats


_TEST_ONLY = ["--dataset", "synthetic", "--synthetic-size", "8",
              "--batch-size", "8", "--num-classes", "91", "--test-only"]


def test_train_cli_torch_weights_matches_jax(trained_pth, jax_summary,
                                             tmp_path, capsys):
    ev = port_train.main(port_train.get_args_parser().parse_args(
        _TEST_ONLY + ["--torch-weights", trained_pth, "--device", "cpu",
                      "--output-dir", str(tmp_path)]))
    assert f"loaded pretrained weights for {_FLAGSHIP}" in \
        capsys.readouterr().out
    assert np.isfinite(ev.stats).all() and ev.stats[1] > 0
    np.testing.assert_array_equal(ev.stats, jax_summary)


def test_train_cli_pretrained_from_the_cache_matches_jax(
        trained_pth, jax_summary, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEMONET_WEIGHTS_DIR", str(tmp_path / "cache"))
    argv = _TEST_ONLY + ["--pretrained", "--device", "cpu", "--output-dir",
                         str(tmp_path)]
    with pytest.raises(FileNotFoundError,
                       match=pretrained.PRETRAINED_URLS[_FLAGSHIP]):
        port_train.main(port_train.get_args_parser().parse_args(argv))
    os.makedirs(tmp_path / "cache")
    os.symlink(trained_pth, pretrained.cached_weights_path(_FLAGSHIP))
    ev = port_train.main(port_train.get_args_parser().parse_args(argv))
    assert f"loaded pretrained weights for {_FLAGSHIP}" in \
        capsys.readouterr().out
    np.testing.assert_array_equal(ev.stats, jax_summary)


def test_train_cli_tensorboard_writes_scalars(tmp_path, capsys):
    out = tmp_path / "run"
    port_train.main(port_train.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--synthetic-size", "4", "--batch-size",
         "2", "--num-classes", "91", "--epochs", "1", "--npz-weights", _NPZ,
         "--tensorboard", "--device", "cpu", "--output-dir", str(out)]))
    with open(out / "metrics.jsonl") as f:
        assert len([ln for ln in f if ln.strip()]) == 2
    try:
        import tensorboard  # noqa: F401
        live = True
    except ImportError:
        live = False
    printed = capsys.readouterr().out
    assert ("tensorboard scalars: on" in printed) == live
    assert bool(glob.glob(str(out / "tb" / "events.out.tfevents.*"))) == live


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("kw", [{}, {"impl": "fused"},
                                {"topk_impl": "sparse_pallas"}],
                         ids=["reference", "fused", "sparse_topk"])
def test_predict_step_hands_the_kernels_contiguous_inputs(batch, kw,
                                                          monkeypatch):
    """The kernels' wrappers refuse a non-contiguous CUDA tensor (no
    silent copy); the predict step must hand them contiguous ones at every
    batch size. At B = 1 the per-class scores come out of the sort
    transposed in memory, and the predict CLI runs one image a call. On
    the CPU the plain versions take any layout, so the wrappers are
    watched here."""
    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models import builders, detection

    seen = []

    def watch(name):
        fn = getattr(detection, name)

        def wrapper(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            seen.append((name, [t.is_contiguous() for t in tensors]))
            return fn(*args, **kwargs)

        monkeypatch.setattr(detection, name, wrapper)

    for name in ("nms_keep_batch", "gather_rows_batch", "topk_sparse"):
        watch(name)
    det = builders.ssdlite320_mobilenet_v3_large(num_classes=5, device="cpu")
    images = torch.from_numpy(tp.images(2, (320, 320), batch))
    make_predict_step(det, **kw)(det.model, images)
    assert {n for n, _ in seen} >= {"nms_keep_batch", "gather_rows_batch"}
    assert all(all(c) for _, c in seen), seen
