"""Port vs JAX package: the evaluators (demonet_tpu_torch/data/coco_eval.py,
voc_eval.py) and the evaluation loop (demonet_tpu_torch/engine/evaluate.py).

On the same ground truth and the same detections, the port's COCO (boxes
and OKS keypoints) and VOC summaries must equal the JAX ones exactly.
`detections_to_numpy` and `evaluate` must give the JAX results with one
stub predict step standing in for the model in both (a function of the
images alone), so no model is built.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demonet_tpu.data import coco_eval as jax_coco_eval
from demonet_tpu.data.loader import DetectionLoader as JaxLoader
from demonet_tpu.data.synthetic import SyntheticDetection as JaxSynthetic
from demonet_tpu_torch.data import coco_eval as port_coco_eval
from demonet_tpu_torch.data.loader import DetectionLoader
from demonet_tpu_torch.data.synthetic import SyntheticDetection
from demonet_tpu_torch.engine.state import TrainState

# the JAX packages export functions under these modules' names
jax_voc_eval = importlib.import_module("demonet_tpu.data.voc_eval")
port_voc_eval = importlib.import_module("demonet_tpu_torch.data.voc_eval")
jax_evaluate = importlib.import_module("demonet_tpu.engine.evaluate")
port_evaluate = importlib.import_module("demonet_tpu_torch.engine.evaluate")


def _boxes_case(rng, n_img=12, n_cats=3, keypoints=False):
    """Random gt (crowds among them) and detections, half of them jittered
    copies of gt boxes, with quantized scores (ties)."""
    gts, dets = [], []
    for img_id in range(n_img):
        n_g = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (n_g, 2))
        g_boxes = np.concatenate([xy, xy + rng.uniform(4, 120, (n_g, 2))], 1)
        gt = {"image_id": img_id, "boxes": g_boxes,
              "labels": rng.integers(1, n_cats + 1, n_g),
              "iscrowd": rng.random(n_g) < 0.2}
        n_d = int(rng.integers(0, 10))
        d_boxes = []
        for _ in range(n_d):
            if n_g and rng.random() < 0.5:
                d_boxes.append(g_boxes[rng.integers(0, n_g)]
                               + rng.normal(0, 3, 4))
            else:
                xy1 = rng.uniform(0, 200, 2)
                d_boxes.append(np.concatenate(
                    [xy1, xy1 + rng.uniform(4, 120, 2)]))
        det = {"image_id": img_id,
               "boxes": np.asarray(d_boxes).reshape(-1, 4),
               "scores": np.round(rng.random(n_d), 1),
               "labels": rng.integers(1, n_cats + 1, n_d)}
        if keypoints:
            gt["labels"] = np.ones(n_g, np.int64)
            gt["iscrowd"] = np.zeros(n_g, bool)
            gt["areas"] = (g_boxes[:, 2] - g_boxes[:, 0]) * (
                g_boxes[:, 3] - g_boxes[:, 1])
            kp = np.concatenate([
                g_boxes[:, None, :2] + rng.uniform(0, 1, (n_g, 17, 2))
                * (g_boxes[:, None, 2:] - g_boxes[:, None, :2]),
                rng.integers(0, 3, (n_g, 17, 1))], 2)
            gt["keypoints"] = kp
            det["labels"] = np.ones(n_d, np.int64)
            src = rng.integers(0, max(n_g, 1), n_d)
            det["keypoints"] = (kp[src] + np.concatenate([
                rng.normal(0, 4, (n_d, 17, 2)), np.zeros((n_d, 17, 1))], 2)
                if n_g else rng.uniform(0, 200, (n_d, 17, 3)))
        gts.append(gt)
        dets.append(det)
    return gts, dets


def _run_coco(module, gts, dets, **kw):
    ev = module.CocoEvaluator(gts, **kw)
    for d in dets:
        ev.update([d])
    ev.synchronize_between_processes()
    ev.accumulate()
    return ev, ev.summarize()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_type", ["bbox", "keypoints"])
def test_coco_summaries_equal_jax(iou_type, seed):
    kw = {"iou_type": iou_type}
    if iou_type == "bbox" and seed == 2:
        kw["category_ids"] = [1, 2]
    gts, dets = _boxes_case(np.random.default_rng(seed),
                            keypoints=iou_type == "keypoints")
    ev_w, want = _run_coco(jax_coco_eval, gts, dets, **kw)
    ev_g, got = _run_coco(port_coco_eval, gts, dets, **kw)
    assert got == want
    np.testing.assert_array_equal(ev_g.stats, ev_w.stats)
    assert np.isfinite(ev_g.stats).all() and (ev_g.stats > 0).any()


def test_pack_unpack_detections_equal_jax():
    _, dets = _boxes_case(np.random.default_rng(4), keypoints=True)
    by_id = {d["image_id"]: d for d in dets}
    buf = port_coco_eval._pack_detections(by_id)
    np.testing.assert_array_equal(buf, jax_coco_eval._pack_detections(by_id))
    got = port_coco_eval._unpack_detections(buf)
    want = jax_coco_eval._unpack_detections(buf)
    assert sorted(got) == sorted(want)
    for i in want:
        for k in want[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k])


class _VocSet:
    """What VocEvaluator reads of a VOC dataset: image names and objects."""

    def __init__(self, rng, n=10):
        self.image_names = [f"{i:06d}" for i in range(n)]
        self._objs = {}
        for name in self.image_names:
            objs = []
            for _ in range(int(rng.integers(0, 5))):
                x, y = rng.uniform(0, 150, 2)
                objs.append({"name": str(rng.choice(["dog", "cat", "car"])),
                             "bbox": [x, y, x + rng.uniform(5, 80),
                                      y + rng.uniform(5, 80)],
                             "difficult": int(rng.random() < 0.2)})
            self._objs[name] = objs

    def annotations_by_name(self):
        return self._objs


def _voc_results(rng, ds):
    labels = {"dog": 12, "cat": 8, "car": 7}
    out = []
    for i, name in enumerate(ds.image_names):
        boxes, scores, cls = [], [], []
        for o in ds.annotations_by_name()[name]:
            if rng.random() < 0.8:
                boxes.append(np.asarray(o["bbox"]) + rng.normal(0, 4, 4))
                scores.append(round(float(rng.random()), 1))
                cls.append(labels[o["name"]])
        boxes.append(rng.uniform(0, 100, 4) + [0, 0, 100, 100])
        scores.append(0.5)
        cls.append(12)
        out.append({"image_id": i, "boxes": np.asarray(boxes),
                    "scores": np.asarray(scores), "labels": np.asarray(cls)})
    return out


@pytest.mark.parametrize("use_07_metric", [True, False])
def test_voc_summaries_and_results_files_equal_jax(tmp_path, use_07_metric):
    rng = np.random.default_rng(5)
    ds = _VocSet(rng)
    results = _voc_results(rng, ds)
    out = {}
    for name, module in (("jax", jax_voc_eval), ("port", port_voc_eval)):
        ev = module.VocEvaluator(ds, use_07_metric=use_07_metric,
                                 output_dir=str(tmp_path / name))
        ev.update(results)
        ev.synchronize_between_processes()
        ev.accumulate()
        out[name] = (ev.summarize(), ev.aps)
    assert out["port"] == out["jax"]
    assert out["port"][0]["mAP"] > 0
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files and files == sorted(p.name for p in (tmp_path / "port")
                                     .iterdir())
    for f in files:
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()


def test_voc_ap_equals_jax():
    rng = np.random.default_rng(6)
    rec = np.sort(rng.random(20))
    prec = rng.random(20)
    for flag in (True, False):
        assert port_voc_eval.voc_ap(rec, prec, flag) == \
            jax_voc_eval.voc_ap(rec, prec, flag)


def test_evaluators_raise_across_processes(monkeypatch):
    """The merges across processes, in one process: `all_gather_arrays`
    stands in for two ranks whose other rank holds `other`'s detections
    (image 0 on both, with other detections). COCO keeps the first
    occurrence in rank order, VOC the last, as the JAX merges do; every
    other image is merged once. (The name is that of the test this one
    replaced, which asserted that the merges raised.)"""
    from demonet_tpu_torch.parallel import dist

    rng = np.random.default_rng(0)
    gts, dets = _boxes_case(rng)
    mine, other = dets[:6], dets[6:] + [dict(dets[3], image_id=0)]
    gathers = []

    def two_ranks(x, group=None):
        """Rank 0 is this process; rank 1 gives the same call's array
        made by a twin evaluator that holds `other`. With no group asked
        for, the merge is over every process."""
        assert group is None
        gathers.append(x)
        theirs = twin_calls[len(gathers) - 1]
        width = max(np.asarray(x).size, np.asarray(theirs).size)
        if np.asarray(x).ndim == 0:
            return np.stack([x, theirs])
        pad = [np.pad(a, (0, width - a.size)) for a in (x, theirs)]
        return np.stack(pad)

    def recorded_calls(ev, results):
        """The arrays that `ev`, holding `results`, passes to
        all_gather_arrays, in order."""
        calls = []
        ev.update(results)
        with monkeypatch.context() as m:
            m.setattr(dist, "process_count", lambda group=None: 2)
            m.setattr(dist, "all_gather_arrays",
                      lambda x, group=None: calls.append(x)
                      or np.stack([x, x]))
            ev.synchronize_between_processes()
        return calls

    voc_set = _VocSet(np.random.default_rng(1))
    for make, first_wins in (
            (lambda: port_coco_eval.CocoEvaluator(gts), True),
            (lambda: port_voc_eval.VocEvaluator(voc_set), False)):
        twin_calls = recorded_calls(make(), other)
        gathers.clear()
        ev = make()
        ev.update(mine)
        monkeypatch.setattr(dist, "process_count", lambda group=None: 2)
        monkeypatch.setattr(dist, "all_gather_arrays", two_ranks)
        ev.synchronize_between_processes()
        monkeypatch.undo()
        merged = ev.detections if first_wins else ev._dets
        assert len(gathers) == 2            # the sizes, then the bytes
        assert sorted(merged) == sorted({d["image_id"] for d in dets})
        want0 = dets[0] if first_wins else dets[3]
        np.testing.assert_array_equal(merged[0]["scores"], want0["scores"])
        for d in dets[1:]:
            np.testing.assert_array_equal(merged[d["image_id"]]["scores"],
                                          d["scores"])


# ---------- detections_to_numpy and evaluate ----------

def _stub_detections(images, sizes):
    """Numpy 'detections' from the images alone: for each fill colour of
    the synthetic frames (label l is filled with green 80 + 50 l % 175),
    the box around the pixels of that colour, scored by its share of the
    frame, and a shifted copy with a lower score; padded to D = 12."""
    b, h, w, _ = images.shape
    green = images[..., 1]
    if images.dtype != np.uint8:
        green = np.rint(green * 255.0)
    d = 12
    boxes = np.zeros((b, d, 4), np.float32)
    scores = np.zeros((b, d), np.float32)
    labels = np.zeros((b, d), np.int32)
    valid = np.zeros((b, d), bool)
    for i in range(b):
        sy, sx = sizes[i, 0] / h, sizes[i, 1] / w
        n = 0
        for lab in range(1, 7):
            ys, xs = np.nonzero(green[i] == 80 + 50 * lab % 175)
            if not len(ys):
                continue
            box = np.asarray([xs.min() * sx, ys.min() * sy,
                              (xs.max() + 1) * sx, (ys.max() + 1) * sy])
            share = len(ys) / (h * w)
            boxes[i, n:n + 2] = box, box + 6
            scores[i, n:n + 2] = 0.5 + share / 2, share / 2
            labels[i, n:n + 2] = lab
            valid[i, n:n + 2] = True
            n += 2
    return {"boxes": boxes, "scores": scores, "labels": labels,
            "valid": valid}


def test_detections_to_numpy_equals_jax():
    rng = np.random.default_rng(3)
    images = rng.random((3, 16, 16, 3)).astype(np.float32) * 0.2
    images[:, 4:9, 5:12, 1] = 130 / 255
    dets = _stub_detections(images, np.asarray([[32, 32]] * 3))
    dets["valid"][1] = False
    ids = np.asarray([7, 8, 9], np.int64)
    want = jax_evaluate.detections_to_numpy(dets, ids)
    for arg in (dets, {k: torch.from_numpy(v) for k, v in dets.items()}):
        got = port_evaluate.detections_to_numpy(arg, ids)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["image_id"] == w["image_id"]
            for k in ("boxes", "scores", "labels"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def _recording(evaluator_cls):
    """The evaluator class, keeping every result it is given in `seen`."""
    class Recording(evaluator_cls):
        def update(self, results):
            results = list(results)
            self.__dict__.setdefault("seen", []).extend(results)
            super().update(results)

    return Recording


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
def test_evaluate_equals_jax_with_one_stub_step(image_dtype, capsys):
    kw = dict(n=10, image_size=(48, 48), num_classes=7, seed=4,
              variable_size=True)
    ds_w, ds_g = JaxSynthetic(**kw), SyntheticDetection(**kw)
    lkw = dict(batch_size=4, image_size=(48, 48), image_dtype=image_dtype)

    def jax_step(variables, images, sizes):
        return {k: jnp.asarray(v) for k, v in _stub_detections(
            np.asarray(images), np.asarray(sizes)).items()}

    reads = []

    def port_step(model, images, sizes):
        assert images.device == sizes.device == torch.device("cpu")
        reads.append(images.shape[0])
        return {k: torch.from_numpy(v) for k, v in _stub_detections(
            images.numpy(), sizes.numpy()).items()}

    want = jax_evaluate.evaluate(
        jax_step, {}, JaxLoader(ds_w, **lkw),
        _recording(jax_coco_eval.CocoEvaluator)(ds_w.ground_truth_for_eval()))
    assert [r["image_id"] for r in want.seen] == list(range(10))
    model = torch.nn.Linear(1, 1)
    for holder in (model, TrainState(model, None)):
        got = port_evaluate.evaluate(
            port_step, holder, DetectionLoader(ds_g, **lkw),
            _recording(port_coco_eval.CocoEvaluator)(
                ds_g.ground_truth_for_eval()))
        np.testing.assert_array_equal(got.stats, want.stats)
        # what reached the evaluator: the JAX results, the last batch's
        # padding dropped, values and dtypes alike
        assert len(got.seen) == len(want.seen)
        for g, w in zip(got.seen, want.seen):
            assert g["image_id"] == w["image_id"]
            for k in ("boxes", "scores", "labels"):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
    assert reads == [4, 4, 4] * 2
    assert want.stats[1] > 0.5          # the stub finds rectangles
    with pytest.raises(TypeError, match="DataMesh"):
        port_evaluate.evaluate(port_step, model, [], None, mesh=object())
