"""Port vs JAX package: what crosses processes outside the train step
(`parallel/dist.py::all_gather_arrays`, the meters'
`synchronize_between_processes`, the COCO and VOC evaluators' merges) and
the rank-0 checkpoint write, on two spawned gloo ranks
(tests/torch_dist_worker.py).

Each rank holds its own detection sets, image 5 on both with different
detections. The merged COCO set is the JAX evaluator's fed the ranks' sets
in rank order under its rule, first occurrence wins; the merged VOC set
the JAX VocEvaluator's, last wins; and so are their summaries. The
gathers are bit-exact for float64 (NaN, -0.0, infinities, a subnormal),
int64 extremes, uint8, bool and a 0-d array. The port's detection buffer
is byte for byte the JAX package's.
"""

import importlib

import numpy as np
import pytest

from demonet_tpu.data import coco_eval as jax_coco_eval
from demonet_tpu_torch.data import coco_eval as port_coco_eval
from tests import torch_dist_worker as w

jax_voc_eval = importlib.import_module("demonet_tpu.data.voc_eval")

_SHARED = 5
_CLASSES = ["__background__", "dog", "cat", "car"]


def _detections(rng, img_id, g_boxes, keypoints=False):
    """Up to 9 detections of one image, most jittered copies of its gt
    boxes, scores quantized (ties)."""
    n = int(rng.integers(1, 10))
    src = g_boxes[rng.integers(0, len(g_boxes), n)] if len(g_boxes) else \
        np.tile([[10.0, 10.0, 60.0, 60.0]], (n, 1))
    det = {"image_id": img_id, "boxes": src + rng.normal(0, 3, (n, 4)),
           "scores": np.round(rng.random(n), 1),
           "labels": rng.integers(1, len(_CLASSES), n)}
    if keypoints:
        det["keypoints"] = rng.uniform(0, 200, (n, 17, 3))
    return det


def _case(seed, n_img=12, keypoints=False):
    """Ground truth of n_img images (crowds among them) and one set of
    detections for each."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for i in range(n_img):
        n_g = int(rng.integers(0, 5))
        xy = rng.uniform(0, 150, (n_g, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 90, (n_g, 2))], 1)
        gts.append({"image_id": i, "boxes": boxes,
                    "labels": rng.integers(1, len(_CLASSES), n_g),
                    "iscrowd": rng.random(n_g) < 0.15})
        dets.append(_detections(rng, i, boxes, keypoints))
    return gts, dets


def _rank_sets():
    """Two ranks' detection sets: rank 0 holds images 0-5, rank 1 images
    5-11, image 5 on both with other detections."""
    gts, dets = _case(7)
    other = _detections(np.random.default_rng(8), _SHARED,
                        gts[_SHARED]["boxes"])
    return gts, [dets[:_SHARED + 1], [other] + dets[_SHARED + 1:]]


def _voc_set(gts):
    """The VOC view of the same ground truth (a tenth difficult)."""
    rng = np.random.default_rng(9)
    return w.VocSet({f"{g['image_id']:06d}": [
        {"name": _CLASSES[int(lab)], "bbox": list(box),
         "difficult": int(rng.random() < 0.1)}
        for box, lab in zip(g["boxes"], g["labels"])] for g in gts})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    gts, sets = _rank_sets()
    voc_set = _voc_set(gts)
    root = tmp_path_factory.mktemp("merge")
    (root / "ranks").mkdir()
    return gts, sets, voc_set, w.spawn(w.merges, 2, root / "ranks", gts, sets,
                                       voc_set, _CLASSES, str(root / "ckpt"))


def test_all_gather_arrays_round_trip_is_exact(ranks):
    *_, got = ranks
    want = [w.exact_arrays(r) for r in (0, 1)]
    for r in got:
        for key, gathered in r["gathered"].items():
            expect = np.stack([want[0][key], want[1][key]])
            assert gathered.dtype == expect.dtype, key
            assert gathered.shape == expect.shape, key
            assert gathered.tobytes() == expect.tobytes(), key


def test_meters_sum_across_ranks(ranks):
    *_, got = ranks
    # rank 0 logged loss 0, 1; rank 1 logged 10, 11, 12
    for r in got:
        assert r["meters"] == {"loss": (5, 34.0), "time": (5, 2.5)}


def test_pack_detections_bytes_equal_jax():
    _, dets = _case(3, keypoints=True)
    for case in ({d["image_id"]: d for d in dets},
                 {d["image_id"]: {k: v for k, v in d.items()
                                  if k != "keypoints"} for d in dets}, {}):
        got = port_coco_eval._pack_detections(case)
        want = jax_coco_eval._pack_detections(case)
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes()


def test_coco_merge_keeps_first_occurrence_as_jax(ranks):
    gts, sets, _, got = ranks
    want = jax_coco_eval.CocoEvaluator(gts)
    for s in sets:                 # rank order, the JAX update's first wins
        want.update(s)
    want.accumulate()
    want.summarize()
    for r in got:
        merged = r["coco"]["detections"]
        assert sorted(merged) == sorted(want.detections) == list(range(12))
        for img_id, det in want.detections.items():
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(merged[img_id][k], det[k])
        np.testing.assert_array_equal(r["coco"]["stats"], want.stats)
    np.testing.assert_array_equal(
        got[0]["coco"]["detections"][_SHARED]["scores"],
        sets[0][-1]["scores"])


def test_voc_merge_keeps_last_occurrence_as_jax(ranks):
    _, sets, voc_set, got = ranks
    want = jax_voc_eval.VocEvaluator(voc_set, classes=_CLASSES)
    for s in sets:                 # rank order, the JAX update's last wins
        want.update(s)
    want.accumulate()
    aps = want.summarize()
    for r in got:
        merged = r["voc"]["detections"]
        assert list(merged) == list(want._dets)
        for img_id, det in want._dets.items():
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(merged[img_id][k], det[k])
        assert r["voc"]["aps"] == aps
    np.testing.assert_array_equal(
        got[0]["voc"]["detections"][_SHARED]["scores"],
        sets[1][0]["scores"])


def test_only_rank_zero_writes_the_checkpoint(ranks):
    """Each rank saves into its own directory: only rank 0's holds the
    checkpoint, and rank 1 reads it right after the save returns."""
    *_, got = ranks
    assert got[0]["own_dir"] == ["checkpoint_0", "checkpoint_0.meta.json"]
    assert got[1]["own_dir"] == []
    for r in got:
        assert r["read_back"]["step"] == 1 and r["read_back"]["epoch"] == 0
        assert (r["read_back"]["weight"] == got[0]["read_back"]["weight"]).all()
