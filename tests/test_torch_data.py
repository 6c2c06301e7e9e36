"""Port vs JAX package: datasets, transforms, presets and aspect-ratio
grouping (demonet_tpu_torch/data/).

The port keeps its own copies of the JAX package's numpy data code, so
on the same inputs and the same per-sample numpy streams every image and
every target must be equal, dtype included. The COCO and VOC files are
written in tmp_path, as tests/test_data.py does. numpy only: no model is
built.
"""

import json
import os

import numpy as np
import pytest

from demonet_tpu.data import coco as jax_coco
from demonet_tpu.data import group_by_aspect_ratio as jax_groups
from demonet_tpu.data import presets as jax_presets
from demonet_tpu.data import synthetic as jax_synthetic
from demonet_tpu.data import transforms as jax_T
from demonet_tpu.data import voc as jax_voc
from demonet_tpu_torch.data import coco as port_coco
from demonet_tpu_torch.data import group_by_aspect_ratio as port_groups
from demonet_tpu_torch.data import presets as port_presets
from demonet_tpu_torch.data import synthetic as port_synthetic
from demonet_tpu_torch.data import transforms as port_T
from demonet_tpu_torch.data import voc as port_voc


def assert_same(a, b, path="."):
    """Equal trees: dicts, sequences, arrays (dtype and values), scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, path


# ---------- files ----------

@pytest.fixture
def coco_dir(tmp_path):
    """COCO layout: 3 images (one without annotations), boxes, a crowd box,
    a degenerate box, polygons and keypoints."""
    from PIL import Image

    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    for split in ("train2017", "val2017"):
        (root / split).mkdir()
        for i, name in enumerate(["a.jpg", "b.jpg", "c.jpg"]):
            rng = np.random.default_rng(i)
            Image.fromarray(rng.integers(0, 255, (30, 40, 3), np.uint8)).save(
                root / split / name)
    kp = [10.0, 12.0, 2.0, 14.0, 15.0, 1.0, 0.0, 0.0, 0.0] * 5 + [9, 9, 2] * 2
    ann = {
        "images": [
            {"id": 1, "file_name": "a.jpg", "height": 30, "width": 40},
            {"id": 2, "file_name": "b.jpg", "height": 30, "width": 40},
            {"id": 5, "file_name": "c.jpg", "height": 30, "width": 40},
        ],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 1,
             "bbox": [5, 5, 10, 12], "area": 120, "iscrowd": 0,
             "segmentation": [[5, 5, 15, 5, 15, 17, 5, 17]],
             "keypoints": kp, "num_keypoints": 12},
            {"id": 2, "image_id": 1, "category_id": 7,
             "bbox": [20, 8, 30, 8], "area": 64, "iscrowd": 0,
             "segmentation": [[20, 8, 39, 8, 30, 16]],
             "keypoints": [0.0] * 51, "num_keypoints": 0},
            {"id": 3, "image_id": 2, "category_id": 1,
             "bbox": [0, 0, 0.5, 0.5], "area": 0.25, "iscrowd": 0,
             "segmentation": [[0, 0, 0.5, 0, 0.5, 0.5]],
             "keypoints": kp, "num_keypoints": 12},
            {"id": 4, "image_id": 2, "category_id": 7,
             "bbox": [1, 2, 20, 20], "area": 400, "iscrowd": 1,
             "segmentation": [[1, 2, 21, 2, 21, 22, 1, 22]],
             "keypoints": [0.0] * 51, "num_keypoints": 0},
        ],
        "categories": [{"id": 1, "name": "person"}, {"id": 7, "name": "y"}],
    }
    for mode in ("instances", "person_keypoints"):
        for split in ("train", "val"):
            with open(root / "annotations" / f"{mode}_{split}2017.json",
                      "w") as f:
                json.dump(ann, f)
    return str(root)


@pytest.fixture
def voc_dir(tmp_path):
    """VOC2007 layout: 2 test images, a difficult object."""
    from PIL import Image

    root = tmp_path / "VOCdevkit" / "VOC2007"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Main").mkdir(parents=True)
    objs = {"000001": [("dog", 0, (10, 10, 30, 30)), ("person", 1, (1, 1, 9, 9))],
            "000002": [("car", 0, (5, 6, 45, 30))]}
    for i, (name, items) in enumerate(objs.items()):
        rng = np.random.default_rng(10 + i)
        Image.fromarray(rng.integers(0, 255, (40, 50, 3), np.uint8)).save(
            root / "JPEGImages" / f"{name}.jpg")
        body = "".join(
            f"<object><name>{c}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
            f"<ymax>{b[3]}</ymax></bndbox></object>" for c, d, b in items)
        (root / "Annotations" / f"{name}.xml").write_text(
            "<annotation><size><width>50</width><height>40</height>"
            f"<depth>3</depth></size>{body}</annotation>")
    (root / "ImageSets" / "Main" / "test.txt").write_text(
        "000001\n000002\n")
    return str(tmp_path / "VOCdevkit")


# ---------- datasets ----------

@pytest.mark.parametrize("kw", [
    {}, {"remove_images_without_annotations": True},
    {"return_masks": True}, {"return_keypoints": True},
    {"category_ids": [7]},
], ids=["plain", "remove_empty", "masks", "keypoints", "category_ids"])
def test_coco_dataset_equals_jax(coco_dir, kw):
    args = (os.path.join(coco_dir, "train2017"),
            os.path.join(coco_dir, "annotations", "instances_train2017.json"))
    want = jax_coco.CocoDetection(*args, **kw)
    got = port_coco.CocoDetection(*args, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_same(got[i], want[i])
        assert got.get_height_and_width(i) == want.get_height_and_width(i)
    assert_same(got.ground_truth_for_eval(), want.ground_truth_for_eval())


@pytest.mark.parametrize("split", ["train", "val"])
def test_get_coco_and_get_coco_kp_equal_jax(coco_dir, split):
    tf_w = jax_presets.DetectionPresetTrain("hflip")
    tf_g = port_presets.DetectionPresetTrain("hflip")
    for want, got in ((jax_coco.get_coco(coco_dir, split, tf_w),
                       port_coco.get_coco(coco_dir, split, tf_g)),
                      (jax_coco.get_coco_kp(coco_dir, split, tf_w),
                       port_coco.get_coco_kp(coco_dir, split, tf_g))):
        assert got.ids == want.ids
        for i in range(len(want)):
            assert_same(got.__getitem__(i, rng=np.random.default_rng(i)),
                        want.__getitem__(i, rng=np.random.default_rng(i)))
        assert_same(got.ground_truth_for_eval(), want.ground_truth_for_eval())


def test_polygons_to_mask_equals_jax():
    for seg in ([[1, 1, 30, 2, 20, 25]], [[0, 0, 10, 0, 10, 10, 0, 10],
                                          [15.5, 3, 39, 3.5, 20, 29]], {}):
        assert_same(port_coco._polygons_to_mask(seg, 30, 40),
                    jax_coco._polygons_to_mask(seg, 30, 40))


@pytest.mark.parametrize("keep_difficult", [True, False])
def test_voc_dataset_equals_jax(voc_dir, keep_difficult):
    want = jax_voc.VOCDetection(voc_dir, "2007", "test",
                                keep_difficult=keep_difficult)
    got = port_voc.VOCDetection(voc_dir, "2007", "test",
                                keep_difficult=keep_difficult)
    assert port_voc.VOC_CLASSES == jax_voc.VOC_CLASSES
    for i in range(len(want)):
        assert_same(got[i], want[i])
        assert got.get_height_and_width(i) == want.get_height_and_width(i)
    assert_same(got.annotations_by_name(), want.annotations_by_name())


@pytest.mark.parametrize("variable_size", [False, True])
def test_synthetic_dataset_equals_jax(variable_size):
    kw = dict(n=6, image_size=(64, 48), num_classes=5, seed=3,
              variable_size=variable_size)
    want = jax_synthetic.SyntheticDetection(
        transforms=jax_presets.DetectionPresetTrain("ssd"), **kw)
    got = port_synthetic.SyntheticDetection(
        transforms=port_presets.DetectionPresetTrain("ssd"), **kw)
    for i in range(len(want)):
        assert_same(got.__getitem__(i, rng=np.random.default_rng([1, i])),
                    want.__getitem__(i, rng=np.random.default_rng([1, i])))
        assert got.get_height_and_width(i) == want.get_height_and_width(i)
    assert_same(got.ground_truth_for_eval(), want.ground_truth_for_eval())


def test_synthetic_jpeg_dataset_equals_jax(tmp_path):
    kw = dict(n=3, image_size=(40, 56), seed=2)
    want = jax_synthetic.SyntheticJpegDetection(str(tmp_path / "jax"), **kw)
    got = port_synthetic.SyntheticJpegDetection(str(tmp_path / "port"), **kw)
    for i in range(3):
        assert_same(got[i], want[i])
        assert_same(got.raw_item(i), want.raw_item(i))


# ---------- transforms ----------

def _sample(seed, h=48, w=64, n=3, k=4):
    """A uint8 image with boxes, labels, masks and keypoints."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    x0 = rng.uniform(0, w / 2, n)
    y0 = rng.uniform(0, h / 2, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, w / 2, n),
                      y0 + rng.uniform(4, h / 2, n)], 1).astype(np.float32)
    masks = (rng.random((n, h, w)) < 0.3).astype(np.uint8)
    kps = np.concatenate([rng.uniform(0, min(h, w), (n, k, 2)),
                          rng.integers(0, 3, (n, k, 1))], 2).astype(np.float32)
    return img, {"boxes": boxes, "labels": np.arange(1, n + 1, dtype=np.int64),
                 "masks": masks, "keypoints": kps, "image_id": seed}


_TRANSFORMS = {
    "hflip": lambda T: T.RandomHorizontalFlip(p=0.5),
    "to_float": lambda T: T.ToFloat(),
    "resize": lambda T: T.Resize((40, 30)),
    "resize_shortest_edge": lambda T: T.ResizeShortestEdge(32, 50),
    "iou_crop": lambda T: T.RandomIoUCrop(),
    "zoom_out": lambda T: T.RandomZoomOut(fill=[123.0, 117.0, 104.0]),
    "photometric": lambda T: T.RandomPhotometricDistort(),
    "compose": lambda T: T.Compose([T.RandomPhotometricDistort(),
                                    T.RandomZoomOut(), T.RandomIoUCrop(),
                                    T.RandomHorizontalFlip()]),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_transform_equals_jax(name):
    want_tf, got_tf = _TRANSFORMS[name](jax_T), _TRANSFORMS[name](port_T)
    for seed in range(6):
        img, target = _sample(seed)
        want = want_tf(img.copy(), dict(target), np.random.default_rng(seed))
        got = got_tf(img.copy(), dict(target), np.random.default_rng(seed))
        assert_same(got, want)


def test_keypoint_and_mask_helpers_equal_jax():
    _, t = _sample(7)
    kps, masks = t["keypoints"], t["masks"]
    assert_same(port_T._flip_keypoints(kps, 64), jax_T._flip_keypoints(kps, 64))
    assert_same(port_T._scale_keypoints(kps, 0.5, 1.5),
                jax_T._scale_keypoints(kps, 0.5, 1.5))
    for nh, nw in ((20, 30), (96, 128)):
        assert_same(port_T._resize_masks(masks, nh, nw),
                    jax_T._resize_masks(masks, nh, nw))


@pytest.mark.parametrize("policy", ["hflip", "ssd"])
def test_presets_equal_jax(policy):
    want_tf = jax_presets.DetectionPresetTrain(policy)
    got_tf = port_presets.DetectionPresetTrain(policy)
    for seed in range(6):
        img, target = _sample(seed)
        assert_same(got_tf(img, target, np.random.default_rng(seed)),
                    want_tf(img, target, np.random.default_rng(seed)))
    img, target = _sample(0)
    assert_same(port_presets.DetectionPresetEval()(img, target),
                jax_presets.DetectionPresetEval()(img, target))
    with pytest.raises(ValueError, match="Unknown"):
        port_presets.DetectionPresetTrain("nope")


# ---------- aspect-ratio groups ----------

def test_aspect_ratio_groups_equal_jax():
    ds_w = jax_synthetic.SyntheticDetection(n=40, image_size=(60, 80),
                                            variable_size=True, seed=4)
    ds_g = port_synthetic.SyntheticDetection(n=40, image_size=(60, 80),
                                             variable_size=True, seed=4)
    assert_same(port_groups.compute_aspect_ratios(ds_g),
                jax_groups.compute_aspect_ratios(ds_w))
    assert_same(port_groups.compute_aspect_ratios(ds_g, [3, 1, 7]),
                jax_groups.compute_aspect_ratios(ds_w, [3, 1, 7]))
    for k in range(4):
        ids_w = jax_groups.create_aspect_ratio_groups(ds_w, k=k)
        ids_g = port_groups.create_aspect_ratio_groups(ds_g, k=k)
        assert_same(ids_g, ids_w)
        for shuffle in (True, False):
            s_w = jax_groups.GroupedBatchSampler(ids_w, 4, shuffle, seed=k)
            s_g = port_groups.GroupedBatchSampler(ids_g, 4, shuffle, seed=k)
            for epoch in range(3):
                s_w.set_epoch(epoch)
                s_g.set_epoch(epoch)
                assert len(s_g) == len(s_w)
                assert_same(list(s_g), list(s_w))
