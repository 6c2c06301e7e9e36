"""Port vs JAX package: DetectionLoader (demonet_tpu_torch/data/loader.py).

For the same dataset, seed, epoch and index the port's loader must give
the JAX loader's batches bit for bit: images, gt, sizes, ids and
batch_valid, under both augmentation policies, both image dtypes, with
keypoints and masks, with a grouped batch sampler and sharding, and from
the spawn worker pool as from the prefetch thread. numpy only: no model
is built.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from demonet_tpu.data import presets as jax_presets
from demonet_tpu.data import synthetic as jax_synthetic
from demonet_tpu.data.group_by_aspect_ratio import (
    GroupedBatchSampler as JaxGroupedBatchSampler,
)
from demonet_tpu.data.loader import DetectionLoader as JaxLoader
from demonet_tpu_torch.data import presets as port_presets
from demonet_tpu_torch.data import synthetic as port_synthetic
from demonet_tpu_torch.data.group_by_aspect_ratio import (
    GroupedBatchSampler,
    create_aspect_ratio_groups,
)
from demonet_tpu_torch.data.loader import DetectionLoader, _sample_rng

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _datasets(policy="ssd", n=10, variable_size=True, size=(64, 64)):
    """(JAX, port) synthetic datasets with the same arguments."""
    kw = dict(n=n, image_size=size, num_classes=5, seed=1,
              variable_size=variable_size)
    return (jax_synthetic.SyntheticDetection(
                transforms=jax_presets.DetectionPresetTrain(policy), **kw),
            port_synthetic.SyntheticDetection(
                transforms=port_presets.DetectionPresetTrain(policy), **kw))


def _collect(loader, epochs=(0,)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.extend({k: v.copy() for k, v in b.items()} for b in loader)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("policy", ["hflip", "ssd"])
def test_batches_equal_jax(policy, image_dtype):
    ds_w, ds_g = _datasets(policy)
    kw = dict(batch_size=4, image_size=(64, 64), shuffle=True, seed=7,
              max_gt=6, image_dtype=image_dtype)
    want = _collect(JaxLoader(ds_w, **kw), epochs=(0, 1))
    got = _collect(DetectionLoader(ds_g, **kw), epochs=(0, 1))
    _assert_batches_equal(got, want)
    assert got[-1]["batch_valid"].tolist() == [True, True, False, False]
    assert got[0]["images"].dtype == np.dtype(image_dtype)


def test_sample_stream_is_the_jax_stream():
    from demonet_tpu.data.loader import _sample_rng as jax_sample_rng

    for args in ((0, 0, 0), (7, 3, 11), (2**31, 5, 1)):
        np.testing.assert_array_equal(_sample_rng(*args).random(8),
                                      jax_sample_rng(*args).random(8))


@pytest.mark.parametrize("kw", [
    {"drop_last": True}, {"pad_last_batch": False}, {"prefetch": 0},
    {"num_shards": 2, "shard_index": 1, "shuffle": True},
    {"num_shards": 3, "shard_index": 0},
], ids=["drop_last", "no_pad", "no_prefetch", "shard_1_of_2", "shard_0_of_3"])
def test_index_streams_equal_jax(kw):
    ds_w, ds_g = _datasets("hflip", n=11, variable_size=False)
    base = dict(batch_size=3, image_size=(64, 64), seed=2)
    want_ld, got_ld = JaxLoader(ds_w, **base, **kw), \
        DetectionLoader(ds_g, **base, **kw)
    assert len(got_ld) == len(want_ld)
    _assert_batches_equal(_collect(got_ld, (0, 1)), _collect(want_ld, (0, 1)))


@pytest.mark.parametrize("shards", [1, 2])
def test_grouped_batch_sampler_batches_equal_jax(shards):
    ds_w, ds_g = _datasets("ssd", n=14)
    ids = create_aspect_ratio_groups(ds_g, k=1)
    for shard in range(shards):
        kw = dict(batch_size=3, image_size=(64, 64), seed=5,
                  num_shards=shards, shard_index=shard)
        want = JaxLoader(ds_w, batch_sampler=JaxGroupedBatchSampler(
            ids, 3, seed=5), **kw)
        got = DetectionLoader(ds_g, batch_sampler=GroupedBatchSampler(
            ids, 3, seed=5), **kw)
        assert len(got) == len(want)
        _assert_batches_equal(_collect(got, (0, 1)), _collect(want, (0, 1)))


class KeypointFrames:
    """Variable-size float frames with per-instance keypoints and masks
    (the layout of tests/test_loader.py's keypoint dataset)."""

    def __init__(self, n=6, k=5):
        self.n, self.k = n, k

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        h, w = int(rng.integers(60, 100)), int(rng.integers(60, 100))
        img = rng.random((h, w, 3)).astype(np.float32)
        m = int(rng.integers(1, 4))
        boxes, kps, masks = [], [], []
        for _ in range(m):
            x1, y1 = rng.uniform(0, w * 0.4), rng.uniform(0, h * 0.4)
            x2 = min(x1 + rng.uniform(w * 0.2, w * 0.5), w)
            y2 = min(y1 + rng.uniform(h * 0.2, h * 0.5), h)
            boxes.append([x1, y1, x2, y2])
            kps.append(np.stack([np.linspace(x1, x2, self.k),
                                 np.linspace(y1, y2, self.k),
                                 np.full(self.k, 2.0)], axis=1))
            mask = np.zeros((h, w), np.uint8)
            mask[int(y1):int(y2), int(x1):int(x2)] = 1
            masks.append(mask)
        return img, {"boxes": np.asarray(boxes, np.float32),
                     "labels": np.ones(m, np.int64),
                     "keypoints": np.asarray(kps, np.float32),
                     "masks": np.stack(masks), "image_id": idx + 1}


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
def test_keypoint_and_mask_batches_equal_jax(image_dtype):
    ds = KeypointFrames()
    kw = dict(batch_size=4, image_size=(64, 64), max_gt=4, max_kp=5,
              with_masks=True, seed=3, image_dtype=image_dtype)
    want = _collect(JaxLoader(ds, **kw))
    got = _collect(DetectionLoader(ds, **kw))
    _assert_batches_equal(got, want)
    assert got[0]["gt_keypoints"].shape == (4, 4, 5, 3)
    assert got[0]["gt_masks"].shape == (4, 4, 64, 64)


def test_two_worker_pool_equals_serial_and_jax():
    """The spawn pool (shared-memory slab, ordered results) gives the
    serial batches, which are the JAX loader's."""
    ds_w, ds_g = _datasets("ssd", n=10)
    kw = dict(batch_size=3, image_size=(64, 64), shuffle=True, seed=9)
    want = _collect(JaxLoader(ds_w, prefetch=0, **kw))
    serial = _collect(DetectionLoader(ds_g, prefetch=0, **kw))
    pooled = _collect(DetectionLoader(ds_g, num_workers=2, **kw))
    _assert_batches_equal(serial, want)
    _assert_batches_equal(pooled, want)


def test_native_decode_is_not_ported():
    _, ds = _datasets()
    with pytest.raises(NotImplementedError, match="8b"):
        DetectionLoader(ds, batch_size=2, image_size=(64, 64),
                        native_decode=True)
    with pytest.raises(ValueError, match="image_dtype"):
        DetectionLoader(ds, batch_size=2, image_size=(64, 64),
                        image_dtype="float16")


def test_frames_at_the_network_size_load_without_cv2():
    """With cv2 absent, hflip batches of frames at the network size load;
    a frame that needs a resize raises ImportError."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "from demonet_tpu_torch.data.loader import DetectionLoader\n"
        "from demonet_tpu_torch.data.presets import DetectionPresetTrain\n"
        "from demonet_tpu_torch.data.synthetic import SyntheticDetection\n"
        "tf = DetectionPresetTrain('hflip')\n"
        "ds = SyntheticDetection(n=4, image_size=(64, 64), transforms=tf)\n"
        "b = next(iter(DetectionLoader(ds, 4, (64, 64))))\n"
        "assert b['batch_valid'].all()\n"
        "ld = DetectionLoader(ds, 4, (32, 32), prefetch=0)\n"
        "try:\n"
        "    next(iter(ld))\n"
        "except ImportError:\n"
        "    print('resize needs cv2')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "resize needs cv2"
