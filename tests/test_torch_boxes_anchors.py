"""Port vs JAX package: anchors and box geometry (demonet_tpu_torch.ops.boxes,
demonet_tpu_torch.models.anchors).

Anchors, IoU, clipping and the box conversions must be bit-equal: they
are the same f32 arithmetic in the same order. `decode_boxes` goes
through `exp`, whose last ulps differ between the two frameworks' math
libraries, so it is held to rtol 1e-6 and atol 1e-4 px.
"""

import numpy as np
import pytest
import torch

from demonet_tpu.models import anchors as jax_anchors
from demonet_tpu.ops import boxes as jax_boxes
from demonet_tpu_torch.models import anchors as port_anchors
from demonet_tpu_torch.models.builders import (
    feature_grid_sizes,
    ssdlite320_mobilenet_v3_large,
)
from demonet_tpu_torch.ops import boxes as port_boxes

_RATIOS = [[2, 3]] * 6


def _random_boxes(rng, shape, scale=320.0):
    xy = rng.random((*shape, 2)).astype(np.float32) * scale
    wh = rng.random((*shape, 2)).astype(np.float32) * scale / 3
    return np.concatenate([xy - wh / 2, xy + wh / 2], -1)


@pytest.mark.parametrize("size,n_anchors", [((320, 320), 3234),
                                            ((64, 64), 144)])
def test_default_boxes_bit_equal(size, n_anchors):
    det = ssdlite320_mobilenet_v3_large(num_classes=5, size=size,
                                        device="cpu")
    grids = feature_grid_sizes(det.model.extractor, size)
    want = jax_anchors.default_boxes(grids, size, _RATIOS, min_ratio=0.2,
                                     max_ratio=0.95)
    assert det.anchors.shape == (n_anchors, 4)
    assert det.anchors.dtype == np.float32
    np.testing.assert_array_equal(det.anchors, want)
    got = port_anchors.default_boxes(grids, size, _RATIOS, steps=[8] * 6)
    np.testing.assert_array_equal(got, jax_anchors.default_boxes(
        grids, size, _RATIOS, steps=[8] * 6))


@pytest.mark.parametrize("size", [(320, 320), (64, 64), (50, 70)])
def test_grid_sizes_match_forward(size):
    det = ssdlite320_mobilenet_v3_large(num_classes=5, size=(64, 64),
                                        device="cpu")
    extractor = det.model.extractor
    with torch.no_grad():
        maps = extractor(torch.zeros((1, 3, *size)))
    assert [tuple(m.shape[2:]) for m in maps] == feature_grid_sizes(
        extractor, size)


def test_box_iou_and_area_bit_equal():
    rng = np.random.default_rng(0)
    b1 = _random_boxes(rng, (3, 40))
    b2 = _random_boxes(rng, (3, 50))
    b2[0, :5] = b1[0, :5]                      # identical pairs: IoU 1
    b2[1, :3] = [[5, 5, 5, 9], [0, 0, 0, 0], [1, 1, 0.5, 0.5]]  # degenerate
    iou_j, union_j = jax_boxes.box_iou(b1, b2)
    iou_p, union_p = port_boxes.box_iou(torch.from_numpy(b1),
                                        torch.from_numpy(b2))
    np.testing.assert_array_equal(iou_p.numpy(), np.asarray(iou_j))
    np.testing.assert_array_equal(union_p.numpy(), np.asarray(union_j))
    np.testing.assert_array_equal(
        port_boxes.box_area(torch.from_numpy(b1)).numpy(),
        np.asarray(jax_boxes.box_area(b1)))


def test_clip_and_conversions_bit_equal():
    rng = np.random.default_rng(1)
    b = _random_boxes(rng, (2, 100), scale=500.0) - 90.0
    np.testing.assert_array_equal(
        port_boxes.clip_boxes_to_image(torch.from_numpy(b), (64, 96)).numpy(),
        np.asarray(jax_boxes.clip_boxes_to_image(b, (64, 96))))
    np.testing.assert_array_equal(
        port_boxes.box_xyxy_to_cxcywh(torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_xyxy_to_cxcywh(b)))
    np.testing.assert_array_equal(
        port_boxes.box_cxcywh_to_xyxy(torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_cxcywh_to_xyxy(b)))


def test_decode_boxes_close():
    rng = np.random.default_rng(2)
    anchors = _random_boxes(rng, (300,))
    deltas = rng.normal(0, 2, (2, 300, 4)).astype(np.float32)
    deltas[0, :4, 2:] = 40.0                   # past the log(1000/16) clamp
    want = np.asarray(jax_boxes.decode_boxes(deltas, anchors[None]))
    got = port_boxes.decode_boxes(torch.from_numpy(deltas),
                                  torch.from_numpy(anchors)[None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
