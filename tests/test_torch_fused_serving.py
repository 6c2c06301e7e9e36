"""Port vs JAX package: the fused serving postprocess
(`postprocess_detections(impl="fused")`, detection._postprocess_fused).

The same seeded logits, box deltas and anchors go through the JAX
package's fused path (nms_impl and gather_impl "xla") and the port's, on
the CPU, where the port's NMS and gathers run their plain versions. The
cases are those of tests/test_postprocess_fused.py. Tolerances: valid,
scores and labels bit-equal on every slot; boxes within 1e-4 px (they are
bit-equal on every case here, but the decode's `exp` may differ by an ulp
between the frameworks). The branch each batch takes (tier or fallback)
is read from the port's per-branch counter.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.models import detection as jax_det
from demonet_tpu.ops.boxes import box_cxcywh_to_xyxy
from demonet_tpu_torch.engine.evaluate import make_predict_step
from demonet_tpu_torch.models import detection as port_det


def _setup(seed=0, b=3, a=120, c=6, size=(64, 64), d=10):
    rng = np.random.default_rng(seed)
    cfg = jax_det.SSDConfig(size=size, num_classes=c, score_thresh=0.01,
                            nms_thresh=0.5, detections_per_img=d,
                            topk_candidates=20)
    cxy = rng.random((a, 2)) * 48 + 8
    wh = rng.random((a, 2)) * 24 + 4
    anchors = np.array(box_cxcywh_to_xyxy(
        jnp.asarray(np.concatenate([cxy, wh], 1), jnp.float32)))
    deltas = rng.normal(0, 0.4, (b, a, 4)).astype(np.float32)
    logits = np.zeros((b, a, c), np.float32)
    logits[:, :, 0] = 8.0   # background everywhere: no detection yet
    return cfg, anchors, logits, deltas, rng


def _jax_fused(cfg, anchors, logits, deltas, sizes):
    fn = jax.jit(functools.partial(
        jax_det.postprocess_detections, config=cfg, nms_impl="xla",
        gather_impl="xla", impl="fused"))
    out = fn(jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors),
             original_sizes=None if sizes is None else jnp.asarray(sizes))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_fused(cfg, anchors, logits, deltas, sizes):
    """The port's fused detections and the branch the batch took."""
    counts = port_det._postprocess_fused.branches
    before = dict(counts)
    out = port_det.postprocess_detections(
        torch.from_numpy(logits), torch.from_numpy(deltas),
        torch.from_numpy(anchors),
        port_det.SSDConfig(**dataclasses.asdict(cfg)),
        None if sizes is None else torch.from_numpy(sizes), impl="fused")
    taken = [k for k in counts if counts[k] != before.get(k, 0)]
    assert len(taken) == 1 and counts[taken[0]] == before.get(taken[0], 0) + 1
    return {k: v.numpy() for k, v in out.items()}, taken[0]


def _assert_same(want, got):
    for key in ("valid", "scores", "labels"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["boxes"].shape == want["boxes"].shape
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-4)


def _run(cfg, anchors, logits, deltas, sizes=None):
    want = _jax_fused(cfg, anchors, logits, deltas, sizes)
    got, branch = _port_fused(cfg, anchors, logits, deltas, sizes)
    _assert_same(want, got)
    return want, branch


def _sparse(logits, rng):
    for bi in range(logits.shape[0]):
        for _ in range(6):
            logits[bi, rng.integers(0, 120), rng.integers(1, 6)] = 12.0


def _overlaps(logits, rng):
    """Runs on one class over neighbouring anchors so NMS suppresses."""
    for bi in range(logits.shape[0]):
        for k in range(12):
            logits[bi, k, 2] = 12.0 - 0.1 * k
        logits[bi, 60:66, 3] = 11.0


def _ties(logits, rng):
    """Equal logits: bit-equal scores across anchors and classes."""
    for bi in range(logits.shape[0]):
        logits[bi, [3, 40, 77], 1] = 12.0
        logits[bi, [10, 55], 4] = 12.0


def _rescale(logits, rng):
    for bi in range(logits.shape[0]):
        logits[bi, rng.integers(0, 120), 1] = 12.0


@pytest.mark.parametrize("seed,spikes,zero_deltas,sized", [
    (0, _sparse, False, False),
    (1, _overlaps, True, False),
    (2, _ties, True, False),
    (4, _rescale, False, True),
], ids=["sparse", "overlaps-need-nms", "exact-ties", "rescale"])
def test_fused_matches_jax_fused(seed, spikes, zero_deltas, sized):
    cfg, anchors, logits, deltas, rng = _setup(seed=seed)
    spikes(logits, rng)
    if zero_deltas:
        deltas = np.zeros_like(deltas)
    sizes = (np.asarray([[128, 256], [64, 64], [320, 160]], np.int32)
             if sized else None)
    want, branch = _run(cfg, anchors, logits, deltas, sizes)
    assert want["valid"].any()
    assert branch.startswith("tier_")


@pytest.mark.parametrize("a,branch", [(120, "tier_600"), (500, "fallback")],
                         ids=["fits-one-tier", "past-last-tier"])
def test_fused_dense(a, branch):
    """Uniform logits: every foreground score is live. With 5 * 120 = 600
    entries per image the whole row fits the one tier left after
    clamping; with 5 * 500 = 2,500 the batch exceeds the largest tier
    (2,048) and takes the reference pipeline."""
    cfg, anchors, logits, deltas, _ = _setup(seed=3, a=a)
    logits[:] = 0.0
    want, taken = _run(cfg, anchors, logits, deltas)
    assert taken == branch and want["valid"].any()


def test_fused_no_detections():
    cfg, anchors, logits, deltas, _ = _setup(seed=5)
    want, branch = _run(cfg, anchors, logits, deltas)
    assert not want["valid"].any() and branch.startswith("tier_")


@pytest.mark.parametrize("n_live,seed,branch", [
    (5, 7, "tier_10"), (12, 8, "tier_16"), (24, 9, "fallback"),
], ids=["tier0", "tier1", "past-last-tier"])
def test_fused_tier_selection(monkeypatch, n_live, seed, branch):
    """Tiers shrunk to (8, 16) on both sides; with 10 detections per
    image the first tier becomes 10."""
    monkeypatch.setattr(jax_det, "_FUSED_TIERS", (8, 16))
    monkeypatch.setattr(port_det, "_FUSED_TIERS", (8, 16))
    cfg, anchors, logits, deltas, rng = _setup(seed=seed)
    for bi in range(3):
        picks = rng.choice(120, size=n_live, replace=False)
        for k, anchor in enumerate(picks):
            logits[bi, anchor, 1 + k % 5] = 12.0 - 0.05 * k
    want, taken = _run(cfg, anchors, logits, deltas)
    assert want["valid"].any() and taken == branch


def test_fused_more_detections_than_candidates():
    """detections_per_img (100) above the candidate width (2 * 40): the
    output is padded."""
    cfg, anchors, logits, deltas, _ = _setup(seed=6, a=40, c=3, d=100)
    logits[0, 5, 1] = 12.0
    want, branch = _run(cfg, anchors, logits, deltas)
    assert want["boxes"].shape == (3, 100, 4) and want["valid"].sum() == 1
    assert branch == "tier_80"


def test_fused_ssdlite320_real_config():
    """ssdlite320_mobilenet_v3_large's own config and anchor grid
    (A = 3,234, 91 classes), two images with sparse spikes and a run of
    overlapping anchors on one class. The 91-way softmax differs by an ulp
    between the frameworks here, so both fused paths take the same
    softmaxed scores and decoded boxes (the JAX package's); given those,
    the fused path is gathers, sorts and comparisons, and bit-equal."""
    from demonet_tpu.models import get_model

    det = get_model("ssdlite320_mobilenet_v3_large")
    cfg, anchors = det.config, np.asarray(det.anchors, np.float32)
    a, c, b = anchors.shape[0], cfg.num_classes, 2
    assert (a, c) == (3234, 91)
    rng = np.random.default_rng(320)
    logits = np.zeros((b, a, c), np.float32)
    logits[:, :, 0] = 8.0
    for bi in range(b):
        for _ in range(8):
            logits[bi, rng.integers(0, a), rng.integers(1, c)] = 12.0
        base = int(rng.integers(0, a - 6))
        logits[bi, base:base + 6, 1 + bi] = 11.0
    deltas = rng.normal(0, 0.2, (b, a, 4)).astype(np.float32)
    sizes = np.asarray([[480, 640], [333, 500]], np.int32)
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    boxes = np.array(jax_det.clip_boxes_to_image(jax_det.decode_boxes(
        jnp.asarray(deltas), jnp.asarray(anchors)[None],
        cfg.box_coder_weights), cfg.size))
    fused = jax.jit(functools.partial(
        jax_det._postprocess_fused, config=cfg, nms_impl="xla",
        gather_impl="xla"))
    want = {k: np.asarray(v) for k, v in fused(
        jnp.asarray(scores), jnp.asarray(boxes),
        original_sizes=jnp.asarray(sizes)).items()}
    counts = port_det._postprocess_fused.branches
    before = counts["tier_1024"]
    got = port_det._postprocess_fused(
        torch.from_numpy(scores), torch.from_numpy(boxes),
        port_det.SSDConfig(**dataclasses.asdict(cfg)),
        torch.from_numpy(sizes), "auto", "auto")
    assert counts["tier_1024"] == before + 1
    assert want["valid"].any()
    for key in ("valid", "scores", "labels", "boxes"):
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)


def test_fused_predict_step_counts_its_branch():
    """make_predict_step(impl="fused") reaches the fused path."""
    from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large

    det = ssdlite320_mobilenet_v3_large(num_classes=5, size=(64, 64),
                                        device="cpu", seed=0)
    images = torch.from_numpy(
        np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3)).astype(
            np.uint8))
    counts = port_det._postprocess_fused.branches
    before = sum(counts.values())
    got = make_predict_step(det, impl="fused")(det.model, images)
    want = make_predict_step(det)(det.model, images)
    assert sum(counts.values()) == before + 1
    for key in want:
        assert torch.equal(got[key], want[key]), key
