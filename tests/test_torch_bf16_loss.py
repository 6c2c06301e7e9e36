"""Port vs JAX package: the MultiBox loss on bfloat16 logits and deltas
(models/losses.py against demonet_tpu/models/losses.py:79-121, jitted, as
the JAX train step compiles it).

Two cases, each with more than 256 positives (N rounds in bf16) and
ground-truth coordinates above 256 px (bf16 rounds them to 2 px):

  * "grid": 10,800 anchors on a 512-px grid, 36-37 gt boxes an image,
    logits on a grid of quarters so that many negatives tie in CE at the
    mining cut;
  * "model": the JAX flagship's own bf16 head outputs (dtype=bfloat16,
    320x320, numpy-drawn variables) for two frames, 40 gt boxes each.

Both losses take the JAX matching (`matched_idxs`): with 36-40
overlapping gt boxes an image, two gts can share their best anchor, and
the JAX matcher's scatter then keeps an unspecified one
(demonet_tpu/models/matcher.py, `ssd_match`'s note); that is no part of
the bf16 flow. What is held, and how closely:

  * the loss terms: bit-equal (the regression term, float32, within one
    float32 ulp: its sum runs in another order), so within the 1 bf16
    ulp asked;
  * the per-anchor CE (bf16) and the mined negatives: bit-equal. The CE needs `losses.logsumexp`, which keeps the exponentials
    in float32 inside the sum as XLA's fusion does; torch's logsumexp,
    which rounds each to bf16, moves 1 CE in 50 by an ulp and with it
    the cut;
  * the regression targets come from bf16-rounded gt boxes and N is the
    bf16-rounded count, as in JAX: the float32 versions give other
    losses.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu.models.losses import match_batch as jax_match_batch
from demonet_tpu.models.losses import multibox_loss as jax_loss
from demonet_tpu_torch.models.losses import (
    classification_terms,
    logsumexp,
    multibox_loss,
)
from tests import torch_parity as tp

_BF16 = jnp.bfloat16


def _grid_case():
    rng = np.random.default_rng(0)
    centres = (np.arange(60) + 0.5) * 512 / 60
    cx, cy = np.meshgrid(centres, centres)
    anchors = np.concatenate([
        np.stack([cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2],
                 -1).reshape(-1, 4) for w in (20, 40, 80)]).astype(np.float32)
    b, g, c = 2, 40, 21
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(36 + i):
            x0, y0 = rng.uniform(200, 400, 2)
            w, h = rng.uniform(30, 110, 2)
            boxes[i, j] = [x0, y0, x0 + w, y0 + h]
            labels[i, j] = rng.integers(1, c)
            valid[i, j] = True
    a = anchors.shape[0]
    logits = np.round(rng.normal(0, 1, (b, a, c)) * 4) / 4
    deltas = rng.normal(0, 0.5, (b, a, 4))
    return (anchors, jnp.asarray(logits, _BF16), jnp.asarray(deltas, _BF16),
            boxes, labels, valid)


def _model_case():
    jd = jax_ssdlite(num_classes=21, dtype=_BF16)
    variables = tp.jax_variables(jd.init)
    x = (tp.images(2, (320, 320), b=2) - 0.5) / 0.5
    out = jax.jit(jd.apply)(variables, x)
    rng = np.random.default_rng(1)
    b, g = 2, 40
    xy = rng.uniform(0, 260, (b, g, 2))
    wh = rng.uniform(20, 120, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 320)], -1)
    labels = rng.integers(1, 21, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    return (np.asarray(jd.anchors), out["cls_logits"], out["bbox_regression"],
            boxes.astype(np.float32), labels, valid)


@pytest.fixture(scope="module", params=["grid", "model"])
def case(request):
    anchors, logits, deltas, boxes, labels, valid = (
        _grid_case() if request.param == "grid" else _model_case())
    assert logits.dtype == deltas.dtype == _BF16
    matched = np.asarray(jax.jit(jax_match_batch)(
        jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(valid)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    bf = lambda a: t(a.astype(jnp.float32)).to(torch.bfloat16)  # noqa: E731
    return {"name": request.param, "jax": (logits, deltas),
            "torch": (bf(logits), bf(deltas)), "anchors": anchors,
            "gt": (boxes, labels, valid), "matched": matched,
            "t": t}


def _jax_terms(cls_logits, matched, gt_labels, ratio=3.0):
    """Per-anchor CE and the mined negatives, demonet_tpu/models/losses.py
    :81-117 line for line (the function keeps them inside)."""
    b, a, num_classes = cls_logits.shape
    g = gt_labels.shape[1]
    fg = matched >= 0
    num_fg = jnp.sum(fg, axis=1)
    select = jax.nn.one_hot(jnp.clip(matched, 0, g - 1), g,
                            dtype=cls_logits.dtype)
    labels = jnp.einsum("bag,bg->ba", select, gt_labels.astype(jnp.float32),
                        preferred_element_type=jnp.float32
                        ).astype(gt_labels.dtype)
    targets = jnp.where(fg, labels, 0)
    logz = jax.nn.logsumexp(cls_logits, axis=-1)
    onehot = jax.nn.one_hot(targets, num_classes, dtype=cls_logits.dtype)
    ce = logz - jnp.einsum("bac,bac->ba", cls_logits, onehot)
    neg = jnp.where(fg, -jnp.inf, ce)
    order = jnp.argsort(-neg, axis=1)
    rank = jnp.argsort(order, axis=1).astype(jnp.int32)
    return ce, rank < (ratio * num_fg)[:, None]


def test_bf16_case_has_what_it_must(case):
    """More than 256 positives, gt coordinates that bf16 rounds, and (on
    the grid) negatives tied in CE at the mining cut, inside and outside
    the mined set."""
    boxes, _, valid = case["gt"]
    assert (case["matched"] >= 0).sum() > 256
    big = boxes[valid][boxes[valid] >= 256]
    assert big.size and np.any(np.asarray(jnp.asarray(big, _BF16)
                                          .astype(jnp.float32)) != big)
    if case["name"] == "grid":
        t = case["t"]
        ce, fg, bg = classification_terms(case["torch"][0],
                                          t(case["matched"]).long(),
                                          t(case["gt"][1]))
        for i in range(ce.shape[0]):
            cut = ce[i][bg[i]].min()
            tied_out = (ce[i] == cut) & ~bg[i] & ~fg[i]
            assert int(tied_out.sum()) > 0 and int(
                ((ce[i] == cut) & bg[i]).sum()) > 0


def test_bf16_loss_terms_equal_jax(case):
    t = case["t"]
    boxes, labels, valid = case["gt"]
    want = jax.jit(jax_loss)(*case["jax"], jnp.asarray(case["anchors"]),
                             boxes, labels, valid,
                             matched_idxs=jnp.asarray(case["matched"]))
    got = multibox_loss(*case["torch"], t(case["anchors"]), t(boxes),
                        t(labels), t(valid),
                        matched_idxs=t(case["matched"]).long())
    assert want["classification"].dtype == _BF16
    assert got["classification"].dtype == torch.bfloat16
    assert got["bbox_regression"].dtype == torch.float32
    assert float(got["classification"]) == float(want["classification"])
    w = np.float32(want["bbox_regression"])
    assert abs(np.float32(got["bbox_regression"].item()) - w) <= np.spacing(w)


def test_bf16_ce_and_mined_negatives_bit_equal(case):
    t = case["t"]
    ce_j, bg_j = jax.jit(_jax_terms)(case["jax"][0],
                                     jnp.asarray(case["matched"]),
                                     jnp.asarray(case["gt"][1]))
    ce, _, bg = classification_terms(case["torch"][0],
                                     t(case["matched"]).long(),
                                     t(case["gt"][1]))
    assert ce.dtype == torch.bfloat16
    np.testing.assert_array_equal(ce.float().numpy(),
                                  np.asarray(ce_j.astype(jnp.float32)))
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_j))


def test_bf16_logsumexp_equals_xla():
    """`losses.logsumexp` bit-equal to the compiled `jax.nn.logsumexp`
    on bf16 rows (ties, large and small logits), where torch's own
    logsumexp is not."""
    rng = np.random.default_rng(5)
    x = (np.round(rng.normal(0, 1, (4000, 21)) * 4) / 4
         + rng.normal(0, 0.3, (4000, 21)))
    x[:10] *= 40.0
    xj = jnp.asarray(x, _BF16)
    want = np.asarray(jax.jit(functools.partial(
        jax.nn.logsumexp, axis=-1))(xj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    got = logsumexp(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.array_equal(
        torch.logsumexp(xt, dim=-1).float().numpy(), want)


def test_bf16_rounding_of_gt_and_count_matters(case):
    """The JAX package's bf16 rounding of the gt boxes and of N is part of
    its loss: with float32 logits (gt boxes and N in float32) the
    regression term on the same deltas differs."""
    t = case["t"]
    boxes, labels, valid = case["gt"]
    matched = t(case["matched"]).long()
    got = multibox_loss(*case["torch"], t(case["anchors"]), t(boxes),
                        t(labels), t(valid), matched_idxs=matched)
    f32 = multibox_loss(case["torch"][0].float(), case["torch"][1],
                        t(case["anchors"]), t(boxes), t(labels), t(valid),
                        matched_idxs=matched)
    assert float(got["bbox_regression"]) != float(f32["bbox_regression"])
