"""Port vs JAX package: the pieces of the training path, on the same numpy
inputs made from a seed. Tolerances:

  * bit-equal where the arithmetic is the same: smooth-L1, IoU matching
    (ssd_match with its forced assignments, the duplicate-best-anchor
    case included, and match), the hard-negative mask given the same
    logits, the LR schedule at every step;
  * encode_boxes: dx, dy bit-equal; dw, dh within 2 ulps (float32 `log`
    differs by an ulp between the two math libraries);
  * the MultiBox loss given the same logits: rtol 2e-6 (reductions sum in
    another order); its gradients: atol 1e-7 + rtol 1e-5;
  * BatchNorm in train mode: outputs atol 1e-5, running statistics atol
    1e-6 (the batch mean is summed in another order);
  * one SGD update against the JAX package's optimizer: rtol 1e-6 (torch
    fuses a multiply-add the JAX package rounds twice).
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from demonet_tpu.engine.state import make_lr_schedule as jax_schedule
from demonet_tpu.engine.state import make_optimizer as jax_optimizer
from demonet_tpu.models import losses as jax_losses
from demonet_tpu.models import matcher as jax_matcher
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu.ops.boxes import encode_boxes as jax_encode
from demonet_tpu.utils import freeze as jax_freeze
from demonet_tpu_torch.engine.state import (
    SGD,
    make_lr_schedule,
    make_optimizer,
)
from demonet_tpu_torch.models import losses, matcher
from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
from demonet_tpu_torch.models.layers import BatchNorm, ConvBNAct
from demonet_tpu_torch.ops.boxes import encode_boxes
from demonet_tpu_torch.parallel import dist
from demonet_tpu_torch.utils import freeze
from demonet_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from demonet_tpu_torch.utils.metrics_writer import MetricsWriter
from demonet_tpu_torch.utils.weights import torch_name


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---- encode_boxes, smooth_l1 -------------------------------------------

def test_encode_boxes_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.random((400, 2)) * 300
    anchors = np.concatenate([xy, xy + 1 + rng.random((400, 2)) * 60],
                             1).astype(np.float32)
    gxy = rng.random((3, 400, 2)) * 300
    gt = np.concatenate([gxy, gxy + rng.random((3, 400, 2)) * 60],
                        -1).astype(np.float32)
    gt[0, :50] = 0.0     # padded rows: the 1e-8 guards keep them finite
    want = np.asarray(jax_encode(jnp.asarray(gt), jnp.asarray(anchors)[None]))
    got = encode_boxes(_t(gt), _t(anchors)[None]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    assert _ulps(got[..., 2:], want[..., 2:]).max() <= 2


def test_smooth_l1_bit_equal():
    x = np.concatenate([[-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0],
                        np.random.default_rng(1).normal(0, 2, 500)]
                       ).astype(np.float32)
    for beta in (1.0, 0.5):
        want = np.asarray(jax_losses.smooth_l1(jnp.asarray(x), beta))
        np.testing.assert_array_equal(
            losses.smooth_l1(_t(x), beta).numpy(), want)


# ---- matching ---------------------------------------------------------

_MATCH_CASES = {
    # the cases of tests/test_matcher.py
    "basic_threshold": ([[0.9, 0.3, 0.0], [0.1, 0.6, 0.2]], None,
                        [0, 1, -1]),
    "force_best_overrides_threshold": ([[0.9, 0.8, 0.0], [0.0, 0.1, 0.3]],
                                       None, [0, 0, 1]),
    "padded_gt_ignored": ([[0.9, 0.3, 0.0], [0.99, 0.99, 0.99]],
                          [True, False], [0, -1, -1]),
    "empty_gt": ([[0.0] * 5] * 3, [False] * 3, [-1] * 5),
    # two gts share a best anchor: the last one wins, as in JAX on the CPU
    "duplicate_best_anchor": ([[0.9, 0.1, 0.2], [0.8, 0.05, 0.1]], None,
                              [1, -1, -1]),
    "duplicate_best_three_gts": ([[0.6, 0.1, 0.0], [0.7, 0.2, 0.0],
                                  [0.3, 0.1, 0.0]], [True, True, True],
                                 [2, -1, -1]),
    "duplicate_best_last_padded": ([[0.9, 0.1, 0.2], [0.8, 0.05, 0.1]],
                                   [True, False], [0, -1, -1]),
    "all_padded": ([[0.9, 0.6, 0.7], [0.8, 0.9, 0.1]], [False, False],
                   [-1, -1, -1]),
}


@pytest.mark.parametrize("case", sorted(_MATCH_CASES))
def test_ssd_match_cases_equal_jax(case):
    q, valid, expect = _MATCH_CASES[case]
    q = np.asarray(q, np.float32)
    v = None if valid is None else np.asarray(valid)
    want = np.asarray(jax_matcher.ssd_match(
        jnp.asarray(q), 0.5, None if v is None else jnp.asarray(v)))
    got = matcher.ssd_match(_t(q), 0.5, None if v is None else _t(v))
    assert got.tolist() == want.tolist() == expect


def test_ssd_match_real_boxes():
    anchors = np.asarray([[0, 0, 10, 10], [0, 0, 20, 20], [50, 50, 60, 60]],
                         np.float32)
    gt = np.asarray([[[1, 1, 11, 11]]], np.float32)
    got = losses.match_batch(_t(anchors), _t(gt), torch.ones(1, 1, dtype=bool))
    want = np.asarray(jax_losses.match_batch(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.ones((1, 1), bool)))
    assert got.tolist() == want.tolist()
    assert got[0, 0] == 0 and got[0, 2] == -1


@pytest.mark.parametrize("q,high,low,low_quality,expect", [
    ([[0.9, 0.45, 0.2]], 0.7, 0.3, False, [0, -2, -1]),
    ([[0.2, 0.1]], 0.7, 0.3, True, [0, -1]),
    ([[0.2, 0.8, 0.2], [0.25, 0.1, 0.25]], 0.7, 0.3, True, [1, 0, 1]),
], ids=["between_thresholds", "low_quality_restore", "restore_ties"])
def test_generic_match_equals_jax(q, high, low, low_quality, expect):
    q = np.asarray(q, np.float32)
    want = np.asarray(jax_matcher.match(jnp.asarray(q), high, low,
                                        low_quality))
    got = matcher.match(_t(q), high, low, low_quality)
    assert got.tolist() == want.tolist() == expect


def test_match_batch_on_ssdlite_anchors_equals_jax():
    """Random gt (some rows padded, one image all padding) against the
    144 anchors of ssdlite320 at 64x64: the IoU and every forced
    assignment bit-equal."""
    anchors = ssdlite320_mobilenet_v3_large(num_classes=4, size=(64, 64),
                                            device="cpu").anchors
    rng = np.random.default_rng(2)
    xy = rng.random((4, 6, 2)) * 48
    gt = np.concatenate([xy, xy + 4 + rng.random((4, 6, 2)) * 30],
                        -1).astype(np.float32)
    valid = rng.random((4, 6)) < 0.7
    valid[3] = False
    want = np.asarray(jax_losses.match_batch(
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid)))
    got = losses.match_batch(_t(anchors), _t(gt), _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 4 and (want[3] == -1).all()


def test_balanced_sampler_counts():
    labels = torch.tensor([1] * 10 + [0] * 30 + [-1] * 5)
    gen = torch.Generator().manual_seed(0)
    pos, neg = matcher.balanced_sampler(gen, labels, 16, 0.25)
    assert int(pos.sum()) == 4 and int(neg.sum()) == 12
    assert bool((labels[pos] == 1).all()) and bool((labels[neg] == 0).all())
    few = torch.tensor([1, 0, 0, -1])
    pos, neg = matcher.balanced_sampler(gen, few, 16, 0.25)
    assert pos.tolist() == [True, False, False, False]
    assert neg.tolist() == [False, True, True, False]
    # the same generator state draws the same masks
    a = matcher.balanced_sampler(torch.Generator().manual_seed(5), labels,
                                 16, 0.25)
    b = matcher.balanced_sampler(torch.Generator().manual_seed(5), labels,
                                 16, 0.25)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- MultiBox loss ------------------------------------------------------

def _loss_case(name):
    """(cls_logits, bbox_reg, anchors, gt_boxes, gt_labels, gt_valid): the
    cases of tests/test_loss.py, and a random batch with ties in CE."""
    if name == "one_gt_one_empty_image":
        rng = np.random.RandomState(0)
        b, a, c, g = 2, 8, 4, 3
        anchors = np.asarray([[i * 12, 0, i * 12 + 10, 10] for i in range(a)],
                             np.float32)
        gt_boxes = np.zeros((b, g, 4), np.float32)
        gt_labels = np.zeros((b, g), np.int32)
        gt_valid = np.zeros((b, g), bool)
        gt_boxes[0, 0] = [12, 0, 22, 10]
        gt_labels[0, 0] = 2
        gt_valid[0, 0] = True
        cls = rng.randn(b, a, c).astype(np.float32)
        reg = (rng.randn(b, a, 4) * 0.1).astype(np.float32)
    elif name == "no_foreground":
        b, a, c, g = 1, 4, 3, 2
        anchors = np.asarray([[0, 0, 10, 10]] * a, np.float32)
        gt_boxes = np.zeros((b, g, 4), np.float32)
        gt_labels = np.zeros((b, g), np.int32)
        gt_valid = np.zeros((b, g), bool)
        cls = np.zeros((b, a, c), np.float32)
        reg = np.zeros((b, a, 4), np.float32)
    elif name == "differentiable":
        b, a, c = 1, 6, 3
        anchors = np.asarray([[i * 12.0, 0, i * 12 + 10, 10]
                              for i in range(a)], np.float32)
        gt_boxes = np.asarray([[[13.0, 1, 24, 10], [0, 0, 0, 0]]], np.float32)
        gt_labels = np.asarray([[1, 0]], np.int32)
        gt_valid = np.asarray([[True, False]])
        cls = np.full((b, a, c), 0.1, np.float32)
        reg = np.zeros((b, a, 4), np.float32)
    else:   # random boxes on a grid of anchors, CE rounded into ties
        rng = np.random.default_rng(3)
        b, c, g = 3, 5, 4
        cxy = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(
            -1, 2) * 8.0 + 4
        anchors = np.concatenate([cxy - 6, cxy + 6], 1).astype(np.float32)
        a = anchors.shape[0]
        xy = rng.random((b, g, 2)) * 40
        gt_boxes = np.concatenate([xy, xy + 8 + rng.random((b, g, 2)) * 16],
                                  -1).astype(np.float32)
        gt_labels = rng.integers(1, c, (b, g)).astype(np.int32)
        gt_valid = rng.random((b, g)) < 0.75
        gt_valid[:, 0] = True
        cls = (np.round(rng.normal(0, 1, (b, a, c)) * 4) / 4).astype(
            np.float32)
        reg = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    return cls, reg, anchors, gt_boxes, gt_labels, gt_valid


_LOSS_CASES = ["one_gt_one_empty_image", "no_foreground", "differentiable",
               "random_with_ce_ties"]


@jax.jit
def _jax_hard_negatives(cls, matched, gt_labels, ratio=3.0):
    """The JAX package's mining (demonet_tpu/models/losses.py:104-118) on
    the same logits, for the mask comparison."""
    fg = matched >= 0
    g = gt_labels.shape[1]
    sel = jax.nn.one_hot(jnp.clip(matched, 0, g - 1), g)
    lab = jnp.einsum("bag,bg->ba", sel, jnp.asarray(gt_labels, jnp.float32)
                     ).astype(jnp.int32)
    tgt = jnp.where(fg, lab, 0)
    ce = jax.nn.logsumexp(cls, -1) - jnp.einsum(
        "bac,bac->ba", cls, jax.nn.one_hot(tgt, cls.shape[-1]))
    neg = jnp.where(fg, -jnp.inf, ce)
    rank = jnp.argsort(jnp.argsort(-neg, axis=1), axis=1)
    return rank < (ratio * jnp.sum(fg, axis=1))[:, None]


_jax_loss = jax.jit(jax_losses.multibox_loss)
_jax_match = jax.jit(jax_losses.match_batch)


@pytest.mark.parametrize("case", _LOSS_CASES)
def test_multibox_loss_terms_equal_jax(case):
    cls, reg, anchors, gtb, gtl, gtv = _loss_case(case)
    want = _jax_loss(cls, reg, anchors, gtb, gtl, gtv)
    got = losses.multibox_loss(*map(_t, (cls, reg, anchors, gtb, gtl, gtv)))
    for key in ("bbox_regression", "classification"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-6, atol=0, err_msg=key)
    assert np.isfinite(float(got["classification"]))
    if case == "no_foreground":
        assert float(got["bbox_regression"]) == 0.0


@pytest.mark.parametrize("case", _LOSS_CASES)
def test_multibox_masks_bit_equal(case):
    cls, _, anchors, gtb, gtl, gtv = _loss_case(case)
    matched_j = np.asarray(_jax_match(anchors, gtb, gtv))
    matched = losses.match_batch(_t(anchors), _t(gtb), _t(gtv))
    np.testing.assert_array_equal(matched.numpy(), matched_j)
    _, fg, bg = losses.classification_terms(_t(cls), matched, _t(gtl))
    np.testing.assert_array_equal(fg.numpy(), matched_j >= 0)
    np.testing.assert_array_equal(
        bg.numpy(), np.asarray(_jax_hard_negatives(cls, matched_j, gtl)))


@pytest.mark.parametrize("case", _LOSS_CASES)
def test_multibox_gradients_equal_jax(case):
    cls, reg, anchors, gtb, gtl, gtv = _loss_case(case)
    fixed = tuple(map(jnp.asarray, (anchors, gtb, gtl, gtv)))

    def total(c, r):
        terms = jax_losses.multibox_loss(c, r, *fixed)
        return terms["bbox_regression"] + terms["classification"]

    g_cls, g_reg = jax.jit(jax.grad(total, argnums=(0, 1)))(cls, reg)
    c_t = _t(cls).requires_grad_()
    r_t = _t(reg).requires_grad_()
    terms = losses.multibox_loss(c_t, r_t, *map(_t, (anchors, gtb, gtl, gtv)))
    (terms["bbox_regression"] + terms["classification"]).backward()
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(g_cls),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(r_t.grad.numpy(), np.asarray(g_reg),
                               rtol=1e-5, atol=1e-7)
    if case == "differentiable":
        assert np.abs(r_t.grad.numpy()).sum() > 0


# ---- BatchNorm in train mode -------------------------------------------

def _bn_pair(c, rng):
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    bn = BatchNorm(c, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(_t(v))
    return variables, bn


@pytest.mark.parametrize("shape", [(2, 5, 5, 8), (1, 1, 1, 8), (2, 1, 1, 8),
                                   (4, 10, 10, 16)],
                         ids=["b2_5x5", "b1_1x1", "b2_1x1", "b4_10x10"])
def test_batchnorm_train_mode_equals_jax(shape):
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    variables, bn = _bn_pair(shape[-1], rng)
    ref = fnn.BatchNorm(use_running_average=False, momentum=0.97,
                        epsilon=1e-3)
    y, mutated = ref.apply(variables, x, mutable=["batch_stats"])
    bn.train()
    got = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)


def test_batchnorm_updates_with_biased_variance():
    """At B = 2 on a 1x1 map n = 2: torch's BatchNorm2d moves running_var
    by the unbiased variance, twice the biased one used here."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(0, 1, (2, 6, 1, 1)).astype(np.float32))
    ours = BatchNorm(6, eps=1e-3, momentum=0.03).train()
    theirs = torch.nn.BatchNorm2d(6, eps=1e-3, momentum=0.03).train()
    ours(x)
    theirs(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.97 + 0.03 * biased,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(theirs.running_var, 0.97 + 0.03 * 2 * biased,
                               rtol=1e-6, atol=1e-7)


def test_batchnorm_one_value_per_channel_does_not_raise():
    x = torch.randn(1, 8, 1, 1)
    with pytest.raises(ValueError, match="more than 1 value"):
        torch.nn.BatchNorm2d(8).train()(x)
    bn = BatchNorm(8).train()
    y = bn(x)
    torch.testing.assert_close(y, bn.bias[None, :, None, None].expand_as(y))
    torch.testing.assert_close(bn.running_var, torch.full((8,), 0.99))


def test_batchnorm_eval_mode_bit_equal_to_torch():
    rng = np.random.default_rng(6)
    _, bn = _bn_pair(8, rng)
    ref = torch.nn.BatchNorm2d(8, eps=1e-3)
    ref.load_state_dict(bn.state_dict())
    x = _t(rng.normal(0, 2, (3, 8, 7, 7)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(bn.eval()(x), ref.eval()(x))


def test_every_ssdlite_bn_has_the_detection_settings():
    model = ssdlite320_mobilenet_v3_large(num_classes=4, size=(64, 64),
                                          device="cpu").model
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == sum(isinstance(m, ConvBNAct) for m in model.modules())
    assert all(type(m) is BatchNorm and m.momentum == 0.03 and m.eps == 1e-3
               for m in bns)


# ---- LR schedule and optimizer -----------------------------------------

@pytest.mark.parametrize("spe,milestones,warmup", [
    (5, (1, 2), 1000), (7, (1, 2), 3), (12, (2,), 1000), (1, (1, 2), 1000),
    (333, (1, 2), 1000), (1000, (1, 2), 1000),
])
def test_lr_schedule_bit_equal_at_every_step(spe, milestones, warmup):
    """Against the schedule as the JAX train step runs it, compiled: jit
    folds its division and fuses its warmup blend, which moves some steps'
    rate by an ulp from the uncompiled function's."""
    jax_fn = jax_schedule(0.02, spe, milestones, 0.1, warmup)
    port_fn = make_lr_schedule(0.02, spe, milestones, 0.1, warmup)
    steps = np.arange(3 * spe + 1)
    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(steps, jnp.int32)))
    got = np.asarray([port_fn(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)
    # the decay applies at the milestone's first step
    first = milestones[0] * spe
    assert got[first] < got[first - 1] or first == 1


def test_sgd_updates_equal_jax():
    """Three updates of momentum SGD with weight decay and a schedule on
    the same parameters and gradients."""
    rng = np.random.default_rng(7)
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    schedule = (jax_schedule(0.1, 4, (1,)), make_lr_schedule(0.1, 4, (1,)))
    tx = jax_optimizer(schedule[0], 0.9, 1e-4)
    p_j, opt = dict(params), tx.init(params)
    named = [(k, torch.nn.Parameter(_t(v.copy()))) for k, v in params.items()]
    sgd = make_optimizer(schedule[1], 0.9, 1e-4)(named)
    assert isinstance(sgd, SGD)
    for step, g in enumerate(grads):
        upd, opt = tx.update(g, opt, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k, p in named:
            p.grad = _t(g[k])
        sgd.step_at(step)
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[k]),
                                   rtol=1e-6, atol=1e-7)


# ---- frozen layers -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    jd = jax_ssdlite(num_classes=4, size=(64, 64))
    return jax.eval_shape(jd.init, jax.random.PRNGKey(0))["params"]


@pytest.mark.parametrize("layers", range(7))
def test_trainable_mask_equals_jax(jax_params, layers):
    model = ssdlite320_mobilenet_v3_large(num_classes=4, size=(64, 64),
                                          device="cpu").model
    jax_mask = jax_freeze.mobilenet_trainable_mask(jax_params, layers)
    flat = jax.tree_util.tree_flatten_with_path(jax_mask)[0]
    want = {torch_name("params/" + "/".join(k.key for k in path)): v
            for path, v in flat}
    got = freeze.mobilenet_trainable_mask(model, layers)
    assert got == want
    assert any(got.values())
    assert all(got.values()) == (layers == 6)


@pytest.mark.parametrize("pretrained,layers,want", [
    (False, None, 6), (False, 3, 6), (True, None, 3), (True, 0, 0),
    (True, 6, 6),
])
def test_validate_trainable_layers(pretrained, layers, want):
    assert freeze.validate_trainable_layers(pretrained, layers, 6, 3) == want
    assert jax_freeze.validate_trainable_layers(pretrained, layers, 6,
                                                3) == want


def test_validate_trainable_layers_out_of_range():
    with pytest.raises(ValueError, match="not in"):
        freeze.validate_trainable_layers(True, 7, 6, 3)


# ---- process utilities and logging -------------------------------------

def test_single_process_defaults():
    assert dist.process_index() == 0
    assert dist.process_count() == 1
    assert dist.is_main_process()


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path / "run"))
    w.write(3, {"loss": 1.5, "lr": 0.02})
    w.write(4, {"loss": torch.tensor(1.25)})
    rows = [json.loads(ln) for ln in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [3, 4]
    assert rows[0]["train/loss"] == 1.5 and rows[1]["train/loss"] == 1.25


def test_metric_logger_prints_and_smooths(capsys):
    logger = MetricLogger(delimiter="  ")
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.3f}"))
    seen = []
    for i in logger.log_every(range(5), 2, "Epoch: [0]",
                              pre_print=lambda: seen.append(1)):
        logger.update(loss=float(i), lr=0.5)
    out = capsys.readouterr().out
    assert out.count("Epoch: [0]  [") == 3 and "Total time" in out
    assert len(seen) == 3
    assert logger.loss.global_avg == 2.0 and logger.loss.median == 2.0
    assert "lr: 0.500" in out and "mem:" not in out
