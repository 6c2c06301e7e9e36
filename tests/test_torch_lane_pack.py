"""Port vs JAX package: the lane-packed and space-to-depth layouts
(demonet_tpu_torch/ops/lane_pack.py, layers.PackedConvBNAct, S2DConv2d,
PackedConv2d, the `lane_pack` and `stem_s2d` keywords of the builders).

The same numpy inputs go through each function of the JAX package's
ops/lane_pack.py and its port, moved between NHWC (JAX) and NCHW (port);
kernels between HWIO and OIHW. Tolerances, with what they hold to:

  * pack, unpack, repack, space_to_depth and the four kernel
    rearrangements: bit-equal (pure relayouts);
  * the packed 1x1, depthwise and dense convs and the space-to-depth
    stem conv in float32, at the cases of tests/test_lane_pack.py and
    tests/test_vgg_lane_pack.py: within 1e-5 of the output's scale (only
    the order of summation differs);
  * packed_batch_stats: within 1e-6;
  * packed_pool_2x2: forward bit-equal, and its gradient's routing
    bit-equal on engineered ties, to the JAX packed pool's and to the
    port's unpacked 2x2 pool's.

Whole models, against the JAX model built with the same keywords from
the same variables: the flagship with lane_pack and stem_s2d at 64x64 (4
classes; the pack plan [8, 2, 1, ...] at that size as at 320) and
ssd_lite_mobilenet_v2 with stem_s2d at 64x64 compare their eval head
outputs in float32 (within 1e-4 of the scale, as the families' tests)
and one SGD step in float64, the step's parameter update carrying the
gradients: for ssd_lite_mobilenet_v2, tests/test_torch_train_step.py's
float64 bounds (loss terms rtol 5e-7, every parameter and BN statistic
atol 1e-5 + rtol 1e-5). The JAX package's packed BatchNorm takes its
statistics in float32 whatever the model's dtype (x.astype(float32)
before packed_batch_stats), and so does the port's; the two frameworks
sum them in other orders, so the packed flagship's float64 step carries
float32 noise: measured 6.4e-7 relative in the loss terms and 1.6e-5 in
the parameters, held to rtol 2e-6 and atol 5e-5 + rtol 1e-5 (a fault
in the packed statistics or the kernels moves them by 1e-3 and more);
ssd300_vgg16 with lane_pack at its only size, 300x300, where block 1's
maps are even (300 packs to 150 packs of 2 and pools to 150; pool3's
ceil mode then takes 75 to 38), compares its heads the same way and one
float32 step as tests/test_torch_vgg.py does (no BN). One packed block
in bfloat16 against the JAX block in bfloat16: within 2 bf16 ulps of the
scale (tests/test_torch_bf16_layers.py's count).

The port against itself: each layout has the unpacked model's
state_dict keys and shapes and, from one seed, its weights; a checkpoint
saved from one loads strictly into the other; their outputs agree within
1e-5 of the scale.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models import builders as jax_builders
from demonet_tpu.models import layers as jax_layers
from demonet_tpu.models.mobilenetv3 import (
    MobileNetV3Features as JaxV3Features,
    mobilenet_v3_conf as jax_v3_conf,
)
from demonet_tpu.ops import lane_pack as jlp
from demonet_tpu_torch.engine.state import (
    create_train_state,
    make_optimizer,
)
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models import builders, layers
from demonet_tpu_torch.models.mobilenetv3 import (
    mobilenet_v3_conf,
    pack_plan,
)
from demonet_tpu_torch.models.vgg import max_pool_torch
from demonet_tpu_torch.ops import lane_pack as plp
from demonet_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    save_checkpoint,
)
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.test_torch_bf16_layers import (
    assert_bf16_close,
    bf16_input,
    nchw,
    nhwc,
)
from tests.test_torch_train_step import (
    _ATOL_64,
    _RTOL_64,
    _RTOL_LOSS_64,
    _batch,
    _draw_variables,
)
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_SIZE, _CLASSES = (64, 64), 4
_KEYS = ("bbox_regression", "classification", "loss")


def _t(x):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _n(t):
    """NCHW tensor -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def _w(k):
    """HWIO numpy -> OIHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k).transpose(3, 2, 0, 1)))


# -- ops/lane_pack.py, function by function ---------------------------------

def test_pack_unpack_repack_bit_equal():
    x = np.random.default_rng(0).random((2, 4, 16, 3), np.float32)
    for p in (1, 2, 4, 8):
        packed = plp.pack(_t(x), p)
        np.testing.assert_array_equal(_n(packed), jlp.pack(x, p))
        assert torch.equal(plp.unpack(packed, p, 3), _t(x))
    for p_from, p_to in ((8, 2), (2, 8), (4, 4), (1, 4)):
        np.testing.assert_array_equal(
            _n(plp.repack(plp.pack(_t(x), p_from), p_from, p_to, 3)),
            jlp.repack(jlp.pack(x, p_from), p_from, p_to, 3))
    with pytest.raises(ValueError, match="multiple"):
        plp.pack(_t(x), 3)


def test_space_to_depth_bit_equal_and_block_major():
    """The channels are (u, v, c) block-major, as the JAX package orders
    them; F.pixel_unshuffle's (c, u, v) order is another layout."""
    x = np.random.default_rng(1).random((2, 8, 6, 3), np.float32)
    got = plp.space_to_depth(_t(x))
    np.testing.assert_array_equal(_n(got), jlp.space_to_depth(jnp.asarray(x)))
    assert not torch.equal(got, torch.nn.functional.pixel_unshuffle(_t(x), 2))


def _kernel_cases():
    rng = np.random.default_rng(2)
    cases = {}
    for p in (1, 2, 8):
        k = rng.random((1, 1, 5, 7), np.float32) - 0.5
        cases[f"kron_p{p}"] = (lambda k, p=p: jlp.kron_1x1_kernel(k, p),
                               lambda w, p=p: plp.kron_1x1_kernel(w, p), k)
    for p, s in ((1, 1), (2, 1), (8, 1), (2, 2), (8, 2), (4, 2)):
        k = rng.random((3, 3, 1, 6), np.float32) - 0.5
        cases[f"dw_p{p}_s{s}"] = (
            lambda k, p=p, s=s: jlp.packed_dw_kernel(k, p, s),
            lambda w, p=p, s=s: plp.packed_dw_kernel(w, p, s), k)
    for ci, co, p in ((3, 8, 2), (8, 8, 2), (8, 16, 4)):
        k = rng.standard_normal((3, 3, ci, co)).astype(np.float32)
        cases[f"dense_{ci}_{co}_p{p}"] = (
            lambda k, p=p: jlp.packed_dense_kernel(k, p),
            lambda w, p=p: plp.packed_dense_kernel(w, p), k)
    k = rng.normal(0, 0.2, (3, 3, 3, 16)).astype(np.float32)
    cases["s2d_stem"] = (jlp.s2d_stem_kernel, plp.s2d_stem_kernel, k)
    return cases


@pytest.mark.parametrize("case", sorted(_kernel_cases()))
def test_kernel_rearrangements_bit_equal(case):
    jax_fn, port_fn, k = _kernel_cases()[case]
    want = np.asarray(jax_fn(jnp.asarray(k))).transpose(3, 2, 0, 1)
    got = port_fn(_w(k)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _lax_conv(x, k, stride=1, pad=((0, 0), (0, 0)), groups=1):
    return jax.lax.conv_general_dilated(
        x, k, (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups)


def _conv_cases():
    """(JAX function, port function, x NHWC, kernel HWIO) of the packed
    convs at tests/test_lane_pack.py's and tests/test_vgg_lane_pack.py's
    cases, and the space-to-depth stem."""
    rng = np.random.default_rng(3)
    cases = {}
    for p in (1, 2, 8):
        x = rng.random((2, 6, 16, 5), np.float32)
        k = rng.random((1, 1, 5, 7), np.float32) - 0.5
        cases[f"1x1_p{p}"] = (
            lambda x, k, p=p: jlp.conv_1x1_packed(jlp.pack(x, p), k, p),
            lambda x, w, p=p: plp.conv_1x1_packed(plp.pack(x, p), w, p),
            x, k)
    for p, s in ((1, 1), (2, 1), (8, 1), (2, 2), (8, 2), (4, 2)):
        x = rng.random((2, 8, 16, 6), np.float32)
        k = rng.random((3, 3, 1, 6), np.float32) - 0.5
        cases[f"dw_p{p}_s{s}"] = (
            lambda x, k, p=p, s=s: jlp.conv_dw_packed(jlp.pack(x, p), k, p,
                                                      s),
            lambda x, w, p=p, s=s: plp.conv_dw_packed(plp.pack(x, p), w, p,
                                                      s), x, k)
    for ci, co, p in ((3, 8, 2), (8, 8, 2), (8, 16, 4)):
        x = rng.standard_normal((2, 6, 8 * p, ci)).astype(np.float32)
        k = rng.standard_normal((3, 3, ci, co)).astype(np.float32)
        cases[f"dense_{ci}_{co}_p{p}"] = (
            lambda x, k, p=p: jlp.conv_dense_packed(jlp.pack(x, p), k, p),
            lambda x, w, p=p: plp.conv_dense_packed(plp.pack(x, p), w, p),
            x, k)
    x = rng.random((2, 32, 48, 3)).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, 3, 16)).astype(np.float32)
    cases["s2d_stem"] = (
        lambda x, k: _lax_conv(jlp.space_to_depth(x), jlp.s2d_stem_kernel(k),
                               pad=((1, 0), (1, 0))),
        plp.conv_s2d_stem, x, k)
    return cases


@pytest.mark.parametrize("case", sorted(_conv_cases()))
def test_packed_convs_match_jax(case):
    jax_fn, port_fn, x, k = _conv_cases()[case]
    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x), jnp.asarray(k)))
    got = _n(port_fn(_t(x), _w(k)))
    tp.assert_close_to_scale(got, want, 1e-5, case)


def test_s2d_stem_conv_is_the_stride2_conv():
    x = np.random.default_rng(4).random((2, 32, 48, 3)).astype(np.float32)
    w = torch.from_numpy(np.random.default_rng(5).normal(
        0, 0.2, (16, 3, 3, 3)).astype(np.float32))
    want = torch.nn.functional.conv2d(_t(x), w, stride=2, padding=1)
    tp.assert_close_to_scale(plp.conv_s2d_stem(_t(x), w).numpy(),
                             want.numpy(), 1e-5)


def test_packed_batch_stats_match_jax():
    x = np.random.default_rng(6).random((2, 4, 16, 5), np.float32)
    want = jlp.packed_batch_stats(jlp.pack(x, 4), 4, 5)
    got = plp.packed_batch_stats(plp.pack(_t(x), 4), 4, 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_packed_pool_forward_bit_equal():
    x = np.random.default_rng(7).standard_normal((2, 8, 12, 5)).astype(
        np.float32)
    got = plp.packed_pool_2x2(plp.pack(_t(x), 2), 5)
    np.testing.assert_array_equal(_n(got),
                                  jlp.packed_pool_2x2(jlp.pack(x, 2), 5))
    assert torch.equal(got, max_pool_torch(_t(x), 2, 2))


def test_packed_pool_gradient_routing_bit_equal_on_ties():
    """Values quantised to halves, so that most windows hold ties: the
    gradient reaches the first maximum of each window in row-major order,
    as the JAX packed pool's and the port's unpacked pool's do."""
    rng = np.random.default_rng(3)
    x = np.round(rng.standard_normal((1, 6, 8, 3)).astype(np.float32)
                 * 2.0) / 2.0
    cot = rng.standard_normal((1, 3, 4, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.vdot(
        jlp.packed_pool_2x2(jlp.pack(v, 2), 3), cot))(jnp.asarray(x)))
    grads = []
    for pool in (lambda t: plp.packed_pool_2x2(plp.pack(t, 2), 3),
                 lambda t: max_pool_torch(t, 2, 2)):
        t = _t(x).clone().requires_grad_(True)
        (pool(t) * _t(cot)).sum().backward()
        grads.append(_n(t.grad))
    np.testing.assert_array_equal(grads[0], want)
    np.testing.assert_array_equal(grads[1], want)
    assert (x.reshape(1, 3, 2, 4, 2, 3).max(axis=(2, 4), keepdims=True)
            == x.reshape(1, 3, 2, 4, 2, 3)).sum() > 12 * 3


# -- the pack plan ------------------------------------------------------------

@pytest.mark.parametrize("max_lanes", [64, 128, 256])
def test_pack_plan_matches_jax(max_lanes):
    rows, _ = mobilenet_v3_conf("mobilenet_v3_large", reduced_tail=True)
    jrows, _ = jax_v3_conf("mobilenet_v3_large", 1.0, True)
    want = JaxV3Features(tuple(jrows), lane_pack=True,
                         lane_pack_max_lanes=max_lanes)._pack_plan()
    assert pack_plan(rows, True, max_lanes) == want
    if max_lanes == 128:
        assert want == [8, 2] + [1] * 13
    assert pack_plan(rows, False, max_lanes) == [1] * 15


# -- whole models against the JAX package ------------------------------------

def _flagship_jax(dtype=jnp.float32):
    return jax_builders.ssdlite320_mobilenet_v3_large(
        num_classes=_CLASSES, size=_SIZE, dtype=dtype, lane_pack=True,
        stem_s2d=True)


def _v2_jax(dtype=jnp.float32):
    return jax_builders.ssd_lite_mobilenet_v2(
        num_classes=_CLASSES, size=_SIZE, dtype=dtype, stem_s2d=True)


# (JAX builder, port builder, variables' draw, the float64 step's
# (loss rtol, state atol, state rtol))
_MODELS = {
    "flagship_packed_s2d": (
        _flagship_jax, lambda: builders.ssdlite320_mobilenet_v3_large(
            num_classes=_CLASSES, size=_SIZE, device="cpu", lane_pack=True,
            stem_s2d=True), _draw_variables, (2e-6, 5e-5, _RTOL_64)),
    "v2_s2d": (
        _v2_jax, lambda: builders.ssd_lite_mobilenet_v2(
            num_classes=_CLASSES, size=_SIZE, device="cpu", stem_s2d=True),
        tp.draw_variables, (_RTOL_LOSS_64, _ATOL_64, _RTOL_64)),
}


@pytest.fixture(scope="module", params=sorted(_MODELS))
def model_ref(request):
    """The JAX layout model: its variables (float32 values), its jitted
    eval heads on two frames, and one step of its float64 train step."""
    make_jax, make_port, draw, tol = _MODELS[request.param]
    jd = make_jax()
    variables = draw(jax.eval_shape(jd.init, jax.random.PRNGKey(0)),
                     np.random.default_rng(0))
    x = tp.images(1, _SIZE, b=2)
    heads = jax.jit(jd.apply)(variables, (x - 0.5) / 0.5)
    with jax.enable_x64(True):
        batch = _batch(1)
        metrics, after = tp.jax_steps(make_jax(jnp.float64), variables,
                                      batch, 1, np.float64)
    return {"name": request.param, "make_port": make_port, "tol": tol,
            "variables": variables, "x": x, "heads": heads, "batch": batch,
            "metrics": metrics, "after": after}


def _port(ref):
    pd = ref["make_port"]()
    load_jax_variables(pd.model, ref["variables"])
    return pd


def test_layout_model_heads_match_jax(model_ref):
    pd = _port(model_ref)
    with torch.no_grad():
        got = pd.model(torch.from_numpy((model_ref["x"] - 0.5) / 0.5))
    for key in ("cls_logits", "bbox_regression"):
        tp.assert_close_to_scale(got[key].numpy(), model_ref["heads"][key],
                                 1e-4, key)


def test_layout_model_float64_train_step_matches_jax(model_ref):
    """Loss terms, and every parameter (so the gradient) and BN running
    statistic after one SGD step, the packed BN's included."""
    pd = _port(model_ref)
    pd.model.double()
    batch = {k: torch.from_numpy(v) for k, v in model_ref["batch"].items()}
    batch["images"] = batch["images"].double()
    state = create_train_state(pd, make_optimizer(tp.LR, tp.MOMENTUM, tp.WD))
    _, m = make_train_step(pd)(state, batch)
    rtol_loss, atol, rtol = model_ref["tol"]
    for key in _KEYS:
        np.testing.assert_allclose(float(m[key]),
                                   model_ref["metrics"][0][key],
                                   rtol=rtol_loss, err_msg=key)
    tp.assert_state_close(pd.model, tp.jax_state(model_ref["after"]), atol,
                          rtol)
    if model_ref["name"] == "flagship_packed_s2d":
        bn = pd.model.extractor.trunk.blocks[1].depthwise.bn
        assert isinstance(bn, layers.PackedBatchNorm) and bn.pack == 2


@pytest.fixture(scope="module")
def vgg_ref():
    jd = jax_builders.ssd300_vgg16(num_classes=_CLASSES, lane_pack=True)
    variables = tp.jax_variables(jd.init)
    variables["params"]["extractor"]["conv1_1"]["kernel"] /= 255.0
    return {"jd": jd, "variables": variables}


def _vgg_port(variables):
    pd = builders.ssd300_vgg16(num_classes=_CLASSES, device="cpu",
                               lane_pack=True)
    load_jax_variables(pd.model, variables)
    return pd


def test_packed_vgg_heads_match_jax(vgg_ref):
    jd, pd = vgg_ref["jd"], _vgg_port(vgg_ref["variables"])
    assert isinstance(pd.model.extractor.conv1_2, layers.PackedConv2d)
    x = tp.images(2, (300, 300))
    xn = (x - np.float32([0.48235, 0.45882, 0.40784])) * np.float32(255.0)
    want = jax.jit(jd.apply)(vgg_ref["variables"], xn)
    with torch.no_grad():
        got = pd.model(torch.from_numpy(xn))
    for key in ("cls_logits", "bbox_regression"):
        tp.assert_close_to_scale(got[key].numpy(), want[key], 1e-4, key)


def test_packed_vgg_train_step_matches_jax(vgg_ref):
    """One float32 SGD step at B = 1 (no BN): loss terms rtol 1e-6, each
    parameter within 1e-2 of the largest change the step made to it."""
    jd, variables = vgg_ref["jd"], vgg_ref["variables"]
    batch = tp.train_batch(1, (300, 300), _CLASSES, b=1)
    want, after = tp.jax_steps(jd, variables, batch, 1, np.float32)
    pd = _vgg_port(variables)
    state = create_train_state(pd, make_optimizer(tp.LR, tp.MOMENTUM, tp.WD))
    _, m = make_train_step(pd)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in _KEYS:
        np.testing.assert_allclose(float(m[key]), want[0][key], rtol=1e-6,
                                   err_msg=key)
    start, end = tp.jax_state(variables), tp.jax_state(after)
    got = pd.model.state_dict()
    assert got.keys() == end.keys()
    for name, w in got.items():
        moved = float((end[name] - start[name]).abs().max())
        err = float((w.double() - end[name]).abs().max())
        assert moved > 0 and err <= 1e-2 * moved, (name, err, moved)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_block_bf16_matches_jax(train):
    """Block 1 of the flagship's trunk (16 -> 64 -> 24, stride 2) entered
    at pack 8 and run at pack 2, bf16 compute; the output unpacked, and
    in train mode the float32 running statistics its packed BNs leave."""
    jmod = jax_layers.InvertedResidualV3(
        16, 64, 24, 3, 2, bn_momentum=0.97, dtype=jnp.bfloat16,
        lane_pack_in=8, lane_pack_run=2)
    pmod = layers.InvertedResidualV3(16, 64, 24, 3, 2, bn_momentum=0.03,
                                     lane_pack_in=8, lane_pack_run=2)
    x = bf16_input(1, (2, 8, 16, 16))
    xp = np.asarray(jlp.pack(x, 8))
    variables = tp.jax_variables(jmod.init, 0, jnp.zeros(xp.shape))
    load_jax_variables(pmod, variables)
    layers.set_compute_dtype(pmod, torch.bfloat16)
    out = jax.jit(lambda v, x: jmod.apply(
        v, x, train=train, mutable=["batch_stats"] if train else False))(
        variables, jnp.asarray(xp, jnp.bfloat16))
    want, mutated = out if train else (out, None)
    pmod.train(train)
    with torch.no_grad():
        got = pmod(plp.pack(nchw(x), 8))
    assert_bf16_close(nhwc(plp.unpack(got, 2, 24)),
                      jlp.unpack(want, 2, 24), what="packed block")
    if train:
        buffers = dict(pmod.named_buffers())
        for key, value in tp.jax_state(
                {"batch_stats": mutated["batch_stats"]}).items():
            tp.assert_close_to_scale(buffers[key].numpy(), value.numpy(),
                                     2e-3, key)


# -- the port against itself --------------------------------------------------

_SELF = {
    "flagship_lane_pack": ("ssdlite320_mobilenet_v3_large",
                           dict(size=_SIZE), dict(lane_pack=True)),
    "flagship_stem_s2d": ("ssdlite320_mobilenet_v3_large",
                          dict(size=_SIZE), dict(stem_s2d=True)),
    "v2_stem_s2d": ("ssd_lite_mobilenet_v2", dict(size=_SIZE),
                    dict(stem_s2d=True)),
    "vgg300_lane_pack": ("ssd300_vgg16", {}, dict(lane_pack=True)),
}


@pytest.mark.parametrize("case", sorted(_SELF))
def test_layout_and_plain_models_share_state_and_outputs(case, tmp_path):
    name, common, layout = _SELF[case]
    plain = builders.get_model(name, num_classes=_CLASSES, device="cpu",
                               seed=3, **common)
    other = builders.get_model(name, num_classes=_CLASSES, device="cpu",
                               seed=3, **common, **layout)
    sp, so = plain.model.state_dict(), other.model.state_dict()
    assert list(sp) == list(so)
    assert all(torch.equal(sp[k], so[k]) for k in sp)
    # a checkpoint of either loads, strictly, into the other
    sgd = make_optimizer(0.01)
    for src, dst, d in ((plain, other, "a"), (other, plain, "b")):
        with torch.no_grad():
            for p in src.model.parameters():
                p.add_(0.01 * torch.randn(p.shape,
                                          generator=torch.Generator()
                                          .manual_seed(p.numel())))
        path = save_checkpoint(str(tmp_path / d),
                               create_train_state(src, sgd), 0)
        load_checkpoint(path, create_train_state(dst, sgd))
        assert all(torch.equal(v, dst.model.state_dict()[k])
                   for k, v in src.model.state_dict().items())
    x = torch.from_numpy(tp.images(4, plain.config.size) - np.float32(0.5))
    with torch.no_grad():
        a, b = plain.model(x), other.model(x)
    for key in a:
        tp.assert_close_to_scale(b[key].numpy(), a[key].numpy(), 1e-5, key)


def test_layout_keywords_only_where_the_jax_builders_take_them():
    for name, kw in (("pelee304", "lane_pack"), ("pelee304", "stem_s2d"),
                     ("ssd300_vgg16", "stem_s2d"),
                     ("ssd_lite_mobilenet_v2", "lane_pack"),
                     ("mobilenet_v2", "stem_s2d")):
        with pytest.raises(TypeError):
            getattr(jax_builders, name)(**{kw: True})
        with pytest.raises(TypeError):
            builders.get_model(name, device="meta", **{kw: True})
    with pytest.raises(ValueError, match="no SE"):
        layers.InvertedResidualV3(16, 64, 24, 5, 2, lane_pack_run=2)
    with pytest.raises(ValueError, match="never lane-packed"):
        layers.InvertedResidualV3(16, 64, 24, 3, 2,
                                  lane_pack_run=2).expand(
            torch.zeros(1, 32, 4, 4))
