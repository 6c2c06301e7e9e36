"""The port's hand-built Caffe graphs (demonet_tpu_torch/export/caffe.py)
and its evaluator (export/caffe_eval.py), against the JAX package's.

  * each family's prototxt and caffemodel byte-equal to the JAX
    `export_caffe` output on the same weights (`jax_variables_of`);
  * the port's `run_caffenet` against the JAX `run_caffenet` on the same
    nets (every blob), and on a small graph of each layer type;
  * each hand graph, run by the port's evaluator, against the port's
    forward at the tolerances of tests/test_caffe_eval.py.
"""

import functools

import numpy as np
import pytest
import torch

from demonet_tpu.export import caffe_eval as jax_eval
from demonet_tpu.export.caffe import export_caffe as jax_export_caffe
from demonet_tpu_torch.export import caffe
from demonet_tpu_torch.export.caffe_eval import run_caffenet
from demonet_tpu_torch.utils.weights import jax_variables_of
from tests.torch_caffe import (
    ATOL,
    JAX_HAND_BUILDERS,
    RTOL,
    SIZES,
    image,
    module,
    nchw,
)
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = sorted(JAX_HAND_BUILDERS)


@functools.lru_cache(maxsize=None)
def hand_graph(name):
    size, classes = SIZES[name]
    return caffe.BUILDERS[name](module(name), num_classes=classes,
                                input_size=size)


@functools.lru_cache(maxsize=None)
def port_blobs(name):
    net = hand_graph(name)
    return {k: v.numpy() for k, v in run_caffenet(
        net, {"data": nchw(image(name))}, device="cpu").items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_hand_graph_bytes_equal_jax_exporter(name, tmp_path):
    size, classes = SIZES[name]
    files = {}
    for side, export, weights in (
            ("port", caffe.export_caffe, module(name)),
            ("jax", jax_export_caffe, jax_variables_of(module(name)))):
        paths = (str(tmp_path / f"{side}.prototxt"),
                 str(tmp_path / f"{side}.caffemodel"))
        export(name, weights, *paths, num_classes=classes, input_size=size)
        files[side] = [open(p, "rb").read() for p in paths]
    assert files["port"][0] == files["jax"][0]
    assert files["port"][1] == files["jax"][1]
    assert files["port"][0].startswith(f'name: "{name}"'.encode())


def test_unknown_family_raises(tmp_path):
    for name in ("ssd512_vgg16", "peleenet_v1"):
        with pytest.raises(ValueError, match="Caffe export supports"):
            caffe.export_caffe(name, torch.nn.Identity(),
                               str(tmp_path / "x.prototxt"),
                               str(tmp_path / "x.caffemodel"))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", FAMILIES)
def test_hand_graph_evaluator_matches_jax_evaluator(name):
    """Every blob the two evaluators leave, on the same port net."""
    want = jax_eval.run_caffenet(hand_graph(name),
                                 {"data": nchw(image(name))})
    got = port_blobs(name)
    assert got.keys() == want.keys()
    for top in want:
        np.testing.assert_allclose(got[top], np.asarray(want[top]),
                                   rtol=RTOL, atol=ATOL, err_msg=top)


@pytest.mark.parametrize("name", FAMILIES)
def test_hand_graph_matches_forward(name):
    """The classifier's "prob" against the softmax of its logits; a
    detector's softmaxed mbox_conf_softmax (B, sum HWA, C) against its
    cls_logits' softmax and the flat mbox_loc against bbox_regression."""
    blobs = port_blobs(name)
    with torch.no_grad():
        out = module(name)(torch.from_numpy(image(name)))
    if name == "mobilenet_v2":
        want = {"prob": torch.softmax(out, dim=-1)}
    else:
        want = {"mbox_conf_softmax": torch.softmax(out["cls_logits"], -1),
                "mbox_loc": out["bbox_regression"].reshape(1, -1)}
    for top, w in want.items():
        np.testing.assert_allclose(blobs[top], w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=top)


# ---------------- one small graph per layer type ----------------


def _pool_graph(net, method, kernel, stride, pad, ceil, shape):
    x = net.input("data", shape)
    net.pool("pool", x, kernel, stride, method, pad=pad, ceil_mode=ceil)


def _layers(rng):
    """Graph builders, each a few layers on a (1, 4, H, W) input."""
    w = lambda *s: rng.normal(0.0, 0.5, s).astype(np.float32)  # noqa: E731

    def conv_bn(net):
        x = net.input("data", [1, 4, 9, 10])
        y = net.conv("conv", x, w(8, 2, 3, 3), w(8), stride=2, pad=2,
                     group=2, dilation=2)
        y = net.batch_norm("bn", y, w(8), np.abs(w(8)) + 0.5, w(8), w(8),
                           eps=1e-3)
        net.layers[-2].blobs[2] = np.asarray([2.0], np.float32)  # factor
        net.relu6("bn_relu", y)
        z = net.conv("dw", x, w(4, 1, 3, 3), None, pad=1, group=4)
        net.relu("dw_relu", z)

    def se_gate(net):
        x = net.input("data", [1, 4, 6, 5])
        s = net.pool("gpool", x, 1, 1, "AVE", global_pooling=True)
        s = net.conv("fc", s, w(4, 4, 1, 1), w(4))
        s = net.power("shift", s, shift=3.0)
        s = net.flatten("flat", s)
        net.scale_bottoms("gate", x, s, axis=0)
        net.pool("gmax", x, 1, 1, "MAX", global_pooling=True)

    def elementwise(net):
        x = net.input("data", [1, 4, 5, 5])
        a = net.power("sq", x, power=2.0, scale=0.5, shift=1.0)
        b = net.power("rsqrt", a, power=-0.5)
        net.eltwise_sum("sum", a, b)
        p = net.eltwise_prod("prod", x, b)
        net.scale("affine", p, w(4), w(4))
        net.concat("cat", [x, p, b], axis=1)

    def normalize(net):
        x = net.input("data", [1, 4, 5, 6])
        net.normalize("norm", x, np.abs(w(4)) * 10.0)

    def tail(net):
        x = net.input("data", [1, 4, 3, 5])
        f = net.flatten("flat", net.permute("perm", x, [0, 2, 3, 1]))
        net.inner_product("fc", f, w(6, 60), w(6))
        r = net.reshape("reshape", f, [0, -1, 4])
        net.softmax("softmax", r, axis=2)
        net.softmax("softmax1", net.reshape("r1", x, [0, 4, 15]), axis=1)

    return {
        "conv_bn_relu6": conv_bn,
        "se_gate_global_pools": se_gate,
        "power_eltwise_scale_concat": elementwise,
        "normalize": normalize,
        "permute_flatten_ip_reshape_softmax": tail,
        # a window that starts in the padding (k3 s3 p1 on 5: dropped)
        "max_ceil_pad_dropped_window": functools.partial(
            _pool_graph, method="MAX", kernel=3, stride=3, pad=1, ceil=True,
            shape=[1, 4, 5, 7]),
        "ave_ceil_pad_dropped_window": functools.partial(
            _pool_graph, method="AVE", kernel=3, stride=3, pad=1, ceil=True,
            shape=[1, 4, 5, 7]),
        "ave_ceil_pad": functools.partial(
            _pool_graph, method="AVE", kernel=3, stride=2, pad=1, ceil=True,
            shape=[1, 4, 9, 10]),
        "ave_ceil_odd": functools.partial(
            _pool_graph, method="AVE", kernel=2, stride=2, pad=0, ceil=True,
            shape=[1, 4, 19, 19]),
        "max_floor_pad": functools.partial(
            _pool_graph, method="MAX", kernel=3, stride=2, pad=1, ceil=False,
            shape=[1, 4, 10, 9]),
        "ave_floor": functools.partial(
            _pool_graph, method="AVE", kernel=2, stride=2, pad=0, ceil=False,
            shape=[1, 4, 9, 9]),
        "max_s1_pad": functools.partial(
            _pool_graph, method="MAX", kernel=3, stride=1, pad=1, ceil=True,
            shape=[1, 4, 6, 6]),
    }


@pytest.mark.parametrize("case", sorted(_layers(None)))
def test_evaluator_layer_matches_jax(case):
    rng = np.random.default_rng(7)
    net = caffe.CaffeNet(case)
    _layers(rng)[case](net)
    shape = net.layers[0].params["input_shape"]
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    want = jax_eval.run_caffenet(net, {"data": x})
    got = run_caffenet(net, {"data": x}, device="cpu")
    assert got.keys() == want.keys()
    for top in want:
        assert tuple(got[top].shape) == np.shape(want[top]), top
        np.testing.assert_allclose(got[top].numpy(), np.asarray(want[top]),
                                   rtol=RTOL, atol=ATOL, err_msg=top)
