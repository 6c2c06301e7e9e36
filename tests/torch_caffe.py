"""Shared pieces of the Caffe export tests of the port
(tests/test_torch_caffe_*.py): the models at test size with seeded
weights, their input, each family's JAX counterparts, and the generic
route's checks (tests/test_torch_caffe_tracing.py's docstring)."""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import torch

from demonet_tpu.export import caffe as jax_caffe
from demonet_tpu.export.tracing import trace_to_caffe as jax_trace_to_caffe
from demonet_tpu.models import builders as jax_builders
from demonet_tpu_torch.export.caffe_eval import run_caffenet
from demonet_tpu_torch.export.tracing import output_list, trace_to_caffe
from demonet_tpu_torch.models.builders import get_model
from demonet_tpu_torch.models.layers import BatchNorm, SqueezeExcitation
from demonet_tpu_torch.utils.weights import jax_variables_of

# the tolerances of tests/test_caffe_eval.py
RTOL, ATOL = 2e-4, 2e-5

# name -> (input size, classes): 64x64 where the model runs at that size;
# VGG needs 257 at least and Pelee's valid 3x3 extras 257 too, so they
# run at their own sizes
SIZES = {
    "mobilenet_v2": (64, 7),
    "mobilenet_v3_small": (64, 6),
    "ssd_lite_mobilenet_v2": (64, 5),
    "ssdlite320_mobilenet_v3_large": (64, 4),
    "pelee304": (304, 4),
    "ssd300_vgg16": (300, 3),
}
_SIZED = ("ssd_lite_mobilenet_v2", "ssdlite320_mobilenet_v3_large")

JAX_HAND_BUILDERS = {
    "mobilenet_v2": jax_caffe.mobilenet_v2_to_caffe,
    "ssd_lite_mobilenet_v2": jax_caffe.ssd_lite_mobilenet_v2_to_caffe,
    "ssd300_vgg16": jax_caffe.ssd300_vgg16_to_caffe,
    "ssdlite320_mobilenet_v3_large":
        jax_caffe.ssdlite320_mobilenet_v3_large_to_caffe,
    "pelee304": jax_caffe.pelee304_to_caffe,
}


@functools.lru_cache(maxsize=None)
def module(name: str) -> torch.nn.Module:
    """The port's model of `name` at its test size on the CPU, in eval
    mode (a detector's `SSD` module): convs and linears as the builder
    draws them (the JAX package's initializers, seed 0), every BN's
    scale and running variance in [0.5, 1.5], its bias and running mean
    N(0, 0.1), so that each BN is a real per-channel affine and the
    activations stay near 1 through the trunk."""
    size, classes = SIZES[name]
    kwargs = {"size": (size, size)} if name in _SIZED else {}
    built = get_model(name, num_classes=classes, device="cpu", **kwargs)
    model = getattr(built, "model", built)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, c)))
    return model.eval()


def image(name: str, seed: int = 0) -> np.ndarray:
    """A seeded (1, S, S, 3) float32 batch in [-0.5, 1.5), as the JAX
    tests and the JAX CLI's --verify draw it."""
    size = SIZES[name][0]
    return (np.random.default_rng(seed).random((1, size, size, 3),
                                               np.float32) * 2.0 - 0.5)


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


def jax_raw(name: str, variables):
    """The JAX model of `name` at its test size as a function of NHWC
    images: a detector's (cls_logits, bbox_regression), a classifier's
    logits, on `variables`."""
    size, classes = SIZES[name]
    kwargs = {"size": (size, size)} if name in _SIZED else {}
    model = jax_builders.get_model(name, num_classes=classes, **kwargs)
    if hasattr(model, "config"):
        def raw(x):
            out = model.model.apply(variables, x, train=False)
            return out["cls_logits"], out["bbox_regression"]
        return raw
    return lambda x: model.apply(variables, x, train=False)


@functools.lru_cache(maxsize=None)
def generic_graph(name):
    return trace_to_caffe(module(name), torch.from_numpy(image(name)),
                          name=name)


def check_against_forward(name):
    net = generic_graph(name)
    x = image(name, seed=1)
    blobs = run_caffenet(net, {"data": nchw(x)}, device="cpu")
    with torch.no_grad():
        want = output_list(module(name)(torch.from_numpy(x)))
    assert len(net.output_tops) == len(want)
    for top, w in zip(net.output_tops, want):
        np.testing.assert_allclose(blobs[top].numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=top)
    assert "BatchNorm" not in {layer.type for layer in net.layers}


def check_counts_against_jax(name):
    """Caffe layer counts of the port's graph against the JAX walker's on
    the same weights, less the SE blocks' four layers each."""
    net = generic_graph(name)
    jax_net = jax_trace_to_caffe(
        jax_raw(name, jax_variables_of(module(name))),
        jnp.asarray(image(name)), name=name)
    got = collections.Counter(layer.type for layer in net.layers)
    want = collections.Counter(layer.type for layer in jax_net.layers)
    se = sum(isinstance(m, SqueezeExcitation)
             for m in module(name).modules())
    want.subtract({"Flatten": se, "Reshape": se, "Power": 2 * se})
    assert got == {k: n for k, n in want.items() if n}
    assert len(net.output_tops) == len(jax_net.output_tops)
