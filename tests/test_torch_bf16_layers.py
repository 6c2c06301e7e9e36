"""Port vs JAX package in bfloat16: each layer module of the port with
bf16 compute (`layers.set_compute_dtype`) against the JAX module built
with `dtype=jnp.bfloat16`, on the same float32 variables (numpy draws of
the module's abstract tree, carried into the port by
`load_jax_variables`) and the same inputs.

The JAX rule the port copies: parameters and BN statistics stay float32;
a conv or dense layer casts its input and weight to bf16 and gives bf16;
BatchNorm computes its statistics and the normalisation in float32 and
gives bf16; the rest runs in its input's dtype.

Tolerance: max |port - JAX| within 2 bf16 ulps of the output's scale
(ulp(s) = 2^(floor(log2 s) - 7), s = max |JAX|). The two frameworks sum
a conv's products in other orders before the one rounding to bf16, and
XLA keeps some elementwise chains in float32 where torch rounds each op
to bf16 (its `xla_allow_excess_precision`), so single elements differ by
an ulp; measured at most 1.25 ulps here (the V3 block with SE), 1-2 ulps
at the whole models' heads (tests/test_torch_bf16_model.py). BN's new running statistics (float32,
from the same bf16 input) agree within 1e-6; behind a conv, whose bf16
output may differ by an ulp, within 2e-3 of their scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from demonet_tpu.models import heads as jax_heads
from demonet_tpu.models import layers as jax_layers
from demonet_tpu.models.peleenet import avg_pool_torch as jax_avg_pool
from demonet_tpu_torch.models import heads, layers
from demonet_tpu_torch.models.peleenet import avg_pool_torch
from demonet_tpu_torch.models.vgg import l2_rescale
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_BF16 = jnp.bfloat16
_ULPS = 2


def ulp(scale):
    """One bf16 ulp at `scale` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def assert_bf16_close(got, want, ulps=_ULPS, what=""):
    """got (a bf16 tensor, NHWC) against want (a bf16 JAX array)."""
    assert got.dtype == torch.bfloat16, (what, got.dtype)
    assert want.dtype == _BF16, (what, want.dtype)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert scale > 0 and err <= ulps * ulp(scale), (what, err, ulp(scale))


def bf16_input(seed, shape):
    """Seeded float32 values rounded to bf16: the same input for both."""
    x = np.random.default_rng(seed).normal(0.0, 1.0, shape)
    return np.array(jnp.asarray(x, _BF16).astype(jnp.float32))


def nchw(x):
    return torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def _pair(jax_module, port_module, *init_args, seed=0):
    """Variables for the JAX module, the same values in the port module
    (bf16 compute)."""
    variables = tp.jax_variables(jax_module.init, seed, *init_args)
    load_jax_variables(port_module, variables)
    layers.set_compute_dtype(port_module, torch.bfloat16)
    return variables, port_module


# (JAX module, port module, input NHWC) of each conv block
def _blocks():
    hs, relu6 = jax_layers.hard_swish, jax_layers.relu6
    return {
        "conv_bn_hswish_s2": (
            jax_layers.ConvBNAct(16, 3, stride=2, act=hs, bn_momentum=0.97,
                                 dtype=_BF16),
            layers.ConvBNAct(8, 16, 3, stride=2, act=layers.hard_swish,
                             bn_momentum=0.03), (2, 9, 9, 8)),
        "conv_bn_depthwise": (
            jax_layers.ConvBNAct(12, 3, groups=12, act=relu6, dtype=_BF16),
            layers.ConvBNAct(12, 12, 3, groups=12, act=layers.relu6),
            (2, 7, 7, 12)),
        "conv_bn_linear_1x1": (
            jax_layers.ConvBNAct(24, 1, act=None, bn_eps=1e-5,
                                 bn_momentum=0.9, dtype=_BF16),
            layers.ConvBNAct(16, 24, 1, act=None, bn_eps=1e-5,
                             bn_momentum=0.1), (2, 5, 5, 16)),
        "inverted_residual_v3_se_hs": (
            jax_layers.InvertedResidualV3(16, 64, 16, 5, 1, use_se=True,
                                          use_hs=True, bn_momentum=0.97,
                                          dtype=_BF16),
            layers.InvertedResidualV3(16, 64, 16, 5, 1, use_se=True,
                                      use_hs=True, bn_momentum=0.03),
            (2, 6, 6, 16)),
        "inverted_residual_v3_s2": (
            jax_layers.InvertedResidualV3(16, 48, 24, 3, 2, dtype=_BF16),
            layers.InvertedResidualV3(16, 48, 24, 3, 2), (2, 8, 8, 16)),
        "inverted_residual_v2": (
            jax_layers.InvertedResidualV2(16, 1, 6, dtype=_BF16),
            layers.InvertedResidualV2(16, 16, 1, 6), (2, 6, 6, 16)),
        "separable_conv": (
            jax_layers.SeparableConv(30, dtype=_BF16),
            layers.SeparableConv(20, 30), (2, 5, 5, 20)),
    }


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(_blocks()))
def test_conv_blocks_bf16_match_jax(name, train):
    """Conv + BN blocks on bf16 activations, as inside a bf16 model:
    outputs and, in train mode, the float32 running statistics each BN
    leaves."""
    jmod, pmod, shape = _blocks()[name]
    x = bf16_input(1, shape)
    variables, pmod = _pair(jmod, pmod, jnp.zeros(shape, jnp.float32))
    apply = jax.jit(functools.partial(jmod.apply, train=train,
                                      mutable=["batch_stats"] if train
                                      else False))
    out = apply(variables, jnp.asarray(x, _BF16))
    want, mutated = out if train else (out, None)
    pmod.train(train)
    with torch.no_grad():
        got = nhwc(pmod(nchw(x)))
    assert_bf16_close(got, want, what=name)
    if train:
        stats = tp.jax_state({"batch_stats": mutated["batch_stats"]})
        buffers = dict(pmod.named_buffers())
        for key, value in stats.items():
            tp.assert_close_to_scale(buffers[key].numpy(), value.numpy(),
                                     2e-3, f"{name} {key}")
    # parameters and statistics stay float32
    assert all(v.dtype == torch.float32 for k, v in pmod.state_dict().items()
               if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", [(2, 5, 5, 8), (2, 1, 1, 8),
                                   (4, 10, 10, 16)],
                         ids=["b2_5x5", "b2_1x1", "b4_10x10"])
def test_batchnorm_bf16_matches_flax(shape, train):
    """flax nn.BatchNorm(dtype=bfloat16) on a bf16 input: float32
    statistics, float32 normalisation, a bf16 result; the port's BatchNorm
    writes both modes out, so it needs no mixed-dtype kernel."""
    rng = np.random.default_rng(4)
    x = bf16_input(5, shape) * 2.0 + 1.0
    c = shape[-1]
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    ref = fnn.BatchNorm(use_running_average=not train, momentum=0.97,
                        epsilon=1e-3, dtype=_BF16)
    out = ref.apply(variables, jnp.asarray(x, _BF16),
                    mutable=["batch_stats"] if train else False)
    want, mutated = out if train else (out, None)
    bn = layers.BatchNorm(c, eps=1e-3, momentum=0.03)
    load_jax_variables(bn, variables)
    bn.train(train)
    with torch.no_grad():
        got = nhwc(bn(nchw(x)))
    assert_bf16_close(got, want, ulps=1, what="bn")
    if train:
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, name).numpy(),
                np.asarray(mutated["batch_stats"][key]), rtol=0, atol=1e-6)
    assert bn.running_mean.dtype == torch.float32


def test_squeeze_excitation_bf16_matches_jax():
    """SE on bf16 activations: the mean in bf16, the two 1x1 convs (with
    bias) in bf16, the gate times x in bf16."""
    shape = (2, 6, 6, 32)
    jmod = jax_layers.SqueezeExcitation(8, dtype=_BF16)
    x = bf16_input(2, shape)
    variables, pmod = _pair(jmod, layers.SqueezeExcitation(32, 8),
                            jnp.zeros(shape, _BF16))
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x, _BF16))
    with torch.no_grad():
        got = nhwc(pmod(nchw(x)))
    assert_bf16_close(got, want, what="se")


def test_dense_bf16_matches_flax():
    """A classifier's Dense layer: input and kernel in bf16, the bias
    added in bf16."""
    x = bf16_input(3, (4, 40))
    jmod = fnn.Dense(10, dtype=_BF16)
    variables, pmod = _pair(jmod, layers.Linear(40, 10),
                            jnp.zeros((4, 40), jnp.float32))
    want = jmod.apply(variables, x)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    assert_bf16_close(got, want, what="dense")


def test_vgg_l2_rescale_bf16_matches_jax():
    """VGG's conv4_3 rescale on bf16 activations, the JAX expression of
    demonet_tpu/models/vgg.py:129-132: the sum of squares in bf16 and the
    float32 scale cast to x's dtype."""
    x = np.abs(bf16_input(6, (2, 9, 9, 64)))
    scale = np.random.default_rng(7).uniform(10, 30, 64).astype(np.float32)
    xj = jnp.asarray(x, _BF16)

    @jax.jit
    def jax_rescale(x, scale):
        norm = jnp.sqrt(jnp.sum(jnp.square(x), axis=-1, keepdims=True))
        return scale.astype(x.dtype) * x / jnp.maximum(norm, 1e-12)

    want = jax_rescale(xj, scale)
    got = nhwc(l2_rescale(nchw(x), torch.from_numpy(scale)))
    assert_bf16_close(got, want, what="l2_rescale")


@pytest.mark.parametrize("hw", [(10, 10), (19, 19), (5, 7)])
def test_pelee_ceil_avg_pool_bf16_matches_jax(hw):
    """Pelee's 2x2 ceil-mode average pool on bf16 activations: partial
    windows divided by their count, which JAX counts in x's dtype."""
    x = bf16_input(8, (2, *hw, 16))
    want = jax.jit(functools.partial(jax_avg_pool, k=2, s=2,
                                     ceil_mode=True))(jnp.asarray(x, _BF16))
    got = nhwc(avg_pool_torch(nchw(x), 2, 2, ceil_mode=True))
    assert_bf16_close(got, want, ulps=1, what=f"avg_pool {hw}")


# the heads on bf16 feature maps: channels, sizes, anchors per level
_HEAD_IN = ((24, 5), (32, 3), (16, 1))
_ANCHORS = (4, 6, 6)


def _heads():
    c = [ch for ch, _ in _HEAD_IN]
    return {
        "ssdlite": (jax_heads.SSDLiteHead(_ANCHORS, 7, dtype=_BF16),
                    heads.SSDLiteHead(c, _ANCHORS, 7)),
        "ssdlite_last_plain": (
            jax_heads.SSDLiteHead(_ANCHORS, 7, bn_eps=1e-5, bn_momentum=0.9,
                                  last_plain=True, dtype=_BF16),
            heads.SSDLiteHead(c, _ANCHORS, 7, bn_momentum=0.1, bn_eps=1e-5,
                              last_plain=True)),
        "ssd": (jax_heads.SSDHead(_ANCHORS, 7, dtype=_BF16),
                heads.SSDHead(c, _ANCHORS, 7)),
        "pelee_1x1": (jax_heads.Pelee1x1Head(_ANCHORS, 7, dtype=_BF16),
                      heads.Pelee1x1Head(c, _ANCHORS, 7)),
    }


@pytest.mark.parametrize("name", sorted(_heads()))
def test_heads_bf16_match_jax(name):
    """Each head's convs in bf16 and its concatenation of the levels in
    bf16 (demonet_tpu/models/heads.py:33)."""
    jmod, pmod = _heads()[name]
    feats = [bf16_input(10 + i, (2, s, s, ch))
             for i, (ch, s) in enumerate(_HEAD_IN)]
    variables, pmod = _pair(jmod, pmod, [jnp.zeros(f.shape, _BF16)
                                         for f in feats])
    want = jax.jit(jmod.apply)(variables,
                               [jnp.asarray(f, _BF16) for f in feats])
    pmod.eval()
    with torch.no_grad():
        got = pmod([nchw(f) for f in feats])
    for key in ("cls_logits", "bbox_regression"):
        assert_bf16_close(got[key], want[key], what=f"{name} {key}")


def test_float32_compute_casts_nothing():
    """The default dtype leaves a float64 module in float64 (the float64
    step tests run `.double()` models) and takes torch's own forwards."""
    block = layers.ConvBNAct(4, 8, 3).double().eval()
    x = torch.randn(1, 4, 5, 5, dtype=torch.float64)
    assert block.conv.dtype == torch.float32
    assert block(x).dtype == torch.float64
    layers.set_compute_dtype(block, torch.bfloat16)
    assert block.conv.dtype == torch.bfloat16
    assert layers.compute_dtype(block) == torch.bfloat16
