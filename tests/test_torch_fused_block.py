"""Port vs JAX package: the fused inverted-residual block
(demonet_tpu_torch.ops.fused_block) and BN folding.

One JAX `InvertedResidualV3` with jittered weights and BN statistics is
carried into the port's `InvertedResidualV3` by `load_jax_variables`.
On CPU tensors `fused_inverted_residual` runs its plain version (the
folded `F.conv2d` sequence); it must agree, at rtol/atol 2e-5 as in
tests/test_fused_block.py, with the JAX kernel in interpret mode, with the
JAX module, and with the port's unfused module. Folding reassociates one
multiply and the convs sum in another order, hence a tolerance and not
bit-equality. The port is NCHW, the JAX package NHWC. The CUDA kernel
(csrc/fused_block.cu) is held to the plain version on the card by
chip_smoke.py.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.models import layers as jax_layers
from demonet_tpu.ops import fused_block as jax_fb
from demonet_tpu_torch.models import layers as port_layers
from demonet_tpu_torch.ops import fused_block as port_fb
from demonet_tpu_torch.utils.weights import load_jax_variables

_TOL = dict(rtol=2e-5, atol=2e-5)


def _blocks(in_ch, exp_ch, out_ch, stride, use_hs, h, w, b=2, seed=0):
    """Input (NHWC numpy), the JAX block and variables, and the port block
    holding the same weights."""
    blk = jax_layers.InvertedResidualV3(in_ch, exp_ch, out_ch, 3, stride,
                                        use_se=False, use_hs=use_hs)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, in_ch)).astype(np.float32)
    variables = flax.core.unfreeze(
        blk.init(jax.random.PRNGKey(seed), jnp.asarray(x)))

    def jitter(tree):
        return {k: jitter(v) if isinstance(v, dict) else np.array(
            v + rng.normal(size=np.shape(v)).astype(np.float32) * 0.3,
            np.float32) for k, v in tree.items()}

    variables = {"params": jitter(variables["params"]),
                 "batch_stats": jitter(variables["batch_stats"])}
    # BN variances must stay positive after the jitter
    for stats in variables["batch_stats"].values():
        stats["bn"]["var"] = np.abs(stats["bn"]["var"]) + 0.1
    port = port_layers.InvertedResidualV3(in_ch, exp_ch, out_ch, 3, stride,
                                          use_hs=use_hs).eval()
    load_jax_variables(port, variables)
    return x, blk, variables, port


def _jax_outputs(x, blk, variables, exp_ch, in_ch, stride, act):
    want = np.asarray(blk.apply(variables, jnp.asarray(x), train=False))
    p, s = variables["params"], variables["batch_stats"]
    fold = lambda name: jax_fb.fold_conv_bn(p[name], s[name])  # noqa: E731
    kernel = np.asarray(jax_fb.fused_inverted_residual(
        jnp.asarray(x), fold("expand_conv") if exp_ch != in_ch else None,
        fold("depthwise"), fold("project"), stride=stride, act=act,
        row_tile=8, interpret=True))
    return want, kernel


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("in_ch,exp_ch,out_ch,stride,hs,h,w", [
    (16, 16, 16, 1, False, 16, 16),   # block 0: no expand, residual
    (16, 64, 24, 2, False, 16, 16),   # block 1: expand, stride 2
    (24, 72, 24, 1, False, 16, 16),   # block 2: expand, residual
    (24, 72, 40, 1, True, 16, 16),    # hard-swish
    (16, 64, 24, 2, False, 12, 8),    # rows not a multiple of the tile
    (16, 16, 16, 1, False, 10, 8),
], ids=["block0", "block1", "block2", "hswish", "s2-12x8", "s1-10x8"])
def test_fused_block_matches_jax(in_ch, exp_ch, out_ch, stride, hs, h, w):
    act = "hswish" if hs else "relu"
    x, blk, variables, port = _blocks(in_ch, exp_ch, out_ch, stride, hs, h, w)
    want_module, want_kernel = _jax_outputs(x, blk, variables, exp_ch, in_ch,
                                            stride, act)
    folded = port_fb.fold_inverted_residual(port)
    assert folded["stride"] == stride and folded["act"] == act
    assert (folded["expand"] is None) == (exp_ch == in_ch)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = port_fb.fused_inverted_residual(xt, **folded)
        unfused = port(xt)
    assert got.shape == unfused.shape == (2, out_ch, -(-h // stride),
                                          -(-w // stride))
    np.testing.assert_allclose(_nhwc(got), want_kernel, **_TOL)
    np.testing.assert_allclose(_nhwc(got), want_module, **_TOL)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), **_TOL)


@pytest.mark.parametrize("eps", [1e-3, 1e-5], ids=["v3-eps", "v2-eps"])
def test_fold_conv_bn_matches_jax(eps):
    rng = np.random.default_rng(1)
    params = {"conv": {"kernel": rng.normal(size=(1, 1, 8, 12))},
              "bn": {"scale": rng.uniform(0.5, 1.5, 12),
                     "bias": rng.normal(size=12)}}
    stats = {"bn": {"mean": rng.normal(size=12),
                    "var": rng.uniform(1e-4, 1e-2, 12)}}
    params = jax.tree_util.tree_map(lambda v: v.astype(np.float32), params)
    stats = jax.tree_util.tree_map(lambda v: v.astype(np.float32), stats)
    want = jax_fb.fold_conv_bn(params, stats, eps=eps)
    layer = port_layers.ConvBNAct(8, 12, 1, bn_eps=eps).eval()
    load_jax_variables(layer, {"params": params, "batch_stats": stats})
    got = port_fb.fold_conv_bn(layer)
    np.testing.assert_allclose(got["weight"].permute(2, 3, 1, 0).numpy(),
                               np.asarray(want["kernel"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["bias"].numpy(), np.asarray(want["bias"]),
                               rtol=1e-6, atol=1e-7)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    x, _, _, port = _blocks(24, 72, 24, 1, False, 8, 8, seed=3)
    folded = port_fb.fold_inverted_residual(port)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    before = port_fb.fused_inverted_residual.launches
    with torch.no_grad():
        got = port_fb.fused_inverted_residual(xt, **folded)
        want = port_fb.fused_inverted_residual_plain(xt, **folded)
    assert torch.equal(got, want)
    assert port_fb.fused_inverted_residual.launches == before == 0


def test_fold_rejects_blocks_with_squeeze_excite():
    blk = port_layers.InvertedResidualV3(16, 64, 24, 3, 1, use_se=True)
    with pytest.raises(ValueError, match="squeeze-excite"):
        port_fb.fold_inverted_residual(blk)


def _bad_call(case):
    _, _, _, port = _blocks(16, 64, 24, 2, False, 8, 8, seed=4)
    kw = port_fb.fold_inverted_residual(port)
    x = torch.zeros(2, 16, 8, 8)
    if case == "float64":
        x = x.double()
    elif case == "not-nchw":
        x = x[0]
    elif case == "channels":
        x = torch.zeros(2, 12, 8, 8)
    elif case == "stride":
        kw["stride"] = 3
    elif case == "act":
        kw["act"] = "gelu"
    elif case == "meta":
        x = x.to("meta")
    with torch.no_grad():
        port_fb.fused_inverted_residual(x, **kw)


@pytest.mark.parametrize("case,err", [
    ("float64", TypeError), ("not-nchw", ValueError),
    ("channels", ValueError), ("stride", ValueError), ("act", ValueError),
    ("meta", ValueError),
])
def test_wrapper_rejects_bad_inputs(case, err):
    with pytest.raises(err):
        _bad_call(case)
