"""Port vs JAX package: the fused inverted-residual block at the
MobileNetV2 and MobileNetV3-Small shapes, in channels_last, and a
test-only model of the CUDA kernel's tiling.

The folded weights are made with numpy from a seed at He-like scale
(1/sqrt(fan_in)), so outputs stay O(1), and go to both packages as they
are: the JAX kernel runs in interpret mode, as tests/test_fused_block.py
runs it. On CPU tensors the port's wrapper runs its plain version.

`_kernel_model` computes the block as csrc/fused_block.cu does, from the
plan that `tile_plan` picks or one given: 2-D output tiles with their
halo, expanded channels in zero-padded chunks, each warp's share of the
project's m-tiles and CO n-tiles, and the 1x1 products as the kernel's
three TF32 products (a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, TF32 rounding as
cvt.rna does it). It must agree with the JAX kernel at rtol/atol 2e-5, the
tolerance of tests/test_fused_block.py: an index fault in the tiling
shows here before any time on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.ops import fused_block as jax_fb
from demonet_tpu_torch.ops import fused_block as port_fb

_TOL = dict(rtol=2e-5, atol=2e-5)


def _folded(ci, ce, co, has_expand, seed):
    """Folded weights as numpy in the port's layout (OIHW), He-like."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k, fan_in):
        return (rng.normal(size=(o, i, k, k)) / np.sqrt(fan_in)).astype(
            np.float32)

    def bias(n):
        return (rng.normal(size=n) * 0.1).astype(np.float32)

    return {"expand": ({"weight": conv(ce, ci, 1, ci), "bias": bias(ce)}
                       if has_expand else None),
            "depthwise": {"weight": conv(ce, 1, 3, 9), "bias": bias(ce)},
            "project": {"weight": conv(co, ce, 1, ce), "bias": bias(co)}}


def _to_torch(folded):
    return {k: None if v is None else {n: torch.from_numpy(a)
                                       for n, a in v.items()}
            for k, v in folded.items()}


def _jax_kernel(x_nhwc, folded, stride, act):
    """The JAX kernel (interpret mode) on the same folded weights: OIHW ->
    HWIO kernels."""
    def k(p):
        return None if p is None else {
            "kernel": jnp.asarray(p["weight"].transpose(2, 3, 1, 0)),
            "bias": jnp.asarray(p["bias"])}

    return np.asarray(jax_fb.fused_inverted_residual(
        jnp.asarray(x_nhwc), k(folded["expand"]), k(folded["depthwise"]),
        k(folded["project"]), stride=stride, act=act, interpret=True))


def _input(b, h, w, ci, seed):
    return np.random.default_rng(seed + 100).normal(
        size=(b, h, w, ci)).astype(np.float32)


# (CI, CE, CO, stride, act, H, W): MobileNetV2 (relu6) and V3-Small shapes
_SHAPES = {
    "v2-no-expand-32-16": (32, 32, 16, 1, "relu6", 8, 8),
    "v2-16-96-24-s2": (16, 96, 24, 2, "relu6", 12, 12),
    "v2-160-960-320": (160, 960, 320, 1, "relu6", 6, 6),
    "v2-24-144-32-s2-odd": (24, 144, 32, 2, "relu6", 9, 7),
    "v2-96-576-96-residual": (96, 576, 96, 1, "relu6", 5, 5),
    "v3s-16-72-24-s2-odd": (16, 72, 24, 2, "relu", 11, 13),
}


@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_wrapper_matches_jax_kernel(name):
    ci, ce, co, stride, act, h, w = _SHAPES[name]
    folded = _folded(ci, ce, co, ce != ci, seed=len(name))
    x = _input(2, h, w, ci, seed=len(name))
    want = _jax_kernel(x, folded, stride, act)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)        # channels_last view
    got = port_fb.fused_inverted_residual(xt, **_to_torch(folded),
                                          stride=stride, act=act)
    assert got.shape == (2, co, -(-h // stride), -(-w // stride))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **_TOL)


@pytest.mark.parametrize("name", ["v2-no-expand-32-16",
                                  "v2-24-144-32-s2-odd",
                                  "v3s-16-72-24-s2-odd"])
def test_channels_last_input_same_as_contiguous(name):
    ci, ce, co, stride, act, h, w = _SHAPES[name]
    folded = _to_torch(_folded(ci, ce, co, ce != ci, seed=3))
    x = torch.from_numpy(_input(2, h, w, ci, seed=3)).permute(0, 3, 1, 2)
    cl = x.contiguous(memory_format=torch.channels_last)
    nchw = x.contiguous()
    assert cl.is_contiguous(memory_format=torch.channels_last)
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    got_cl = port_fb.fused_inverted_residual(cl, **folded, stride=stride,
                                             act=act)
    got = port_fb.fused_inverted_residual(nchw, **folded, stride=stride,
                                          act=act)
    np.testing.assert_allclose(got_cl.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


# -- the kernel's tiling -------------------------------------------------


def _tf32(a):
    """cvt.rna.tf32.f32: 10 mantissa bits, nearest, ties away from zero."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernel's three TF32 products, summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_model(x, folded, stride, act, plan):
    """csrc/fused_block.cu's decomposition in torch: x (B, H, W, CI)."""
    b, h, w, ci = x.shape
    f = _to_torch(folded)
    ce, co = f["depthwise"]["weight"].shape[0], f["project"]["weight"].shape[0]
    has_expand = f["expand"] is not None
    lay = port_fb.plan_layout(ci, ce, co, stride, has_expand, plan)
    th, tw, ec = plan.th, plan.tw, plan.ec
    ih, iw, mp_in, kx = lay["ih"], lay["iw"], lay["mp_in"], lay["kx"]
    mp_out, wpm, npw = lay["mt_out"] * 16, lay["wpm"], lay["npw"]
    ci8, co8 = -(-ci // 8) * 8, -(-co // 8) * 8
    n_nt, cep = co8 // 8, lay["n_chunks"] * ec
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1

    # weights zero-padded to whole chunks and to CI, CO multiples of 8
    we = torch.zeros(ci8, cep)
    be = torch.zeros(cep)
    if has_expand:
        we[:ci, :ce] = f["expand"]["weight"][:, :, 0, 0].T
        be[:ce] = f["expand"]["bias"]
    wd = torch.zeros(9, cep)
    wd[:, :ce] = f["depthwise"]["weight"].reshape(ce, 9).T
    bd = torch.zeros(cep)
    bd[:ce] = f["depthwise"]["bias"]
    wp = torch.zeros(cep, co8)
    wp[:ce, :co] = f["project"]["weight"][:, :, 0, 0].T

    px = torch.arange(mp_in)
    ly, lx = px // iw, px % iw
    q = torch.arange(th * tw)
    qy, qx = q // tw, q % tw
    base = qy * stride * iw + qx * stride
    xt = torch.from_numpy(x)
    out = torch.full((b, ho, wo, co), float("nan"))
    for img in range(b):
        for ty in range(-(-ho // th)):
            for tx in range(-(-wo // tw)):
                iy = ty * th * stride - 1 + ly
                ix = tx * tw * stride - 1 + lx
                ok = (px < ih * iw) & (iy >= 0) & (iy < h) & (ix >= 0) \
                    & (ix < w)
                xs = torch.zeros(mp_in, kx)
                xs[ok, :ci] = xt[img, iy[ok], ix[ok]]
                acc = torch.zeros(mp_out, co8)
                for c in range(lay["n_chunks"]):
                    sl = slice(c * ec, (c + 1) * ec)
                    if not has_expand:
                        e = xs[:, sl]
                    else:
                        prod = _mm3(xs[:, :ci8], we[:, sl]) + be[sl]
                        e = torch.where(ok[:, None], port_fb._act(prod, act),
                                        0.0)
                    dsum = sum(e[base + dy * iw + dx] * wd[dy * 3 + dx, sl]
                               for dy in range(3) for dx in range(3))
                    d = torch.zeros(mp_out, ec)
                    d[:th * tw] = port_fb._act(dsum + bd[sl], act)
                    for warp in range(8):
                        mt = warp // wpm
                        nb = (warp % wpm) * npw
                        nn = min(npw, n_nt - nb)
                        if mt * 16 >= mp_out or nn <= 0:
                            continue
                        rows = slice(mt * 16, mt * 16 + 16)
                        cols = slice(nb * 8, (nb + nn) * 8)
                        acc[rows, cols] += _mm3(d[rows], wp[sl, cols])
                oy, ox = ty * th + qy, tx * tw + qx
                inside = (oy < ho) & (ox < wo)
                res = acc[:th * tw, :co] + f["project"]["bias"]
                if stride == 1 and ci == co:
                    res = res + xs[(qy + 1) * iw + qx + 1, :co]
                out[img, oy[inside], ox[inside]] = res[inside]
    return out.numpy()


# (CI, CE, CO, stride, act, H, W, plan or None for tile_plan's)
_MODEL_CASES = {
    "s1-residual-ragged": (24, 72, 24, 1, "relu", 10, 11,
                           port_fb.Plan(3, 4, 24)),
    "s2-odd": (16, 64, 24, 2, "relu6", 11, 9, port_fb.Plan(2, 3, 16)),
    "no-expand-chunks": (32, 32, 16, 1, "relu6", 7, 9, port_fb.Plan(4, 4, 8)),
    "no-expand-residual": (16, 16, 16, 1, "relu", 9, 9,
                           port_fb.Plan(3, 5, 16)),
    "co-tiles-8-warps": (160, 960, 320, 1, "relu6", 6, 6,
                         port_fb.Plan(2, 6, 32)),
    "co-tiles-auto": (160, 960, 320, 1, "relu6", 6, 6, None),
    "hswish-partial-chunk": (24, 88, 40, 1, "hswish", 8, 8,
                             port_fb.Plan(4, 8, 32)),
    "ci-not-multiple-of-8": (20, 60, 20, 1, "relu", 7, 6,
                             port_fb.Plan(3, 3, 16)),
    "ci16-expand-s2": (16, 64, 24, 2, "relu", 10, 10, port_fb.Plan(4, 4, 16)),
    "v3l-block1-auto": (16, 64, 24, 2, "relu", 16, 16, None),
}


@pytest.mark.parametrize("name", sorted(_MODEL_CASES))
def test_kernel_tiling_model_matches_jax_kernel(name):
    ci, ce, co, stride, act, h, w, plan = _MODEL_CASES[name]
    if plan is None:
        plan = port_fb.tile_plan(ci, ce, co, h, w, stride, ce != ci)
    folded = _folded(ci, ce, co, ce != ci, seed=7)
    x = _input(2, h, w, ci, seed=7)
    want = _jax_kernel(x, folded, stride, act)
    got = _kernel_model(x, folded, stride, act, plan)
    np.testing.assert_allclose(got, want, **_TOL)


def test_tf32_split_keeps_fp32_accuracy():
    """The three-product split's error is fp32 rounding, not TF32's."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(64, 160)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(160, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    err3 = ((_mm3(a, b).double() - exact).abs() / scale).max().item()
    err1 = ((_tf32(a) @ _tf32(b)).double() - exact).abs().div(scale).max()
    assert err3 < 2e-6 < float(err1)
    assert _tf32(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10
    assert _tf32(torch.tensor([-1.0 - 2.0 ** -11])).item() == -1.0 - 2.0 ** -10


# -- the plan on every block of the contract -----------------------------


def _contract_blocks():
    """(name, CI, CE, CO, H, W, stride, has_expand) of every eligible block
    at a 320x320 image: MobileNetV3-Large blocks 0-2, MobileNetV3-Small's
    16 -> 72 -> 24 and 24 -> 88 -> 24, MobileNetV2's 17 blocks."""
    blocks = [("v3l-0", 16, 16, 16, 160, 160, 1, False),
              ("v3l-1", 16, 64, 24, 160, 160, 2, True),
              ("v3l-2", 24, 72, 24, 80, 80, 1, True),
              ("v3s-1", 16, 72, 24, 80, 80, 2, True),
              ("v3s-2", 24, 88, 24, 40, 40, 1, True)]
    c, hw = 32, 160
    for t, oc, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                        (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                        (6, 320, 1, 1)):
        for r in range(n):
            st = s if r == 0 else 1
            blocks.append((f"v2-{len(blocks) - 4}", c, c * t, oc, hw, hw, st,
                           t != 1))
            hw, c = (hw - 1) // st + 1, oc
    return blocks


@pytest.mark.parametrize("block", _contract_blocks(), ids=lambda b: b[0])
def test_tile_plan_fits_every_contract_block(block):
    _, ci, ce, co, h, w, stride, has_expand = block
    plan = port_fb.tile_plan(ci, ce, co, h, w, stride, has_expand)
    lay = port_fb.plan_layout(ci, ce, co, stride, has_expand, plan)
    assert plan.th * plan.tw <= 128 and plan.ec in (8, 16, 24, 32)
    assert lay["smem_bytes"] <= port_fb._SMEM_BYTES
    assert lay["npw"] <= 20 and lay["mt_out"] <= 8
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert plan.th <= ho and plan.tw <= wo


def test_tile_plan_names_its_limits():
    with pytest.raises(ValueError, match="CO=648 > 640"):
        port_fb.tile_plan(64, 384, 648, 20, 20, 1, True)
    with pytest.raises(ValueError, match="CI=8192"):
        port_fb.tile_plan(8192, 8192, 64, 8, 8, 2, True)


def test_tile_plan_takes_least_work_where_two_blocks_need_a_thin_tile():
    """MobileNetV2's 160 -> 960 -> 320 block on a 10 x 10 image at b32 on
    132 SMs: two blocks share an SM only with 2 x 10 tiles, whose halo
    doubles the expand's rows; the plan takes 5 x 5 tiles, one block an
    SM, the least work."""
    plan = port_fb.tile_plan(160, 960, 320, 10, 10, 1, True, 132 // 32)
    assert plan == port_fb.Plan(5, 5, 32)
    lay = port_fb.plan_layout(160, 960, 320, 1, True, plan)
    assert port_fb._SMEM_TWO_BLOCKS < lay["smem_bytes"] <= port_fb._SMEM_BYTES
