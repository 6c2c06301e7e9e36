"""Lane-packed convolutions and the space-to-depth stem (counterpart of
demonet_tpu/ops/lane_pack.py), on NCHW tensors.

Two layouts of the same math, with the same weights:

  * lane packing: p W-adjacent pixels go into the channel axis,
    PIXEL-MAJOR (packed channel = slot * C + c, as in the JAX package),
    so (B, C, H, W) becomes (B, p*C, H, W/p). A 1x1 conv becomes the
    block-diagonal conv kron(I_p, K); a 3x3 depthwise conv becomes a
    dense (p*C, p*C, KH, 3) conv over (H, packed W) whose kernel encodes
    the in-pack W shifts; a dense 3x3 conv becomes a (p*CO, p*CI, KH, 3)
    one. Strides 1 and 2 map onto a pack-level stride with a 3-pack
    window and 1-pack padding.
  * space-to-depth: the 3x3 stride-2 stem conv runs as a 2x2 stride-1
    conv over 2x2 pixel blocks moved into channels, block-major
    ((u, v, c) flattened), padded by one block on the top and left.

In NHWC, the JAX package's layout, packing is a free reshape; here it is
a reshape, a permute that puts the slot before the channel, and a
reshape: a copy. The kernel rearrangements are pure relayouts (copies of
the weight's entries into zeros), so they are bit-equal to the JAX
package's; the convolutions are F.conv2d calls on them, equal to the
unpacked convs up to the order of summation.

The rearranged kernels are built from the weight at every call, so the
gradient flows back to the unpacked weight, which is the one the modules
hold (models/layers.py: same state_dict keys and shapes either way).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from demonet_tpu_torch.parallel.dist import all_reduce_sum


def pack(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, p*C, H, W/p), pixel-major channels (a copy)."""
    if p == 1:
        return x
    b, c, h, w = x.shape
    if w % p:
        raise ValueError(f"width {w} is not a multiple of the pack {p}")
    return (x.reshape(b, c, h, w // p, p).permute(0, 4, 1, 2, 3)
            .reshape(b, p * c, h, w // p))


def unpack(x: torch.Tensor, p: int, c: int) -> torch.Tensor:
    """(B, p*C, H, Wp) -> (B, C, H, Wp*p)."""
    if p == 1:
        return x
    b, pc, h, wp = x.shape
    if pc != p * c:
        raise ValueError(f"{pc} channels are not {p} packs of {c}")
    return (x.reshape(b, p, c, h, wp).permute(0, 2, 3, 4, 1)
            .reshape(b, c, h, wp * p))


def repack(x: torch.Tensor, p_from: int, p_to: int, c: int) -> torch.Tensor:
    """Change the pack factor of a map of c true channels."""
    if p_from == p_to:
        return x
    return pack(unpack(x, p_from, c), p_to)


def _taps(p: int, stride: int):
    """(j, dx, pack offset, input slot) of each output slot j and W tap dx:
    output pixel stride*(p*J + j) + dx lives at pack stride*J + q // p,
    slot q % p, where q = stride*j + dx."""
    for j in range(p):
        for dx in (-1, 0, 1):
            q = stride * j + dx
            delta, j_in = q // p, q % p
            if not -1 <= delta <= 1:
                raise ValueError(f"pack {p} at stride {stride} reaches "
                                 f"beyond the next pack")
            yield j, dx, delta, j_in


def kron_1x1_kernel(weight: torch.Tensor, p: int) -> torch.Tensor:
    """(CO, CI, 1, 1) -> (p*CO, p*CI, 1, 1), block-diagonal per slot."""
    if p == 1:
        return weight
    co, ci = weight.shape[:2]
    blocks = torch.block_diag(*[weight.reshape(co, ci)] * p)
    return blocks.reshape(p * co, p * ci, 1, 1)


def packed_dw_kernel(weight: torch.Tensor, p: int, stride: int
                     ) -> torch.Tensor:
    """Depthwise (C, 1, KH, 3) -> dense (p*C, p*C, KH, 3) over packed W:
    tap dx of output slot j reads input slot j_in of the pack at offset
    delta (`_taps`), channel by channel."""
    c, _, kh, kw = weight.shape
    if kw != 3:
        raise ValueError(f"a packed depthwise conv is 3 wide, got {kw}")
    big = weight.new_zeros((p * c, p * c, kh, 3))
    ar = torch.arange(c, device=weight.device)
    for j, dx, delta, j_in in _taps(p, stride):
        big[j * c + ar, j_in * c + ar, :, delta + 1] = weight[:, 0, :, dx + 1]
    return big


def packed_dense_kernel(weight: torch.Tensor, p: int, stride: int = 1
                        ) -> torch.Tensor:
    """Dense (CO, CI, KH, 3) -> (p*CO, p*CI, KH, 3) over packed W: the
    mapping of packed_dw_kernel with whole channel-mixing blocks; the
    other blocks stay zero (p times the unpacked conv's products)."""
    co, ci, kh, kw = weight.shape
    if kw != 3:
        raise ValueError(f"a packed dense conv is 3 wide, got {kw}")
    big = weight.new_zeros((p * co, p * ci, kh, 3))
    for j, dx, delta, j_in in _taps(p, stride):
        big[j * co:(j + 1) * co, j_in * ci:(j_in + 1) * ci, :,
            delta + 1] = weight[:, :, :, dx + 1]
    return big


def conv_1x1_packed(x: torch.Tensor, weight: torch.Tensor, p: int
                    ) -> torch.Tensor:
    """Packed x (B, p*CI, H, Wp) through a 1x1 weight (CO, CI, 1, 1)."""
    return F.conv2d(x, kron_1x1_kernel(weight, p).to(x.dtype))


def conv_dw_packed(x: torch.Tensor, weight: torch.Tensor, p: int,
                   stride: int) -> torch.Tensor:
    """Packed depthwise: x (B, p*C, H, Wp), weight (C, 1, KH, 3). H keeps
    its pixel stride and same padding; packed W takes a 3-pack window at
    stride `stride` with 1-pack zero padding (out-of-pack taps reach only
    the adjacent packs)."""
    ph = (weight.shape[2] - 1) // 2
    return F.conv2d(x, packed_dw_kernel(weight, p, stride).to(x.dtype),
                    stride=stride, padding=(ph, 1))


def conv_dense_packed(x: torch.Tensor, weight: torch.Tensor, p: int,
                      stride: int = 1) -> torch.Tensor:
    """Packed x (B, p*CI, H, Wp) through a dense 3x3 weight (CO, CI, KH,
    3), padded as conv_dw_packed: the extra zero pixel that 1-pack padding
    implies beyond the true 1-pixel padding is never read."""
    ph = (weight.shape[2] - 1) // 2
    return F.conv2d(x, packed_dense_kernel(weight, p, stride).to(x.dtype),
                    stride=stride, padding=(ph, 1))


def packed_batch_stats(x: torch.Tensor, p: int, c: int, group=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per TRUE channel (mean, var) of packed activations (B, p*C, H, Wp),
    every pixel counted once: the unpacked BatchNorm's batch statistics,
    var = E[x^2] - E[x]^2 unclamped, as the JAX package computes them. In
    x's dtype: pass float32 (or float64). With `group`, the sums of x and
    x^2 and the count are those of every rank of the group (one SUM
    all-reduce, differentiated)."""
    b, pc, h, wp = x.shape
    v = x.reshape(b, p, c, h, wp)
    dims = (0, 1, 3, 4)
    stats = torch.cat([v.sum(dims), (v * v).sum(dims),
                       v.new_full((1,), v.numel() // c)])
    if group is not None:
        stats = all_reduce_sum(stats, group)
    moments = stats[:2 * c] / stats[2 * c]
    mean = moments[:c]
    return mean, moments[c:] - mean * mean


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, r*r*C, H/r, W/r), block-major channels
    ((u, v, c) flattened, u the row in the block): a pure relayout.
    F.pixel_unshuffle orders them (c, u, v) instead."""
    b, c, h, w = x.shape
    if h % r or w % r:
        raise ValueError(f"{h}x{w} is not a multiple of the block {r}")
    x = x.reshape(b, c, h // r, r, w // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, r * r * c, h // r, w // r)


# (kernel step, in-block offset) -> tap of the 3x3 stride-2 conv: input
# position 2i + d - 1 (padding 1) = 2a + u gives d=0 -> (a=i-1, u=1),
# d=1 -> (a=i, u=0), d=2 -> (a=i, u=1); (0, 0) is never read
_S2D_TAPS = {(0, 1): 0, (1, 0): 1, (1, 1): 2}


def s2d_stem_kernel(weight: torch.Tensor) -> torch.Tensor:
    """A (O, C, 3, 3) stride-2 conv weight -> the (O, 4C, 2, 2) weight of
    the SAME conv on space_to_depth(x, 2), at stride 1 with one block of
    padding on the top and the left."""
    o, c, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the space-to-depth stem is 3x3, got {kh}x{kw}")
    k2 = weight.new_zeros((o, 2, 2, c, 2, 2))      # (o, u, v, c, ka, kb)
    for (ka, u), di in _S2D_TAPS.items():
        for (kb, v), dj in _S2D_TAPS.items():
            k2[:, u, v, :, ka, kb] = weight[:, :, di, dj]
    return k2.reshape(o, 4 * c, 2, 2)


def conv_s2d_stem(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 3x3 stride-2 padding-1 conv of x (B, C, H, W) by weight (O, C,
    3, 3), computed on the space-to-depth layout (H and W even)."""
    return F.conv2d(F.pad(space_to_depth(x), (1, 0, 1, 0)),
                    s2d_stem_kernel(weight).to(x.dtype))


def packed_pool_2x2(x: torch.Tensor, c: int) -> torch.Tensor:
    """2x2 stride-2 max pool of a p = 2 packed map (B, 2C, H, W/2) ->
    (B, C, H/2, W/2), straight into the UNPACKED layout (each pack holds
    one window's W extent).

    The slot max first, with ties to the left pixel (`where(a >= b)`),
    then the max of each H pair (F.max_pool2d, ties to the top): the
    gradient goes to the first maximum of the window in row-major order,
    as the unpacked pool's does. NaN: a NaN left pixel loses the slot
    max to the right one (NaN >= x is false), where the unpacked pool
    would propagate it, as in the JAX package."""
    b, pc, h, wp = x.shape
    if pc != 2 * c or h % 2:
        raise ValueError(f"{tuple(x.shape)} is not a p = 2 map of {c} "
                         f"channels with an even height")
    a, bb = x[:, :c], x[:, c:]
    return F.max_pool2d(torch.where(a >= bb, a, bb), (2, 1), (2, 1))
