"""PeleeNet and the Pelee-SSD extractor (counterpart of
demonet_tpu/models/peleenet.py).

  * the PeleeNet classifier: the two-way stem block, two-branch dense
    layers, dense blocks (3, 4, 8, 6) with growth 32 and bottleneck
    widths (1, 2, 4, 4), 1x1 transitions with ceil-mode average pooling,
    and a 704-feature linear classifier;
  * `PeleeExtractor`: trunk taps at transition3 (19^2 x 512 at 304) and
    transition4 (10^2 x 704), 6 extra convs giving 5^2, 3^2 and 1^2 maps
    of 256, and a two-branch ResBlock per source: 5 maps of 256 for the
    1x1 heads.

Every BN has eps 1e-5 and torch momentum 0.1 (the JAX package's decay
0.9). Module names are the JAX package's (`stemblock`, `stem1`,
`denseblock1_layer1`, `branch1a`, `transition1`, `norm`, `extras_0`,
`resblock_0`, `res1a`), so `utils/weights.load_jax_variables` fills them
by rule.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from demonet_tpu_torch.models.layers import BatchNorm, Conv2d, Linear, dropout
from demonet_tpu_torch.models.vgg import max_pool_torch


def avg_pool_torch(x: torch.Tensor, k: int, s: int,
                   ceil_mode: bool = False) -> torch.Tensor:
    """Average pool on NCHW with no padding, as the JAX package writes it:
    in ceil mode a partial window at the high edge is divided by the
    count of its real elements. torch's ceil_mode with no padding divides
    by that count too (count_include_pad has nothing to count). The two
    frameworks add a window's values in other orders (XLA's order changes
    with the padding), so they agree to rounding, not bit for bit."""
    return F.avg_pool2d(x, k, s, ceil_mode=ceil_mode, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv (no bias) + BN + optional ReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, activation: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size,
                           stride=stride, padding=padding, bias=False)
        self.norm = BatchNorm(features, eps=1e-5, momentum=0.1)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return torch.relu(x) if self.activation else x


class DenseLayer(nn.Module):
    """Two-branch dense layer: a 1x1 + 3x3 branch and a 1x1 + 3x3 + 3x3
    branch, concatenated after the input."""

    def __init__(self, num_input_features: int, growth_rate: int,
                 bn_size: int):
        super().__init__()
        growth = growth_rate // 2
        inter = int(growth * bn_size / 4) * 4
        if inter > num_input_features / 2:
            inter = int(num_input_features / 8) * 4
        self.branch1a = BasicConv2d(num_input_features, inter, 1)
        self.branch1b = BasicConv2d(inter, growth, 3, padding=1)
        self.branch2a = BasicConv2d(num_input_features, inter, 1)
        self.branch2b = BasicConv2d(inter, growth, 3, padding=1)
        self.branch2c = BasicConv2d(growth, growth, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1b(self.branch1a(x))
        b2 = self.branch2c(self.branch2b(self.branch2a(x)))
        return torch.cat([x, b1, b2], dim=1)


class StemBlock(nn.Module):
    """Two-way stem, /4 resolution."""

    def __init__(self, num_init_features: int = 32):
        super().__init__()
        n = num_init_features
        self.stem1 = BasicConv2d(3, n, 3, stride=2, padding=1)
        self.stem2a = BasicConv2d(n, n // 2, 1)
        self.stem2b = BasicConv2d(n // 2, n, 3, stride=2, padding=1)
        self.stem3 = BasicConv2d(2 * n, n, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.stem1(x)
        b2 = self.stem2b(self.stem2a(out))
        b1 = max_pool_torch(out, 2, 2, ceil_mode=True)
        return self.stem3(torch.cat([b1, b2], dim=1))


class PeleeNetFeatures(nn.Module):
    """The trunk; forward(x, taps) returns the outputs at `taps`, indices
    into the torch Sequential [stem, (denseblock, transition[, pool]) x 4]
    numbering (8 = transition3), and the final transition4 output last."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (3, 4, 8, 6),
                 num_init_features: int = 32,
                 bn_size: Sequence[int] = (1, 2, 4, 4)):
        super().__init__()
        self.block_config = tuple(block_config)
        self.stemblock = StemBlock(num_init_features)
        n = num_init_features
        self.stage_channels = []   # channels of each transition's output
        for i, layers in enumerate(self.block_config):
            for j in range(layers):
                self.add_module(f"denseblock{i + 1}_layer{j + 1}", DenseLayer(
                    n + j * growth_rate, growth_rate, bn_size[i]))
            n += layers * growth_rate
            self.add_module(f"transition{i + 1}", BasicConv2d(n, n, 1))
            self.stage_channels.append(n)
        self.num_features = n

    def forward(self, x: torch.Tensor,
                taps: Sequence[int] = ()) -> List[torch.Tensor]:
        wanted = set(taps)
        outputs = []
        idx = 0

        def record(y):
            nonlocal idx
            if idx in wanted:
                outputs.append(y)
            idx += 1

        x = self.stemblock(x)
        record(x)
        last = len(self.block_config) - 1
        for i, layers in enumerate(self.block_config):
            for j in range(layers):
                x = getattr(self, f"denseblock{i + 1}_layer{j + 1}")(x)
            record(x)
            x = getattr(self, f"transition{i + 1}")(x)
            record(x)
            if i != last:
                x = avg_pool_torch(x, 2, 2, ceil_mode=True)
                record(x)
        outputs.append(x)
        return outputs


class PeleeNet(nn.Module):
    """The classifier: features, global mean pool, dropout, linear.

    Takes NHWC images (B, H, W, 3), as the JAX module does. In train mode
    with drop_rate > 0, forward needs a `generator` for the dropout mask
    (see layers.dropout)."""

    def __init__(self, num_classes: int = 1000, growth_rate: int = 32,
                 block_config: Sequence[int] = (3, 4, 8, 6),
                 num_init_features: int = 32,
                 bn_size: Sequence[int] = (1, 2, 4, 4),
                 drop_rate: float = 0.05):
        super().__init__()
        self.features = PeleeNetFeatures(growth_rate, block_config,
                                         num_init_features, bn_size)
        self.drop_rate = drop_rate
        self.classifier = Linear(self.features.num_features, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.features(x.permute(0, 3, 1, 2))[-1]
        x = dropout(feats.mean(dim=(2, 3)), self.drop_rate, self.training,
                    generator)
        return self.classifier(x)


class _ConvReLU(nn.Module):
    """conv (no bias) + ReLU, no BN."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 padding: int = 0):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size,
                           padding=padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x))


class ResBlock(nn.Module):
    """Two-branch refinement before the heads: 1x1-3x3-1x1 plus 1x1."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.res1a = _ConvReLU(in_channels, 128, 1)
        self.res1b = _ConvReLU(128, 128, 3, padding=1)
        self.res1c = _ConvReLU(128, 256, 1)
        self.res2a = _ConvReLU(in_channels, 256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res1c(self.res1b(self.res1a(x))) + self.res2a(x)


class PeleeExtractor(nn.Module):
    """PeleeNet trunk (taps transition3 and the final transition4) +
    extras + ResBlocks -> 5 maps of 256 channels (NCHW)."""

    # (features, kernel, stride, padding); every 2nd output is a source
    _extras = ((128, 1, 1, 0), (256, 3, 2, 1), (128, 1, 1, 0),
               (256, 3, 1, 0), (128, 1, 1, 0), (256, 3, 1, 0))

    def __init__(self):
        super().__init__()
        self.trunk = PeleeNetFeatures()
        ch = self.trunk.num_features
        extras = []
        for c, k, s, p in self._extras:
            extras.append(BasicConv2d(ch, c, k, stride=s, padding=p))
            ch = c
        self.extras = nn.ModuleList(extras)
        # transition3 (tap 8), transition4, and 3 extras
        sources = [*self.trunk.stage_channels[2:4], 256, 256, 256]
        self.resblock = nn.ModuleList(ResBlock(c) for c in sources)
        self.out_channels = [256] * 5

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        sources = self.trunk(x, taps=(8,))
        x = sources[-1]
        for k, block in enumerate(self.extras):
            x = block(x)
            if k % 2 == 1:
                sources.append(x)
        return [block(src) for block, src in zip(self.resblock, sources)]

