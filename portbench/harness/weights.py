"""The weights both sides get: seeded, or read from a checked npz.

Seeded weights are drawn on the device from the run's seed in one call:
every conv weight is a slice of one normal draw times the standard
deviation its configuration's `init` rule names for it (the first rule
whose pattern matches the conv's module name); conv biases are 0, BN
scales 1 and offsets 0, running means 0 and variances 1, and VGG's L2
scale 20, as the reference nets are built.
"""

from __future__ import annotations

import hashlib
import io
import math
import re
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from harness import frames


def npz_arrays(path: str, sha256: str) -> Dict[str, np.ndarray]:
    """The arrays of the npz at `path`, after its sha256 is checked."""
    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != sha256:
        raise ValueError(f"{path}: sha256 {digest}, expected {sha256}")
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


def _std(kind: str, w: torch.Tensor) -> float:
    receptive = math.prod(w.shape[2:])
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    if kind == "kaiming_out":
        return math.sqrt(2.0 / fan_out)
    if kind == "lecun":
        return math.sqrt(1.0 / fan_in)
    if kind == "xavier":
        return math.sqrt(2.0 / (fan_in + fan_out))
    if kind.startswith("normal:"):
        return float(kind.split(":", 1)[1])
    raise ValueError(f"unknown init kind {kind!r}")


def seeded_state(net: nn.Module, rules: Sequence[Sequence[str]], seed: int
                 ) -> Dict[str, torch.Tensor]:
    """Fill `net`'s conv weights from the seed (see the module doc) and
    return a copy of its state_dict."""
    convs = [(name, m) for name, m in net.named_modules()
             if isinstance(getattr(m, "weight", None), torch.Tensor)
             and m.weight.ndim == 4]
    device = convs[0][1].weight.device
    total = sum(m.weight.numel() for _, m in convs)
    draw = torch.randn(total, generator=frames.torch_generator(
        seed, frames.WEIGHTS, device), device=device)
    at = 0
    with torch.no_grad():
        for name, m in convs:
            kind = next(k for pattern, k in rules if re.search(pattern, name))
            n = m.weight.numel()
            m.weight.copy_(draw[at:at + n].view_as(m.weight)
                           * _std(kind, m.weight))
            at += n
            if m.bias is not None:
                m.bias.zero_()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def load_into(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy `state` into every parameter and buffer of `module` (BN's
    `num_batches_tracked` aside); a missing, extra or misshapen entry
    raises."""
    own = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing: List[str] = sorted(set(own) - set(state))
    extra: List[str] = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not fit {type(module).__name__}: missing "
                       f"{missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for k, v in own.items():
            if v.shape != state[k].shape:
                raise ValueError(f"{k}: {tuple(state[k].shape)} into "
                                 f"{tuple(v.shape)}")
            v.copy_(state[k])
