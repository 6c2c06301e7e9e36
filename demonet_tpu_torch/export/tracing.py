"""Generic `torch.export` -> Caffe conversion: the any-model route
(counterpart of demonet_tpu/export/tracing.py, whose walker reads a
jaxpr).

    from demonet_tpu_torch.export.tracing import trace_to_caffe
    net = trace_to_caffe(model, example, name="my_model")

The module is exported in eval mode with `torch.export.export` on the
example's device, and the ATen graph of `run_decompositions()` is walked
node by node, as the JAX walker walks the jaxpr. The example is one
(B, H, W, 3) image batch, the input every model of the port takes; the
Caffe input blob is its NCHW transpose. A module's outputs (a tensor, a
tuple, or a dict such as a detector's {'cls_logits', 'bbox_regression'})
become `net.output_tops`, in their flattening order.

Mechanics (the JAX walker's):
  * constants fold eagerly: a node whose inputs are all constants (the
    parameters, buffers and lifted constants of the program's signature,
    on the CPU) is evaluated with the ATen op itself, so the eval BN's
    rsqrt(var + eps) * weight collapses to per-channel constants (the BN
    op is decomposed into exactly that, `models/layers.py:215`, not mapped
    to a Caffe BatchNorm);
  * elementwise + - * / against per-channel or scalar constants (and a
    conv's or linear's bias) accumulate into a pending affine per tensor,
    flushed as ONE Scale (per channel) or Power (scalar) layer only when
    a non-affine consumer needs the value: conv + BN + activation gives
    Convolution / Scale / ReLU6;
  * layouts are tracked per tensor (caffe dim i holds the tensor's axis
    layout[i]). The port computes in NCHW, so only the input's NHWC ->
    NCHW permute and the heads' permute(0, 2, 3, 1) + reshape move them:
    a permute is a free relabelling, and a reshape or concat that needs
    torch's order in Caffe memory emits a Permute first - the Permute +
    Reshape + Concat tail of SSD deploy graphs;
  * clamp(x, min=0) -> ReLU, and a following clamp(max=6) upgrades it to
    ReLU6 in place; tensor * tensor -> Eltwise PROD; a (B, C, 1, 1) gate
    (SE blocks) -> Flatten + two-bottom Scale (the SENet deploy pattern);
  * mean over H and W -> a global AVE pool; average pools -> Caffe AVE
    pools only where Caffe's divisor (the window clipped to the padded
    bounds) equals torch's at every output, which it is not for
    count_include_pad=False with padding;
  * the conv4_3 L2 rescale (x*x -> channel sum -> sqrt -> clamp(min=eps)
    guard -> divide, times learned scales) -> the SSD fork's Normalize.

Anything else raises NotImplementedError naming the ATen op ("no Caffe
mapping"). tests/test_torch_caffe_tracing.py runs the emitted graphs
under export/caffe_eval.py against the port's forward.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.fx.node import Node, map_aggregate

from demonet_tpu_torch.export.caffe import CaffeNet
from demonet_tpu_torch.export.caffe_eval import ave_counts, pool_size

aten = torch.ops.aten
_NCHW = (0, 3, 1, 2)  # caffe dim i holds axis _NCHW[i] of an NHWC tensor


@dataclasses.dataclass
class _Tensor:
    top: str                       # caffe blob name
    shape: Tuple[int, ...]         # torch (logical) shape
    layout: Tuple[int, ...]        # caffe dim i <- torch axis layout[i]
    scale: Any = 1.0               # pending affine: value = raw*scale + shift
    shift: Any = 0.0               # float64 scalars or (C,) over caffe dim 1
    relu_layer: int = -1           # index of a just-emitted ReLU (for ReLU6)
    norm_of: Optional[Tuple[str, str]] = None  # (source top, stage) of the
    #   L2-Normalize chain x*x -> channel sum -> sqrt ("sq"/"sum"/"sqrt")

    @property
    def has_affine(self) -> bool:
        return not (np.isscalar(self.scale) and self.scale == 1.0
                    and np.isscalar(self.shift) and self.shift == 0.0)

    @property
    def channel_axis(self) -> Optional[int]:
        """The torch axis in caffe dim 1, where Scale layers act."""
        return self.layout[1] if len(self.layout) > 1 else None


class _Unmapped:
    """A value with no Caffe counterpart (max pool indices)."""

    def __init__(self, what: str):
        self.what = what


class _Converter:
    def __init__(self, net: CaffeNet):
        self.net = net
        self.env: Dict[Node, Any] = {}
        self.counters: Dict[str, int] = {}

    def name(self, kind: str) -> str:
        i = self.counters.get(kind, 0)
        self.counters[kind] = i + 1
        return f"{kind}{i}"

    def flush(self, t: _Tensor) -> _Tensor:
        """Materialise a pending affine as a Scale (per-channel) or Power
        (scalar) layer."""
        if t.norm_of is not None:
            raise NotImplementedError(
                "x^2/sum/sqrt chain consumed outside an L2-Normalize "
                "division")
        if not t.has_affine:
            return t
        if np.isscalar(t.scale) and np.isscalar(t.shift):
            top = self.net.power(self.name("affine"), t.top,
                                 scale=float(t.scale), shift=float(t.shift))
        else:
            c = t.shape[t.channel_axis]
            s = np.broadcast_to(np.asarray(t.scale).reshape(-1), (c,))
            b = np.broadcast_to(np.asarray(t.shift).reshape(-1), (c,))
            top = self.net.scale(self.name("scale"), t.top, s, b)
        return _Tensor(top, t.shape, t.layout)

    def channel_const(self, t: _Tensor, c) -> Any:
        """A constant as a float64 scalar or a (C,) vector over the axis in
        caffe dim 1, or None when it broadcasts any other way."""
        c = np.asarray(c.detach().cpu().double() if isinstance(
            c, torch.Tensor) else c, np.float64)
        if c.size == 1:
            return float(c.reshape(()))
        if c.ndim > len(t.shape):
            return None
        aligned = (1,) * (len(t.shape) - c.ndim) + c.shape
        axes = [i for i, d in enumerate(aligned) if d != 1]
        if (len(axes) == 1 and axes[0] == t.channel_axis
                and aligned[axes[0]] == t.shape[axes[0]]):
            return c.reshape(-1)
        return None

    @staticmethod
    def affine(t: _Tensor, scale, shift) -> _Tensor:
        """Compose (x*scale + shift) onto the pending affine."""
        return dataclasses.replace(
            t, scale=t.scale * scale, shift=t.shift * scale + shift,
            relu_layer=-1)

    def to_torch_order(self, t: _Tensor) -> _Tensor:
        """Permute caffe memory into torch's axis order (identity
        layout)."""
        ident = tuple(range(len(t.shape)))
        if t.layout == ident:
            return t
        t = self.flush(t)
        inv = [t.layout.index(j) for j in ident]
        top = self.net.permute(self.name("perm"), t.top, inv)
        return _Tensor(top, t.shape, ident)


def _constants(program: torch.export.ExportedProgram) -> Dict[str, Any]:
    """Placeholder name -> CPU value of every parameter, buffer and lifted
    constant of the program."""
    from torch.export.graph_signature import InputKind

    out = {}
    for spec in program.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            continue
        if spec.kind not in (InputKind.PARAMETER, InputKind.BUFFER,
                             InputKind.CONSTANT_TENSOR):
            raise NotImplementedError(f"program input {spec} has no Caffe "
                                      "mapping")
        value = (program.state_dict[spec.target]
                 if spec.target in program.state_dict
                 else program.constants[spec.target])
        out[spec.arg.name] = value.detach().cpu()
    return out


def _bn_eval(x, weight, bias, mean, var, momentum, eps):
    """Eval-mode batch norm written as `models/layers.py:215` writes it:
    its constants fold, and the rest is a per-channel affine."""
    view = (-1,) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mean.reshape(view)) * mul.reshape(view)
    if bias is not None:
        y = y + bias.reshape(view)
    return y, x.new_empty(0), x.new_empty(0)


class _Function(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _export_program(module_or_fn, example: torch.Tensor
                   ) -> torch.export.ExportedProgram:
    """The eval-mode ATen program of module_or_fn(example), on the
    example's device, the BN decomposed into elementwise ops."""
    module = (module_or_fn if isinstance(module_or_fn, nn.Module)
              else _Function(module_or_fn))
    training = module.training
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, (example,))
    finally:
        module.train(training)
    table = torch.export.default_decompositions()
    table[aten._native_batch_norm_legit_no_training.default] = _bn_eval
    return program.run_decompositions(table)


def trace_to_caffe(module_or_fn, example: torch.Tensor, name: str = "model",
                   input_name: str = "data") -> CaffeNet:
    """Export module_or_fn(example) (one (B, H, W, 3) image batch) and emit
    the equivalent CaffeNet; `net.output_tops` names its outputs."""
    program = _export_program(module_or_fn, example)
    net = CaffeNet(name)
    cv = _Converter(net)
    b, h, w, c = example.shape
    top = net.input(input_name, [b, c, h, w])
    consts = _constants(program)
    for node in program.graph.nodes:
        if node.op == "placeholder":
            cv.env[node] = (consts[node.name] if node.name in consts
                            else _Tensor(top, tuple(example.shape), _NCHW))
        elif node.op == "call_function":
            _convert(cv, node)
        elif node.op == "output":
            for out in node.args[0]:
                t = cv.env[out]
                if isinstance(t, _Tensor):
                    net.output_tops.append(
                        cv.to_torch_order(cv.flush(t)).top)
    return net


def _shape(node: Node) -> Tuple[int, ...]:
    return tuple(int(d) for d in node.meta["val"].shape)


def _convert(cv: _Converter, node: Node) -> None:
    args = map_aggregate(node.args,
                         lambda a: cv.env[a] if isinstance(a, Node) else a)
    kwargs = map_aggregate(node.kwargs,
                           lambda a: cv.env[a] if isinstance(a, Node) else a)
    if node.target is operator.getitem:
        cv.env[node] = args[0][args[1]]
        return
    flat = []
    map_aggregate((args, kwargs), lambda a: flat.append(a))
    for a in flat:
        if isinstance(a, _Unmapped):
            raise NotImplementedError(
                f"{a.what} read by {node.target} have no Caffe mapping")
    if not any(isinstance(a, _Tensor) for a in flat):
        # every input a constant: evaluate the op itself, on the CPU
        if "device" in kwargs:
            kwargs = dict(kwargs, device=torch.device("cpu"))
        cv.env[node] = node.target(*args, **kwargs)
        return
    packet = getattr(node.target, "overloadpacket", None)
    handler = _HANDLERS.get(packet)
    if handler is None:
        raise NotImplementedError(
            f"ATen op {node.target} has no Caffe mapping (input shapes "
            f"{[getattr(a, 'shape', None) for a in flat]})")
    handler(cv, node, args, kwargs)


# ---------------------------------------------------------------------------
# ATen op handlers
# ---------------------------------------------------------------------------


def _isotropic(values: Sequence[int], what: str) -> int:
    if len(set(values)) != 1:
        raise NotImplementedError(f"anisotropic {what} {list(values)}")
    return int(values[0])


def _h_conv(cv: _Converter, node: Node, args, kwargs):
    (t, weight, bias, stride, padding, dilation, transposed, _,
     groups) = args
    if isinstance(weight, _Tensor) or isinstance(bias, _Tensor):
        raise NotImplementedError("convolution with a traced weight")
    if transposed:
        raise NotImplementedError("transposed convolution")
    if len(t.shape) != 4 or weight.shape[2] != weight.shape[3]:
        raise NotImplementedError(
            f"convolution of {t.shape} by a {tuple(weight.shape)} kernel")
    t = cv.to_torch_order(cv.flush(t))
    top = cv.net.conv(cv.name("conv"), t.top, weight, None,
                      stride=_isotropic(stride, "stride"),
                      pad=_isotropic(padding, "padding"),
                      group=int(groups),
                      dilation=_isotropic(dilation, "dilation"))
    out = _Tensor(top, _shape(node), t.layout)
    if bias is not None:   # the bias rides the pending affine, as in JAX
        out = cv.affine(out, 1.0, bias.detach().double().numpy())
    cv.env[node] = out


def _h_binop(op: str):
    def h(cv: _Converter, node: Node, args, kwargs):
        a, b = args[:2]
        alpha = kwargs.get("alpha", 1)
        out_shape = _shape(node)
        a_t, b_t = isinstance(a, _Tensor), isinstance(b, _Tensor)
        if alpha != 1:
            if b_t:
                raise NotImplementedError(f"{op} with alpha={alpha}")
            b = b * alpha
        if op == "mul" and a_t and b_t and node.args[0] is node.args[1]:
            _start_norm(cv, node, a)    # x * x: the L2 chain's square
            return
        if (op == "div" and a_t and b_t and b.norm_of is not None
                and b.norm_of[1] == "sqrt"):
            cv.env[node] = _normalize(cv, a, b, out_shape)
            return
        if a_t and b_t:
            cv.env[node] = _tensor_binop(cv, op, a, b, out_shape)
            return
        t, c = (a, b) if a_t else (b, a)
        if tuple(out_shape) != tuple(t.shape):
            raise NotImplementedError(
                f"{op} broadcasts {t.shape} to {out_shape}")
        cc = cv.channel_const(t, c)
        if cc is None:
            raise NotImplementedError(
                f"{op} with a constant of shape {np.shape(c)} that is not "
                f"per-channel on a tensor of shape {t.shape}")
        if op == "add":
            out = cv.affine(t, 1.0, cc)
        elif op == "mul":
            out = cv.affine(t, cc, 0.0)
        elif op == "sub":
            out = cv.affine(t, 1.0, -cc) if a_t else cv.affine(t, -1.0, cc)
        elif not a_t:
            raise NotImplementedError("constant / tensor")
        else:
            out = cv.affine(t, 1.0 / cc, 0.0)
        cv.env[node] = out
    return h


def _tensor_binop(cv: _Converter, op: str, a: _Tensor, b: _Tensor,
                  out_shape) -> _Tensor:
    # a (B, C, 1, 1) gate times a (B, C, H, W) map -> the SENet Scale
    for x, y in ((a, b), (b, a)):
        if (op == "mul" and len(out_shape) == 4
                and tuple(x.shape) == tuple(out_shape)
                and tuple(y.shape) == tuple(out_shape[:2]) + (1, 1)):
            x = cv.to_torch_order(cv.flush(x))
            y = cv.to_torch_order(cv.flush(y))
            flat = cv.net.flatten(cv.name("flat"), y.top)
            top = cv.net.scale_bottoms(cv.name("se_scale"), x.top, flat,
                                       axis=0)
            return _Tensor(top, out_shape, x.layout)
    if tuple(a.shape) != tuple(b.shape):
        raise NotImplementedError(f"broadcast {op} {a.shape} vs {b.shape}")
    a, b = cv.flush(a), cv.flush(b)
    if a.layout != b.layout:
        a, b = cv.to_torch_order(a), cv.to_torch_order(b)
    if op == "add":
        top = cv.net.eltwise_sum(cv.name("add"), a.top, b.top)
    elif op == "mul":
        top = cv.net.eltwise_prod(cv.name("prod"), a.top, b.top)
    elif op == "sub":
        neg = cv.net.power(cv.name("neg"), b.top, scale=-1.0)
        top = cv.net.eltwise_sum(cv.name("sub"), a.top, neg)
    else:
        raise NotImplementedError(f"tensor {op} tensor")
    return _Tensor(top, out_shape, a.layout)


def _start_norm(cv: _Converter, node: Node, t: _Tensor) -> None:
    """x * x (or x ** 2): the start of the L2-Normalize chain. The source
    is materialised (so the division reads the same blob) and tagged;
    nothing is emitted yet."""
    t = cv.flush(t)
    cv.env[node.args[0]] = t
    cv.env[node] = dataclasses.replace(t, norm_of=(t.top, "sq"))


def _normalize(cv: _Converter, a: _Tensor, b: _Tensor, out_shape
               ) -> _Tensor:
    """scale * x / ||x||_2 over the channels, the conv4_3 rescale: the SSD
    fork's Normalize layer with the per-channel scales."""
    src = b.norm_of[0]
    if a.top != src or not np.all(np.asarray(a.shift) == 0.0):
        raise NotImplementedError(
            "L2 norm divides a different tensor than it normalizes")
    if b.has_affine:
        # e.g. RMS-norm's mean (a 1/C factor) riding the chain: Normalize
        # would silently drop it
        raise NotImplementedError(
            "scaled/shifted L2 norm (affine pending on the norm chain) has "
            "no Normalize-layer equivalent")
    if len(a.shape) != 4 or a.layout != (0, 1, 2, 3):
        raise NotImplementedError(
            "Normalize emission needs an NCHW feature map "
            f"(got shape {a.shape}, layout {a.layout})")
    c = a.shape[1]
    scale = np.broadcast_to(np.asarray(a.scale, np.float32).reshape(-1), (c,))
    top = cv.net.normalize(cv.name("l2norm"), src, scale)
    return _Tensor(top, out_shape, a.layout)


def _h_pow(cv: _Converter, node: Node, args, kwargs):
    t, exponent = args
    if not isinstance(t, _Tensor) or exponent != 2:
        raise NotImplementedError(f"pow with exponent {exponent}")
    _start_norm(cv, node, t)


def _relu(cv: _Converter, t: _Tensor, out_shape) -> _Tensor:
    t = cv.flush(t)
    # its own top: the pre-activation node may have other consumers
    # still reading t.top, which an in-place ReLU would overwrite
    top = cv.net.relu_out(cv.name("relu") + "_relu", t.top)
    return _Tensor(top, out_shape, t.layout,
                   relu_layer=len(cv.net.layers) - 1)


def _clamp_below(cv: _Converter, t: _Tensor, hi: float, out_shape
                 ) -> _Tensor:
    if t.relu_layer >= 0 and hi == 6.0:
        # the just-emitted ReLU becomes a ReLU6
        cv.net.layers[t.relu_layer].type = "ReLU6"
        return dataclasses.replace(t, relu_layer=-1)
    # exact clamp-above: hi - relu(hi - x)
    t = cv.flush(t)
    fl = cv.net.power(cv.name("clip_flip"), t.top, scale=-1.0, shift=hi)
    cv.net.relu(cv.name("clip") + "_relu", fl)
    top = cv.net.power(cv.name("clip_restore"), fl, scale=-1.0, shift=hi)
    return _Tensor(top, out_shape, t.layout)


def _h_clamp(cv: _Converter, node: Node, args, kwargs):
    t = args[0]
    lo = kwargs.get("min", args[1] if len(args) > 1 else None)
    hi = kwargs.get("max", args[2] if len(args) > 2 else None)
    if node.target.overloadpacket is aten.clamp_min:
        lo, hi = args[1], None
    elif node.target.overloadpacket is aten.clamp_max:
        lo, hi = None, args[1]
    elif node.target.overloadpacket is aten.relu:
        lo, hi = 0.0, None
    if isinstance(lo, _Tensor) or isinstance(hi, _Tensor):
        raise NotImplementedError("clamp by a tensor")
    lo = None if lo is None else float(lo)
    hi = None if hi is None else float(hi)
    out_shape = _shape(node)
    if (t.norm_of is not None and t.norm_of[1] == "sqrt" and hi is None
            and lo is not None and lo < 1e-6):
        # the epsilon guard on the L2 norm (Normalize has its own)
        cv.env[node] = dataclasses.replace(t, shape=out_shape)
        return
    if lo is not None:
        if lo != 0.0:
            raise NotImplementedError(f"clamp(min={lo})")
        t = _relu(cv, t, out_shape)
    if hi is not None:
        t = _clamp_below(cv, t, hi, out_shape)
    cv.env[node] = t


def _reduce_dims(t: _Tensor, dims) -> Tuple[int, ...]:
    if dims is None or len(dims) == 0:
        return tuple(range(len(t.shape)))
    return tuple(sorted(d % len(t.shape) for d in dims))


def _h_reduce(mean: bool):
    def h(cv: _Converter, node: Node, args, kwargs):
        t = args[0]
        dims = _reduce_dims(t, args[1] if len(args) > 1 else kwargs.get("dim"))
        out_shape = _shape(node)
        if (t.norm_of is not None and t.norm_of[1] == "sq"
                and dims == (t.channel_axis,)):
            # the channel sum of squares, the L2 chain's second stage; a
            # mean's 1/C rides along as an affine, which the division
            # refuses
            out = dataclasses.replace(t, shape=out_shape,
                                      norm_of=(t.norm_of[0], "sum"))
            if mean:
                out = dataclasses.replace(
                    out, scale=1.0 / t.shape[dims[0]])
            cv.env[node] = out
            return
        if len(t.shape) == 4 and set(dims) == set(t.layout[2:]):
            # over H and W: a global AVE pool (times H*W for a sum)
            t = cv.flush(t)
            hw = t.shape[dims[0]] * t.shape[dims[1]]
            top = cv.net.pool(cv.name("gpool"), t.top, 1, 1, "AVE",
                              global_pooling=True)
            layout = t.layout
            if len(out_shape) == 2:
                top = cv.net.flatten(cv.name("flatten"), top)
                kept = [a for a in t.layout[:2]]
                layout = tuple(sorted(kept).index(a) for a in kept)
            cv.env[node] = _Tensor(top, out_shape, layout,
                                   scale=1.0 if mean else float(hw))
            return
        raise NotImplementedError(
            f"{'mean' if mean else 'sum'} over {dims} of {t.shape}")
    return h


def _h_sqrt_like(power: float):
    def h(cv: _Converter, node: Node, args, kwargs):
        t = args[0]
        if (power == 0.5 and t.norm_of is not None
                and t.norm_of[1] == "sum"):
            cv.env[node] = dataclasses.replace(
                t, norm_of=(t.norm_of[0], "sqrt"))
            return
        t = cv.flush(t)
        top = cv.net.power(cv.name("pow"), t.top, power=power)
        cv.env[node] = _Tensor(top, _shape(node), t.layout)
    return h


def _h_reshape(cv: _Converter, node: Node, args, kwargs):
    t = args[0]
    out_shape = _shape(node)
    if tuple(t.shape) == out_shape:
        cv.env[node] = t
        return
    if t.norm_of is not None:
        # keepdim-style reshapes inside the L2-Normalize chain
        cv.env[node] = dataclasses.replace(t, shape=out_shape)
        return
    t = cv.to_torch_order(cv.flush(t))
    if len(out_shape) == 2 and out_shape[0] == t.shape[0]:
        top = cv.net.flatten(cv.name("flatten"), t.top)
    else:
        dims = [0 if (i == 0 and d == t.shape[0]) else d
                for i, d in enumerate(out_shape)]
        top = cv.net.reshape(cv.name("reshape"), t.top, dims)
    cv.env[node] = _Tensor(top, out_shape, tuple(range(len(out_shape))))


def _h_permute(cv: _Converter, node: Node, args, kwargs):
    t, perm = args
    perm = [p % len(t.shape) for p in perm]
    # a free relabelling: caffe dim i held axis layout[i], which is axis
    # perm.index(layout[i]) of the permuted tensor
    cv.env[node] = dataclasses.replace(
        t, shape=_shape(node), layout=tuple(perm.index(a) for a in t.layout))


def _h_cat(cv: _Converter, node: Node, args, kwargs):
    ts = args[0]
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0))
    if not all(isinstance(x, _Tensor) for x in ts):
        raise NotImplementedError("concatenation with a constant")
    dim %= len(ts[0].shape)
    ts = [cv.flush(x) for x in ts]
    if any(x.layout != ts[0].layout for x in ts):
        ts = [cv.to_torch_order(x) for x in ts]
    layout = ts[0].layout
    top = cv.net.concat(cv.name("concat"), [x.top for x in ts],
                        axis=layout.index(dim))
    cv.env[node] = _Tensor(top, _shape(node), layout)


def _pool_params(kernel, stride, padding):
    k = _isotropic(kernel, "pool kernel")
    s = _isotropic(stride or kernel, "pool stride")
    pad = _isotropic(padding if len(padding) else [0], "pool padding")
    return k, s, pad


def _h_max_pool(cv: _Converter, node: Node, args, kwargs):
    t, kernel = args[:2]
    stride = args[2] if len(args) > 2 else []
    padding = args[3] if len(args) > 3 else [0]
    dilation = args[4] if len(args) > 4 else [1]
    ceil = bool(args[5]) if len(args) > 5 else False
    if set(dilation) != {1}:
        raise NotImplementedError(f"dilated max pool {dilation}")
    val = node.meta["val"]
    out_shape = tuple(int(d) for d in (val[0] if isinstance(val, (
        tuple, list)) else val).shape)
    k, s, pad = _pool_params(kernel, stride, padding)
    t = cv.to_torch_order(cv.flush(t))
    h, w = t.shape[2:]
    if (pool_size(h, k, s, pad, ceil), pool_size(w, k, s, pad, ceil)) != \
            out_shape[2:]:
        raise NotImplementedError(
            f"max pool of {t.shape} to {out_shape}: Caffe's pooled size "
            "differs")
    top = cv.net.pool(cv.name("pool"), t.top, k, s, "MAX", pad=pad,
                      ceil_mode=ceil)
    out = _Tensor(top, out_shape, t.layout)
    cv.env[node] = (out, _Unmapped("max pool indices"))


def _torch_ave_counts(h, w, k, s, pad, ceil, count_include_pad, oh, ow):
    """The divisor torch's avg_pool2d uses at each output."""
    def along(dim, o):
        start = np.arange(o) * s - pad
        end = np.minimum(start + k, dim + pad)
        if count_include_pad:
            return end - start
        return np.minimum(end, dim) - np.maximum(start, 0)
    return np.outer(along(h, oh), along(w, ow))


def _h_avg_pool(cv: _Converter, node: Node, args, kwargs):
    t, kernel = args[:2]
    stride = args[2] if len(args) > 2 else []
    padding = args[3] if len(args) > 3 else [0]
    ceil = bool(args[4]) if len(args) > 4 else False
    count_include_pad = bool(args[5]) if len(args) > 5 else True
    divisor = args[6] if len(args) > 6 else None
    out_shape = _shape(node)
    k, s, pad = _pool_params(kernel, stride, padding)
    t = cv.to_torch_order(cv.flush(t))
    h, w = t.shape[2:]
    oh, ow = out_shape[2:]
    caffe = ave_counts(h, w, k, s, pad, ceil)
    if (divisor is not None or caffe.shape != (oh, ow) or not np.array_equal(
            caffe, _torch_ave_counts(h, w, k, s, pad, ceil,
                                     count_include_pad, oh, ow))):
        raise NotImplementedError(
            f"average pool (kernel {k}, stride {s}, padding {pad}, "
            f"ceil_mode {ceil}, count_include_pad {count_include_pad}) "
            "does not match the Caffe AVE count semantics")
    top = cv.net.pool(cv.name("pool"), t.top, k, s, "AVE", pad=pad,
                      ceil_mode=ceil)
    cv.env[node] = _Tensor(top, out_shape, t.layout)


def _h_matmul(cv: _Converter, node: Node, args, kwargs):
    """mm(x, w) or addmm(bias, x, w), w (I, O) constant (a Linear after
    decomposition): an InnerProduct, the bias riding the pending affine
    as in JAX."""
    if node.target.overloadpacket is aten.addmm:
        bias, x, w = args[:3]
    else:
        (x, w), bias = args[:2], None
    if (not isinstance(x, _Tensor) or isinstance(w, _Tensor)
            or isinstance(bias, _Tensor) or len(x.shape) != 2
            or kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1):
        raise NotImplementedError(f"{node.target} operand pattern")
    x = cv.to_torch_order(cv.flush(x))
    top = cv.net.inner_product(cv.name("fc"), x.top, w.T, None)
    out = _Tensor(top, _shape(node), (0, 1))
    if bias is not None:
        out = cv.affine(out, 1.0, cv.channel_const(out, bias))
    cv.env[node] = out


def _h_noop(cv: _Converter, node: Node, args, kwargs):
    cv.env[node] = args[0]


def _h_assert(cv: _Converter, node: Node, args, kwargs):
    cv.env[node] = None


_HANDLERS = {
    aten.convolution: _h_conv,
    aten.add: _h_binop("add"),
    aten.sub: _h_binop("sub"),
    aten.mul: _h_binop("mul"),
    aten.div: _h_binop("div"),
    aten.pow: _h_pow,
    aten.clamp: _h_clamp,
    aten.clamp_min: _h_clamp,
    aten.clamp_max: _h_clamp,
    aten.relu: _h_clamp,
    aten.mean: _h_reduce(mean=True),
    aten.sum: _h_reduce(mean=False),
    aten.sqrt: _h_sqrt_like(0.5),
    aten.rsqrt: _h_sqrt_like(-0.5),
    aten.view: _h_reshape,
    aten._unsafe_view: _h_reshape,
    aten.unsqueeze: _h_reshape,
    aten.squeeze: _h_reshape,
    aten.permute: _h_permute,
    aten.cat: _h_cat,
    aten.max_pool2d_with_indices: _h_max_pool,
    aten.avg_pool2d: _h_avg_pool,
    aten.addmm: _h_matmul,
    aten.mm: _h_matmul,
    aten.clone: _h_noop,
    aten._to_copy: _h_noop,          # casts: a bf16 model's convs
    aten._assert_tensor_metadata: _h_assert,
}


def output_list(outputs) -> List[torch.Tensor]:
    """A module's outputs in the order of `net.output_tops`: a tensor, a
    tuple or list, or a dict's values in its order."""
    if isinstance(outputs, torch.Tensor):
        return [outputs]
    if isinstance(outputs, dict):
        return list(outputs.values())
    return list(outputs)
