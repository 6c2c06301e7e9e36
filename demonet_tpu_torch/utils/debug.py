"""Numerics debugging: bad-gradient detection, NaN guards, graph dumps
(counterpart of demonet_tpu/utils/debug.py; reference
demonet/util/graph_utils.py:132-193, whose hooks flag NaN or |g| >= 1e6
gradients in the autograd graph).

  * `find_bad_gradients`: autograd gradients of a loss with respect to a
    dict of leaf tensors, and every path whose gradient has a NaN or an
    entry of magnitude >= `magnitude` (paths written as the JAX package
    writes them, `['w']`);
  * `enable_nan_checks`: `torch.autograd.set_detect_anomaly`, which
    raises in the backward op that made a NaN and names its forward;
  * `tree_finite_report`: leaves with NaN/Inf and the largest |x| of
    nested dicts and lists or a state_dict;
  * `graph_to_dot`: a module's or function's `torch.fx` graph as graphviz
    dot text (the JAX package's jaxpr_to_dot);
  * `dump_hlo`: the compiler's IR of a module or function at a chosen
    stage, the JAX package's three stage names mapped onto `torch.export`
    and Inductor.
"""

from __future__ import annotations

import os
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch
from torch import nn


def _path(keys: Tuple[Any, ...]) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _leaves(tree: Any, keys: Tuple[Any, ...] = ()
            ) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (i,))
    else:
        yield keys, tree


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_bad_grad(g: Any, magnitude: float = 1e6) -> bool:
    """NaN, or an entry with |g| >= magnitude (reference
    graph_utils.py:155-158)."""
    arr = _numpy(g)
    return bool(np.isnan(arr).any() or (np.abs(arr) >= magnitude).any())


def find_bad_gradients(
    loss_fn: Callable[..., torch.Tensor],
    params: Mapping[str, Any],
    *args: Any,
    magnitude: float = 1e6,
) -> List[Tuple[str, Dict[str, float]]]:
    """[(path, {"nan_count", "max_abs"})] for every leaf of `params` (a
    nested dict of tensors) whose gradient of loss_fn(params, *args) is
    bad. The leaves are detached copies, so `params` is left as it is; a
    leaf the loss does not use has a zero gradient."""
    keyed = list(_leaves(params))
    leaves = [torch.as_tensor(v).detach().clone().requires_grad_(True)
              for _, v in keyed]
    tree: Dict[Any, Any] = {}
    for (keys, _), leaf in zip(keyed, leaves):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    grads = torch.autograd.grad(loss_fn(tree, *args), leaves,
                                allow_unused=True)
    bad = []
    for (keys, _), leaf, g in zip(keyed, leaves, grads):
        arr = _numpy(g) if g is not None else np.zeros(tuple(leaf.shape))
        if np.isnan(arr).any() or (np.abs(arr) >= magnitude).any():
            bad.append((_path(keys), {
                "nan_count": int(np.isnan(arr).sum()),
                "max_abs": float(np.nanmax(np.abs(arr))) if arr.size else 0.0,
            }))
    return bad


def enable_nan_checks(enable: bool = True) -> None:
    """Global NaN tripwire for the backward pass (autograd anomaly
    detection)."""
    torch.autograd.set_detect_anomaly(enable)


def tree_finite_report(tree: Any) -> Dict[str, Any]:
    """{"num_leaves", "non_finite_paths", "max_abs"} of nested dicts and
    lists of tensors or arrays, or of a state_dict."""
    leaves = list(_leaves(tree))
    bad, max_abs = [], 0.0
    for keys, x in leaves:
        arr = _numpy(x)
        if arr.size == 0:
            continue
        if not np.isfinite(arr).all():
            bad.append(_path(keys))
        max_abs = max(max_abs, float(np.max(np.abs(arr))))
    return {"num_leaves": len(leaves), "non_finite_paths": bad,
            "max_abs": max_abs}


def graph_to_dot(fn: Any, *example_args: Any, max_nodes: int = 400) -> str:
    """A module's (or function's) `torch.fx` graph as graphviz dot text,
    for `dot -Tsvg`: inputs, one box per op, the output. With example
    arguments, each input is labelled with its dtype and shape."""
    from torch.fx import symbolic_trace
    from torch.fx.passes.shape_prop import ShapeProp

    gm = symbolic_trace(fn)
    if example_args:
        ShapeProp(gm).propagate(*example_args)
    nodes = list(gm.graph.nodes)
    inputs = [n for n in nodes if n.op == "placeholder"]
    ops = [n for n in nodes if n.op not in ("placeholder", "output")]
    outputs = [n for n in nodes if n.op == "output"]
    lines = ["digraph fx {", "  rankdir=TB;",
             '  node [shape=box, fontsize=10];']
    produced = {}
    for i, node in enumerate(inputs):
        name = f"in{i}"
        produced[node] = name
        meta = node.meta.get("tensor_meta")
        label = (f"input {str(meta.dtype).replace('torch.', '')}"
                 f"{list(meta.shape)}" if meta is not None
                 else f"input {node.name}")
        lines.append(f'  {name} [label="{label}", style=filled, '
                     'fillcolor=lightblue];')
    for i, node in enumerate(ops[:max_nodes]):
        name = f"op{i}"
        if node.op == "call_module":   # the module's class and its name
            target = (f"{type(gm.get_submodule(node.target)).__name__} "
                      f"{node.target}")
        elif isinstance(node.target, str):
            target = node.target
        else:
            target = getattr(node.target, "__name__", str(node.target))
        lines.append(f'  {name} [label="{target}"];')
        for src in node.all_input_nodes:
            if src in produced:
                lines.append(f"  {produced[src]} -> {name};")
        produced[node] = name
    if len(ops) > max_nodes:
        lines.append(f'  truncated [label="... {len(ops) - max_nodes} more '
                     'ops"];')
    for i, node in enumerate(outputs):
        name = f"out{i}"
        lines.append(f'  {name} [label="output", style=filled, '
                     'fillcolor=lightgreen];')
        for src in node.all_input_nodes:
            if src in produced:
                lines.append(f"  {produced[src]} -> {name};")
    lines.append("}")
    return "\n".join(lines)


class _Function(nn.Module):
    """A plain function as a module, for `torch.export`."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def dump_hlo(fn: Callable, *example_args: Any, stage: str = "stablehlo",
             path: Optional[str] = None) -> str:
    """Dump the compiler IR of `fn` (a module or a function of tensors) at a
    chosen stage. The JAX package's stage names, mapped:

      * "jaxpr"     -- the `torch.export` FX graph: the traced program, as
                       the jaxpr is JAX's traced IR;
      * "stablehlo" -- the core-ATen graph after `run_decompositions()`:
                       the portable IR an exported program ships, as
                       StableHLO is what jax.export ships;
      * "optimized" -- the code Inductor generates for the current device
                       (the example arguments' device): the AOTInductor
                       wrapper C++ and its kernel source -- C++ on the
                       CPU; on the card the wrapper names the Triton
                       kernels it launches.

    Returns the text; also writes it to `path` when given. Any other stage
    raises ValueError.
    """
    if stage not in ("jaxpr", "stablehlo", "optimized"):
        raise ValueError(
            f"stage must be jaxpr|stablehlo|optimized, got {stage!r}")
    module = fn if isinstance(fn, nn.Module) else _Function(fn)
    exported = torch.export.export(module, tuple(example_args))
    if stage == "jaxpr":
        text = str(exported)
    elif stage == "stablehlo":
        text = str(exported.run_decompositions())
    else:
        text = _inductor_code(exported)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def _inductor_code(exported: "torch.export.ExportedProgram") -> str:
    """The source files of the program's AOTInductor package."""
    import tempfile
    import zipfile

    with tempfile.TemporaryDirectory() as tmp:
        package = torch._inductor.aoti_compile_and_package(
            exported, package_path=os.path.join(tmp, "dump.pt2"))
        with zipfile.ZipFile(package) as z:
            names = sorted(n for n in z.namelist()
                           if n.endswith((".cpp", ".py")))
            return "\n".join(f"// {n}\n{z.read(n).decode()}" for n in names)
