"""demonet_tpu_torch.utils.weights.load_jax_variables: the JAX package's
variables into the port's modules, strictly (every entry once, no key
left over)."""

import os

import numpy as np
import pytest
import torch

from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
from demonet_tpu_torch.utils.weights import load_jax_variables, torch_name

_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets", "ssdlite320_shapes_trained.npz")


@pytest.fixture(scope="module")
def bench_flat():
    with np.load(_NPZ) as z:
        return {k: z[k] for k in z.files}


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("jax_key,name", [
    ("params/extractor/trunk/blocks_12/depthwise/conv/kernel",
     "extractor.trunk.blocks.12.depthwise.conv.weight"),
    ("params/extractor/trunk/blocks_3/se/fc1/bias",
     "extractor.trunk.blocks.3.se.fc1.bias"),
    ("params/extractor/extras_0/proj/bn/scale",
     "extractor.extras.0.proj.bn.weight"),
    ("params/head/cls_0/pw/kernel", "head.cls.0.pw.weight"),
    ("batch_stats/head/reg_5/dw/bn/var", "head.reg.5.dw.bn.running_var"),
    ("batch_stats/extractor/trunk/last_conv/bn/mean",
     "extractor.trunk.last_conv.bn.running_mean"),
])
def test_torch_name_rules(jax_key, name):
    assert torch_name(jax_key) == name


def test_bench_npz_fills_full_width_model_exactly(bench_flat):
    assert len(bench_flat) == 406
    det = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu")
    load_jax_variables(det.model, bench_flat)
    sd = det.model.state_dict()
    k = bench_flat["params/head/cls_0/pw/kernel"]         # (1, 1, 672, 546)
    np.testing.assert_array_equal(
        sd["head.cls.0.pw.weight"].numpy(),
        k.astype(np.float32).transpose(3, 2, 0, 1))
    dw = bench_flat["params/extractor/trunk/blocks_12/depthwise/conv/kernel"]
    np.testing.assert_array_equal(
        sd["extractor.trunk.blocks.12.depthwise.conv.weight"].numpy(),
        dw.astype(np.float32).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["head.reg.5.dw.bn.running_var"].numpy(),
        bench_flat["batch_stats/head/reg_5/dw/bn/var"].astype(np.float32))
    n_entries = sum(1 for n in sd if not n.endswith("num_batches_tracked"))
    assert n_entries == 406


def test_nested_tree_loads_like_flat(bench_flat):
    a = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu", seed=1)
    b = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu", seed=2)
    load_jax_variables(a.model, bench_flat)
    load_jax_variables(b.model, _nested(bench_flat))
    for (na, ta), (nb, tb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na


def test_missing_key_raises(bench_flat):
    det = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu")
    flat = dict(bench_flat)
    del flat["batch_stats/head/cls_3/dw/bn/mean"]
    with pytest.raises(KeyError, match="have no JAX variable"):
        load_jax_variables(det.model, flat)


def test_extra_key_raises(bench_flat):
    det = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu")
    flat = dict(bench_flat)
    flat["params/head/cls_6/pw/bias"] = np.zeros(546, np.float32)
    with pytest.raises(KeyError, match="does not have"):
        load_jax_variables(det.model, flat)
    flat = dict(bench_flat)
    flat["params/head/cls_0/pw/weird"] = np.zeros(546, np.float32)
    with pytest.raises(KeyError, match="no rule"):
        load_jax_variables(det.model, flat)


def test_shape_mismatch_raises(bench_flat):
    det = ssdlite320_mobilenet_v3_large(num_classes=21, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_variables(det.model, bench_flat)
