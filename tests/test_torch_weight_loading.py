"""demonet_tpu_torch.utils.weights.load_jax_variables: the JAX package's
variables into the port's modules, strictly (every entry once, no key
left over), for the flagship's bench npz and for the JAX `init` tree of
every model of the registry."""

import os

import numpy as np
import pytest
import torch

from demonet_tpu_torch.models import builders
from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
from demonet_tpu_torch.utils.weights import load_jax_variables, torch_name
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

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
    ("params/extractor/conv4_3/kernel", "extractor.conv4_3.weight"),
    ("params/extractor/scale_weight", "extractor.scale_weight"),
    ("params/extractor/trunk/denseblock1_layer2/branch2a/norm/scale",
     "extractor.trunk.denseblock1_layer2.branch2a.norm.weight"),
    ("params/extractor/resblock_4/res1a/conv/kernel",
     "extractor.resblock.4.res1a.conv.weight"),
    ("params/extractor/trunk/blocks_3/layers_1/bn/bias",
     "extractor.trunk.blocks.3.layers.1.bn.bias"),
    ("params/classifier/kernel", "classifier.weight"),
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


_NEW_MODELS = ("ssd300_vgg16", "ssd512_vgg16", "ssd_lite_mobilenet_v2",
               "pelee304", "mobilenet_v2", "mobilenet_v3_large",
               "mobilenet_v3_small", "peleenet_v1")


def _jax_init_tree(name):
    """The JAX model's `init` variable tree (shapes by jax.eval_shape),
    filled with distinct numpy values, and the port's model of the same
    name, both on the CPU at their default sizes, 7 classes."""
    import jax

    from demonet_tpu.models import builders as jax_builders

    jm = jax_builders.get_model(name, num_classes=7)
    if name in builders.DETECTORS:
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    else:
        x = jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    pm = builders.get_model(name, num_classes=7, device="cpu")
    return tree, getattr(pm, "model", pm)


@pytest.mark.parametrize("name", _NEW_MODELS)
def test_every_model_loads_from_its_jax_init_tree(name):
    """Every entry of the port's module filled from the JAX init tree, by
    the rules, with no JAX variable left over (the loader raises on
    either), and each value where the rules put it."""
    import jax

    tree, module = _jax_init_tree(name)
    load_jax_variables(module, tree)
    sd = module.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == sum(1 for n in sd
                            if not n.endswith("num_batches_tracked"))
    for path, leaf in flat:
        key = "/".join(k.key for k in path)
        arr = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else (
            leaf.T if leaf.ndim == 2 else leaf)
        np.testing.assert_array_equal(sd[torch_name(key)].numpy(), arr,
                                      err_msg=key)


def test_square_dense_kernel_is_transposed():
    """A (in, out) Dense kernel lands as the Linear's (out, in) weight: on
    a square kernel, where loading it untransposed would not raise, the
    port's classifier computes x @ kernel + bias as the JAX Dense does."""
    tree, module = _jax_init_tree("mobilenet_v2")
    # mobilenet_v2's classifier at 1,280 classes: a (1280, 1280) kernel
    tree["params"]["classifier"]["kernel"] = np.random.default_rng(1).normal(
        size=(1280, 1280)).astype(np.float32)
    tree["params"]["classifier"]["bias"] = np.zeros(1280, np.float32)
    model = builders.mobilenet_v2(num_classes=1280, device="cpu")
    load_jax_variables(model, tree)
    kernel = tree["params"]["classifier"]["kernel"]
    x = np.random.default_rng(2).normal(size=(3, 1280)).astype(np.float32)
    with torch.no_grad():
        got = model.classifier(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x @ kernel, rtol=1e-5, atol=1e-4)
    assert not np.allclose(got, x @ kernel.T, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("name", ["ssd300_vgg16", "ssd_lite_mobilenet_v2",
                                  "mobilenet_v3_small"])
def test_fresh_weights_follow_the_jax_initializers(name):
    """A fresh port model starts as the JAX package's `init` does: per
    tensor of 4,096 entries or more, the spread of the port's draw within
    10 % of the JAX draw's; constant leaves (biases, BN scales and
    statistics, VGG's L2 scale) equal. The three models cover every
    initializer kind the builders use: lecun normal (truncated; VGG's
    trunk, the SE convs, Dense layers), xavier uniform (VGG's extras and
    head), kaiming fan-out and normal(0, 0.03) (the MobileNets). Pelee's
    convs are all lecun normal."""
    import jax

    from demonet_tpu.models import builders as jax_builders

    jm = jax_builders.get_model(name, num_classes=7)
    if name in builders.DETECTORS:
        tree = jax.jit(jm.init)(jax.random.PRNGKey(0))
    else:
        tree = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                np.zeros((1, 64, 64, 3), np.float32))
    pm = builders.get_model(name, num_classes=7, device="cpu", seed=3)
    sd = getattr(pm, "model", pm).state_dict()
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        want = np.asarray(leaf, np.float64)
        got = sd[torch_name("/".join(k.key for k in path))].double().numpy()
        if want.std() == 0.0:
            np.testing.assert_array_equal(got.ravel(), want.ravel())
        elif want.size >= 4096:
            ratio = got.std() / want.std()
            assert 0.9 < ratio < 1.1, (path, ratio)
            checked += 1
    assert checked >= 10
