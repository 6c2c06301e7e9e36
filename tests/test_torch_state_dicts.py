"""Port vs JAX package: torch checkpoints in the reference's state_dict
layout (demonet_tpu_torch/utils/torch_weights.py), the weights cache
(utils/pretrained.py) and hub loading (hub.py).

For every key map, the JAX variable tree is drawn with numpy over
`jax.eval_shape(init)` (tests/torch_parity.py), and:

  * the port's `synthesize_torch_state_dict` equals the JAX package's,
    key for key and bit for bit;
  * on that state_dict, the port's `convert_state_dict` equals the JAX
    package's;
  * a port model loaded from it as a .pth equals one loaded with the tree
    by `load_jax_variables`, every parameter and buffer bit for bit.

`hub.load` of a .pth gives head outputs within 1e-4 of max |JAX| of the
JAX `hub.load`'s `apply` (fp32 convs summed in another order). The JAX
hub draws random weights before it loads the file and throws them
away; here it draws abstract ones (`jax.eval_shape`), which its eager
flax init would take some 40 s to draw for nothing.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu import hub as jax_hub
from demonet_tpu.models import builders as jax_builders
from demonet_tpu.models import detection as jax_detection
from demonet_tpu.utils import pretrained as jax_pretrained
from demonet_tpu.utils import torch_weights as jax_tw
from demonet_tpu_torch import hub
from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.models import builders
from demonet_tpu_torch.utils import pretrained, torch_weights
from demonet_tpu_torch.utils.checkpoints import save_checkpoint
from demonet_tpu_torch.utils.weights import (
    jax_variables_of,
    load_jax_variables,
)
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_CLASSES = 6
# (key map name, builder kwargs): every map of the JAX converter, and the
# flagship's full tail through its `reduced_tail` argument
_MAPS = [
    ("ssdlite320_mobilenet_v3_large", {}),
    ("ssdlite320_mobilenet_v3_large", {"reduced_tail": False}),
    ("ssd_lite_mobilenet_v2", {}),
    ("ssd300_vgg16", {}),
    ("ssd512_vgg16", {}),
    ("mobilenet_v2", {}),
    ("mobilenet_v3_large", {}),
    ("mobilenet_v3_small", {}),
]
_IDS = [n + ("_full_tail" if kw else "") for n, kw in _MAPS]


@functools.lru_cache(maxsize=None)
def _tree(name, kw_items=()):
    """The JAX variable tree of `name` (numpy), drawn over eval_shape."""
    kw = dict(kw_items)
    model = jax_builders.MODEL_REGISTRY[name](num_classes=_CLASSES, **kw)
    if name in builders.DETECTORS:
        return tp.jax_variables(model.init)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    return tp.jax_variables(model.init, 0, x)


def _map_kwargs(name, kw):
    """The key-map arguments of a model built with `kw`."""
    return {"reduced_tail": kw["reduced_tail"]} if "reduced_tail" in kw \
        else {}


def _port_model(name, kw):
    model = builders.get_model(name, num_classes=_CLASSES, device="cpu", **kw)
    return getattr(model, "model", model)


@pytest.mark.parametrize("name,kw", _MAPS, ids=_IDS)
def test_synthesized_state_dict_equals_jax(name, kw):
    tree = _tree(name, tuple(kw.items()))
    got = torch_weights.synthesize_torch_state_dict(name, tree,
                                                    **_map_kwargs(name, kw))
    want = jax_tw.synthesize_torch_state_dict(name, tree,
                                              **_map_kwargs(name, kw))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name,kw", _MAPS, ids=_IDS)
def test_converted_tree_equals_jax(name, kw):
    mk = _map_kwargs(name, kw)
    sd = jax_tw.synthesize_torch_state_dict(name, _tree(name,
                                                        tuple(kw.items())),
                                            **mk)
    want = jax_tw.convert_state_dict(name, sd, **mk)
    # the port takes tensors (a loaded .pth) as well as numpy arrays
    for given in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = torch_weights.convert_state_dict(name, given, **mk)
        g, w = torch_weights._flatten(got), torch_weights._flatten(want)
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))


@pytest.mark.parametrize("name,kw", _MAPS, ids=_IDS)
def test_pth_load_equals_jax_variables_load(name, kw, tmp_path):
    tree = _tree(name, tuple(kw.items()))
    mk = _map_kwargs(name, kw)
    path = str(tmp_path / f"{name}.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                torch_weights.synthesize_torch_state_dict(
                    name, tree, **mk).items()}, path)
    from_pth = _port_model(name, kw)
    torch_weights.load_torch_weights(
        from_pth, name, torch_weights.load_torch_checkpoint(path), **mk)
    from_tree = _port_model(name, kw)
    load_jax_variables(from_tree, tree)
    got, want = from_pth.state_dict(), from_tree.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name,kw", _MAPS, ids=_IDS)
def test_jax_variables_of_a_port_model_equal_the_tree(name, kw):
    """utils.weights.jax_variables_of, the inverse of load_jax_variables:
    a port model's weights back as the JAX tree they came from, so a port
    model can be written as a reference .pth."""
    tree = _tree(name, tuple(kw.items()))
    model = _port_model(name, kw)
    load_jax_variables(model, tree)
    got = torch_weights._flatten(jax_variables_of(model))
    want = torch_weights._flatten(tree)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def test_missing_key_and_unmapped_model_raise():
    tree = _tree("mobilenet_v3_small")
    sd = torch_weights.synthesize_torch_state_dict("mobilenet_v3_small", tree)
    del sd["classifier.3.bias"]
    with pytest.raises(KeyError, match="1 torch keys missing"):
        torch_weights.convert_state_dict("mobilenet_v3_small", sd)
    partial = torch_weights.convert_state_dict("mobilenet_v3_small", sd,
                                               strict=False)
    assert "bias" not in partial["params"]["classifier"]
    for name in ("pelee304", "peleenet_v1"):   # no map, as in JAX
        with pytest.raises(ValueError, match="No torch key map"):
            torch_weights.key_map_for(name)
        with pytest.raises(ValueError, match="No torch key map"):
            jax_tw.key_map_for(name)


def test_load_torch_checkpoint_takes_a_training_checkpoint(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3)}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": sd, "optimizer": {"lr": 0.1}, "epoch": 3}, path)
    got = torch_weights.load_torch_checkpoint(path)
    want = jax_tw.load_torch_checkpoint(path)
    assert got.keys() == want.keys() == {"a.weight"}
    np.testing.assert_array_equal(got["a.weight"], want["a.weight"])


# -- hub ----------------------------------------------------------------------

@pytest.fixture
def abstract_jax_init(monkeypatch):
    """The JAX detectors' init as shapes only: the JAX hub replaces what
    it draws with the loaded weights."""
    init = jax_detection.Detector.init
    monkeypatch.setattr(jax_detection.Detector, "init",
                        lambda self, rng, *a: jax.eval_shape(
                            lambda r: init(self, r, *a), rng))


@pytest.fixture(scope="module")
def v2_pth(tmp_path_factory):
    """ssd_lite_mobilenet_v2 at 96x96, 6 classes, as a reference .pth."""
    tree = _tree("ssd_lite_mobilenet_v2")
    path = str(tmp_path_factory.mktemp("hub") / "v2.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                torch_weights.synthesize_torch_state_dict(
                    "ssd_lite_mobilenet_v2", tree).items()}, path)
    return path


@pytest.mark.parametrize("name,size", [
    ("ssd_lite_mobilenet_v2", (96, 96)),
    ("ssdlite320_mobilenet_v3_large", (96, 96)),
])
def test_hub_load_pth_matches_jax_hub(name, size, tmp_path,
                                      abstract_jax_init):
    path = str(tmp_path / f"{name}.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                torch_weights.synthesize_torch_state_dict(
                    name, _tree(name)).items()}, path)
    kw = dict(num_classes=_CLASSES, size=size)
    det = hub.load(name, weights=path, device="cpu", **kw)
    jd, variables = jax_hub.load(name, weights=path, **kw)
    x = tp.images(3, size)
    want = jax.jit(jd.apply)(variables, x)
    with torch.no_grad():
        got = det.model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression"):
        tp.assert_close_to_scale(got[key].numpy(), want[key], 1e-4, key)
    assert det.config == builders.get_model(name, device="cpu", **kw).config


def test_hub_load_checkpoint_dir_and_refusals(v2_pth, tmp_path, monkeypatch):
    kw = dict(num_classes=_CLASSES, size=(96, 96))
    det = hub.load("ssd_lite_mobilenet_v2", weights=v2_pth, device="cpu",
                   **kw)
    state = create_train_state(det, make_optimizer(0.1))
    ckpt = save_checkpoint(str(tmp_path), state, 0)
    again = hub.load("ssd_lite_mobilenet_v2", weights=ckpt, device="cpu",
                     **kw)
    for (k, a), b in zip(det.model.state_dict().items(),
                         again.model.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="unrecognized weights source"):
        hub.load("ssd_lite_mobilenet_v2", weights=str(tmp_path / "w.npz"),
                 device="cpu", **kw)
    assert hub.list_models() == jax_hub.list_models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hub.load("ssd_lite_mobilenet_v2", **kw)


def test_hub_reference_entry_loads_the_cached_checkpoint(v2_pth, tmp_path,
                                                         monkeypatch):
    """hub.ssd_lite_mobilenet_v2(pretrained=True): the cold cache raises
    and names where the checkpoint comes from; a warm one loads it."""
    monkeypatch.setenv("DEMONET_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="reference release"):
        hub.ssd_lite_mobilenet_v2(pretrained=True, image_size=96,
                                  num_classes=_CLASSES, device="cpu")
    os.symlink(v2_pth, pretrained.cached_weights_path(
        "ssd_lite_mobilenet_v2"))
    det = hub.ssd_lite_mobilenet_v2(pretrained=True, image_size=96,
                                    num_classes=_CLASSES, device="cpu",
                                    score_thresh=0.3)
    want = _port_model("ssd_lite_mobilenet_v2", {"size": (96, 96)})
    load_jax_variables(want, _tree("ssd_lite_mobilenet_v2"))
    assert det.config.score_thresh == 0.3
    for (k, a), b in zip(det.model.state_dict().items(),
                         want.state_dict().values()):
        assert torch.equal(a, b), k


# -- the weights cache ----------------------------------------------------------

def test_cache_is_the_jax_package_cache(tmp_path, monkeypatch):
    assert pretrained.PRETRAINED_URLS == jax_pretrained.PRETRAINED_URLS
    assert pretrained.LOCAL_ONLY == jax_pretrained.LOCAL_ONLY
    for env in (None, str(tmp_path)):
        if env is None:
            monkeypatch.delenv("DEMONET_WEIGHTS_DIR", raising=False)
        else:
            monkeypatch.setenv("DEMONET_WEIGHTS_DIR", env)
        assert pretrained.weights_cache_dir() == \
            jax_pretrained.weights_cache_dir()
        for name in [*pretrained.PRETRAINED_URLS, *pretrained.LOCAL_ONLY]:
            assert pretrained.cached_weights_path(name) == \
                jax_pretrained.cached_weights_path(name)
    with pytest.raises(ValueError, match="No published checkpoint"):
        pretrained.cached_weights_path("pelee304")


@pytest.mark.parametrize("name", sorted(pretrained.PRETRAINED_URLS))
def test_cold_cache_raises_and_names_the_url(name, tmp_path, monkeypatch):
    monkeypatch.setenv("DEMONET_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as err:
        pretrained.resolve_weights(name)
    assert pretrained.PRETRAINED_URLS[name] in str(err.value)
    assert str(tmp_path) in str(err.value)
    with pytest.raises(FileNotFoundError, match="not found"):
        pretrained.resolve_weights(name, path=str(tmp_path / "nope.pth"))


def test_apply_pretrained_replaces_the_weights(tmp_path, monkeypatch):
    """A warm cache: apply_pretrained puts the checkpoint into the train
    state's model in place (the optimizer still holds its parameters)."""
    name = "ssdlite320_mobilenet_v3_large"
    tree = _tree(name)
    monkeypatch.setenv("DEMONET_WEIGHTS_DIR", str(tmp_path))
    cached = pretrained.cached_weights_path(name)
    torch.save({k: torch.from_numpy(v) for k, v in
                torch_weights.synthesize_torch_state_dict(name, tree).items()},
               cached)
    assert pretrained.resolve_weights(name) == cached
    det = builders.get_model(name, num_classes=_CLASSES, device="cpu",
                             size=(96, 96), seed=4)
    state = create_train_state(det, make_optimizer(0.1))
    before = {k: v.clone() for k, v in det.model.state_dict().items()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert pretrained.apply_pretrained(state, name) is state
    want = _port_model(name, {"size": (96, 96)})
    load_jax_variables(want, tree)
    got = state.model.state_dict()
    entries = [k for k in want.state_dict()
               if not k.endswith("num_batches_tracked")]
    assert all(not torch.equal(before[k], got[k]) for k in entries)
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    assert all(a is b for a, b in zip(
        params, [p for g in state.optimizer.param_groups for p in g["params"]]))
    assert params[0] is next(state.model.parameters())
