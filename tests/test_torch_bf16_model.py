"""Port vs JAX package in bfloat16: the five detectors and the four
classifiers built with `dtype=torch.bfloat16` against the JAX builders'
`dtype=jnp.bfloat16`, on the same float32 variables (numpy draws,
`load_jax_variables`), at small sizes: the flagship and the legacy
MobileNetV2 SSDLite at 96x96, pelee304 at 304, ssd300 at 300, ssd512 at
512 (the VGG and Pelee anchors need their own sizes), B = 2, 6 classes;
the classifiers at 64x64, 10 classes.

Tolerances, with what was measured:

  * head outputs (bf16): max |port - JAX| within 4 bf16 ulps of max |JAX|
    (ulp(s) = 2^(floor(log2 s) - 7)); measured 1-2 ulps on every model,
    as far as the JAX bf16 model itself is from its float32 twin (1.2-2.4
    ulps). Every conv rounds its sum to bf16 once in each framework, in
    another order, and XLA keeps some elementwise chains in float32;
  * detections, given the same bf16 head outputs: every mode (reference,
    sparse top-k, fused) bit-equal to the JAX package's. The postprocess
    casts the outputs to float32 before anything else, in every mode:
    the port's detections from the bf16 tensors equal those from their
    float32 copies, and the kernels' wrappers see float32;
  * classifier logits (bf16): within 4 bf16 ulps of their scale.

Parameters and BN statistics stay float32 in every model; the head
outputs are bf16.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models import builders as jax_builders
from demonet_tpu_torch import hub
from demonet_tpu_torch.models import builders, layers
from demonet_tpu_torch.models import detection as port_det
from demonet_tpu_torch.models.detection import (
    postprocess_detections,
    preprocess,
)
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_BF16 = jnp.bfloat16
_ULPS = 4
_CLASSES = 6
_SIZES = {"ssdlite320_mobilenet_v3_large": (96, 96),
          "ssd_lite_mobilenet_v2": (96, 96), "pelee304": (304, 304),
          "ssd300_vgg16": (300, 300), "ssd512_vgg16": (512, 512)}
_MODES = {"reference": ("reference", "exact"),
          "sparse_topk": ("reference", "sparse"),
          "fused": ("fused", "exact")}


def ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def assert_bf16_close(got, want, what):
    assert got.dtype == torch.bfloat16 and want.dtype == _BF16, what
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape, what
    scale = float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert scale > 0 and err <= _ULPS * ulp(scale), (what, err, ulp(scale))


def _size_kwargs(name):
    if name in ("ssdlite320_mobilenet_v3_large", "ssd_lite_mobilenet_v2"):
        return {"size": _SIZES[name]}
    return {}


@pytest.fixture(scope="module", params=sorted(_SIZES))
def ref(request):
    """The JAX bf16 detector and the port's, on the same variables, and
    both models' head outputs on two frames."""
    name = request.param
    kw = _size_kwargs(name)
    jd = jax_builders.MODEL_REGISTRY[name](num_classes=_CLASSES,
                                           dtype=_BF16, **kw)
    variables = tp.jax_variables(jd.init)
    if "vgg" in name:   # caffe-style std 1/255: keep conv1_1's output O(1)
        variables["params"]["extractor"]["conv1_1"]["kernel"] /= 255.0
    pd = builders.get_model(name, num_classes=_CLASSES, device="cpu",
                            dtype=torch.bfloat16, **kw)
    load_jax_variables(pd.model, variables)
    x = preprocess(torch.from_numpy(tp.images(1, _SIZES[name], b=2)),
                   pd.config).numpy()
    want = jax.jit(jd.apply)(variables, x)
    with torch.no_grad():
        got = pd.model(torch.from_numpy(x))
    return {"name": name, "jd": jd, "pd": pd, "want": want, "got": got}


def test_bf16_detector_builds_in_bf16(ref):
    pd = ref["pd"]
    assert pd.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for k, v in
               pd.model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    for key in ("cls_logits", "bbox_regression"):
        assert ref["got"][key].dtype == torch.bfloat16
    # a float32 build of the same name stays float32
    f32 = builders.get_model(ref["name"], num_classes=_CLASSES, device="cpu",
                             **_size_kwargs(ref["name"]))
    assert f32.dtype == torch.float32


def test_bf16_head_outputs_match_jax(ref):
    for key in ("cls_logits", "bbox_regression"):
        assert_bf16_close(ref["got"][key], ref["want"][key],
                          f"{ref['name']} {key}")


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_bf16_detections_match_jax_given_same_heads(ref, mode):
    """The JAX bf16 model's own head outputs through both postprocesses:
    the port's from the bf16 tensors (cast first, as in JAX) equal its own
    from their float32 copies, and those equal the JAX package's."""
    impl, topk_impl = _MODES[mode]
    pd = ref["pd"]
    logits = np.asarray(ref["want"]["cls_logits"].astype(jnp.float32))
    deltas = np.asarray(ref["want"]["bbox_regression"].astype(jnp.float32))
    sizes = np.asarray([[480, 640], [300, 300]], np.int32)
    run = functools.partial(
        postprocess_detections, anchors=torch.as_tensor(pd.anchors),
        config=pd.config, original_sizes=torch.from_numpy(sizes),
        topk_impl=topk_impl, impl=impl)
    lg, dl = torch.from_numpy(logits), torch.from_numpy(deltas)
    from_bf16 = run(lg.to(torch.bfloat16), dl.to(torch.bfloat16))
    from_f32 = run(lg, dl)
    for key in from_f32:
        assert torch.equal(from_bf16[key], from_f32[key]), key
    tp.assert_predict_matches_jax(ref["jd"], pd, logits, deltas, sizes, impl,
                                  topk_impl)


def test_bf16_postprocess_calls_the_kernels_as_float32_does(ref,
                                                            monkeypatch):
    """K1, K2 and K3's wrappers (on the CPU, their plain versions) are
    called in each serving mode on a bf16 model's outputs as often as on
    the same outputs in float32, and get float32 tensors: the bf16 path
    loses no kernel. K3 runs wherever the reference pipeline does."""
    calls, dtypes = [], set()

    def watch(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            dtypes.update(a.dtype for a in args[:2]
                          if isinstance(a, torch.Tensor)
                          and a.is_floating_point())
            return fn(*args, **kwargs)
        return wrapped

    for name in ("nms_keep_batch", "gather_rows_batch", "topk_sparse"):
        monkeypatch.setattr(port_det, name,
                            watch(name, getattr(port_det, name)))
    pd, got = ref["pd"], ref["got"]
    branches = port_det._postprocess_fused.branches
    for mode, (impl, topk_impl) in _MODES.items():
        per_dtype = []
        for cast in (lambda t: t, lambda t: t.float()):
            calls.clear()
            fallbacks = branches["fallback"]
            postprocess_detections(cast(got["cls_logits"]),
                                   cast(got["bbox_regression"]),
                                   torch.as_tensor(pd.anchors), pd.config,
                                   topk_impl=topk_impl, impl=impl)
            per_dtype.append(sorted(calls))
        assert per_dtype[0] == per_dtype[1], mode
        # the reference pipeline's per-class top-k, the fused path's
        # fallback included
        reference = mode != "fused" or branches["fallback"] > fallbacks
        want = {"nms_keep_batch", "gather_rows_batch"} | (
            {"topk_sparse"} if reference else set())
        assert set(per_dtype[0]) == want, mode
    assert dtypes == {torch.float32}


@pytest.mark.parametrize("name", sorted(builders.MODEL_REGISTRY))
def test_every_builder_takes_dtype(name):
    """get_model hands `dtype` to each of the nine builders, which takes it
    before any config override: bf16 compute, float32 weights."""
    model = builders.get_model(name, device="cpu", dtype=torch.bfloat16)
    module = getattr(model, "model", model)
    assert layers.compute_dtype(module) == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in module.parameters())
    if name in builders.DETECTORS:
        assert model.dtype == torch.bfloat16


def test_hub_load_passes_dtype():
    det = hub.load("ssdlite320_mobilenet_v3_large", device="cpu",
                   dtype=torch.bfloat16, num_classes=_CLASSES)
    assert det.dtype == torch.bfloat16 and det.config.num_classes == _CLASSES


_CLASSIFIERS = ("mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
                "peleenet_v1")


@pytest.mark.parametrize("name", _CLASSIFIERS)
def test_bf16_classifier_logits_match_jax(name):
    jm = jax_builders.MODEL_REGISTRY[name](num_classes=10, dtype=_BF16)
    x = tp.images(3, (64, 64), b=2)
    variables = tp.jax_variables(
        jm.init, 0, jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    pm = builders.get_model(name, num_classes=10, device="cpu",
                            dtype=torch.bfloat16)
    load_jax_variables(pm, variables)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert_bf16_close(got, want, name)
