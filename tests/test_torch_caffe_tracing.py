"""The generic Caffe route of the port (demonet_tpu_torch/export/
tracing.py, a walker of the `torch.export` ATen graph), on the
classifiers and the legacy SSDLite, and its refusals.

Each graph, run by the port's evaluator, matches the port's forward at
the tolerances of tests/test_caffe_eval.py, and its count of each Caffe
layer type equals that of the JAX `trace_to_caffe` (the jaxpr walker) on
the same weights, but for one difference by construction: torch's
`mean(dim=(2, 3), keepdim=True)` of an SE block is one ATen op on NCHW,
a global AVE pool, where the jaxpr's mean is a reduce_sum, a keepdims
broadcast and a division, which the JAX walker emits as Pooling, Flatten,
Power (x HW), Reshape and Power (/ HW). So each SE block costs the JAX
graph one Flatten, one Reshape and two Powers more.

tests/test_torch_caffe_tracing_detectors.py covers the other detectors.
"""

import pytest
import torch
import torch.nn.functional as F

from demonet_tpu_torch.export.tracing import trace_to_caffe
from tests.torch_caffe import (
    check_against_forward,
    check_counts_against_jax,
    generic_graph,
)
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

MODELS = ("mobilenet_v2", "mobilenet_v3_small", "ssd_lite_mobilenet_v2")


@pytest.mark.parametrize("name", MODELS)
def test_generic_graph_matches_forward(name):
    check_against_forward(name)


@pytest.mark.parametrize("name", MODELS)
def test_generic_layer_counts_match_jax_walker(name):
    check_counts_against_jax(name)


def test_generic_graph_patterns():
    """The SE blocks as the two-bottom Scale, hard-swish's products, the
    BN folded into Scale layers, ReLU6 upgraded in place; the detector's
    Permute + Reshape + Concat tail."""
    types = [layer.type for layer in generic_graph("mobilenet_v3_small")
             .layers]
    assert "Eltwise" in types and "ReLU6" in types
    assert any(layer.type == "Scale" and len(layer.bottoms) == 2
               for layer in generic_graph("mobilenet_v3_small").layers)
    tail = [layer.type for layer in generic_graph(
        "ssd_lite_mobilenet_v2").layers if layer.type in (
            "Permute", "Reshape", "Concat")]
    assert tail == (["Permute", "Reshape"] * 6 + ["Concat"]) * 2


def test_generic_unmapped_op_message():
    with pytest.raises(NotImplementedError,
                       match=r"aten\.sort.* has no Caffe mapping"):
        trace_to_caffe(lambda x: torch.sort(x, dim=-1)[0],
                       torch.zeros((1, 8, 8, 3)), name="bad")


def test_generic_rejects_scaled_norm_and_2d_normalize():
    """A scaled norm chain (RMS-norm's mean factor) or a 2-D embedding
    normalize is refused, not silently mis-exported."""
    def rmsnorm(x):
        return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True))

    with pytest.raises(NotImplementedError, match="scaled/shifted L2"):
        trace_to_caffe(rmsnorm, torch.ones((1, 4, 4, 8)), name="rms")

    def embed_norm(x):
        e = x.mean(dim=(1, 2))
        return e / torch.sqrt((e * e).sum(dim=-1, keepdim=True))

    with pytest.raises(NotImplementedError, match="NCHW feature map"):
        trace_to_caffe(embed_norm, torch.ones((2, 4, 4, 8)), name="emb")


def test_generic_rejects_average_pool_caffe_divides_otherwise():
    """With padding and count_include_pad=False torch divides the edge
    windows by their real elements, Caffe by the padded window."""
    def pool(x):
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1,
                            count_include_pad=False)

    with pytest.raises(NotImplementedError, match="Caffe AVE count"):
        trace_to_caffe(pool, torch.ones((1, 9, 9, 4)), name="pool")
    # counted Caffe's way it converts
    net = trace_to_caffe(
        lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1),
        torch.ones((1, 9, 9, 4)), name="pool")
    assert [layer.type for layer in net.layers] == ["Input", "Pooling"]
