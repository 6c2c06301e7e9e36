"""The generic Caffe route of the port on the flagship, Pelee-SSD and
SSD300-VGG16 (raw heads): each graph against the port's forward, and its
layer counts against the JAX walker's on the same weights (the checks and
the SE difference of tests/test_torch_caffe_tracing.py). VGG's conv4_3 L2
rescale becomes the SSD fork's Normalize layer, Pelee's ceil-mode average
pools Caffe AVE pools."""

import pytest

from tests.torch_caffe import (
    check_against_forward,
    check_counts_against_jax,
    generic_graph,
)
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

MODELS = ("ssdlite320_mobilenet_v3_large", "pelee304", "ssd300_vgg16")


@pytest.mark.parametrize("name", MODELS)
def test_generic_detector_matches_forward(name):
    check_against_forward(name)


@pytest.mark.parametrize("name", MODELS)
def test_generic_detector_counts_match_jax_walker(name):
    check_counts_against_jax(name)


def test_generic_detector_patterns():
    vgg = [layer for layer in generic_graph("ssd300_vgg16").layers]
    assert sum(layer.type == "Normalize" for layer in vgg) == 1
    pelee = generic_graph("pelee304").layers
    assert sum(layer.type == "Pooling" and layer.params["pool"] == 1
               for layer in pelee) == 3   # the transitions' AVE pools
