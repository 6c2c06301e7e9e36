"""Port vs JAX package: the four classifiers (mobilenet_v2,
mobilenet_v3_large, mobilenet_v3_small, peleenet_v1) at 64x64, B = 2,
10 classes, on the same weights: their `nn.Dense` kernels (in, out) reach
the port's Linear layers through load_jax_variables' 2-D rule.

Tolerances, with what was measured:

  * eval-mode logits: max |port - JAX| within 1e-4 of max |JAX| (fp32,
    another summation order);
  * a train-mode forward (BN on batch statistics, dropout off), fp32:
    logits and each updated BN running statistic within 1e-3 of its
    largest magnitude (measured 2.3e-4 in PeleeNet, whose last maps hold
    8 values per channel at B = 2; 5.6e-5 or less in the others); it
    checks each classifier's BN rule (eps 1e-5 and torch momentum 0.1 in
    MobileNetV2 and PeleeNet, 1e-3 and 0.01 in MobileNetV3), which a
    wrong momentum moves by percents;
  * dropout in train mode: drawn from the caller's torch.Generator, the
    same mask for the same seed, the kept entries scaled by 1 / (1 -
    rate); no generator raises, as flax does without a 'dropout' rng.
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models import builders as jax_builders
from demonet_tpu_torch.models import builders
from demonet_tpu_torch.models.layers import dropout
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

# one intra-op thread for every test here: beside the other test workers,
# torch's threads in each worker wait on each other for most of a step
# (tests/torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

_NAMES = ("mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
          "peleenet_v1")
_SIZE = (64, 64)
_CLASSES = 10


def _pair(name, **kwargs):
    """The JAX module with numpy variables, and the port's module loaded
    with them, on the CPU."""
    jm = jax_builders.MODEL_REGISTRY[name](num_classes=_CLASSES, **kwargs)
    x = jax.ShapeDtypeStruct((1, *_SIZE, 3), jnp.float32)
    variables = tp.jax_variables(jm.init, 0, x)
    pm = builders.get_model(name, num_classes=_CLASSES, device="cpu",
                            **kwargs)
    load_jax_variables(pm, variables)
    return jm, pm, variables


@pytest.mark.parametrize("name", _NAMES)
def test_classifier_logits_match_jax(name):
    jm, pm, variables = _pair(name)
    x = tp.images(3, _SIZE, b=2)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, _CLASSES) and not pm.training
    tp.assert_close_to_scale(got.numpy(), want, 1e-4, name)


@pytest.mark.parametrize("name", _NAMES)
def test_classifier_train_mode_statistics_match_jax(name):
    rate = "drop_rate" if name == "peleenet_v1" else "dropout_rate"
    jm, pm, variables = _pair(name, **{rate: 0.0})
    x = tp.images(4, _SIZE, b=2)
    logits, mutated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    want = tp.jax_state({"batch_stats": mutated["batch_stats"]})
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    tp.assert_close_to_scale(got.numpy(), logits, 1e-3, "logits")
    state = pm.state_dict()
    assert want
    for n, w in want.items():
        tp.assert_close_to_scale(state[n].numpy(), w.numpy(), 1e-3, n)


def test_dropout_draws_from_the_generator():
    x = torch.ones((64, 1000))
    a = dropout(x, 0.2, True, torch.Generator().manual_seed(3))
    b = dropout(x, 0.2, True, torch.Generator().manual_seed(3))
    c = dropout(x, 0.2, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.8))
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert dropout(x, 0.2, False, None) is x
    assert torch.equal(dropout(x, 1.0, True, None), torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.2, True, None)


def test_classifier_dropout_in_train_mode():
    pm = builders.mobilenet_v2(num_classes=_CLASSES, device="cpu").train()
    x = torch.from_numpy(tp.images(5, _SIZE, b=2))
    with pytest.raises(ValueError, match="Generator"):
        pm(x)
    runs = [pm(x, generator=torch.Generator().manual_seed(s)).detach()
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
