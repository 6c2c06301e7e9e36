"""Port vs JAX package: two bfloat16 train steps of the flagship
(ssdlite320_mobilenet_v3_large at 128x128, 4 classes, B = 4, SGD lr
0.002, momentum 0.9, weight decay 1e-4) from the same float32 variables
on the same batch, against `tests/torch_parity.py::jax_steps(...,
dtype=jnp.bfloat16)`: the JAX builder's dtype=bfloat16, float32
parameters and images, as the JAX CLI's `--bf16` trains.

How close two bf16 steps can be: a bf16 conv rounds its sum once, in
another order in each framework, so the head outputs differ by an ulp or
two (tests/test_torch_bf16_model.py), and BN on the small maps at this
size (2x2 and 1x1 at B = 4) turns ulps into percents of a gradient. The
JAX bf16 step is as far from itself under a 1e-3 change of its input
images (state L2 distance 0.41 after 2 steps) as from the JAX float32
step (0.38). So the tolerance is that noise floor, measured in the test
by the JAX float32 step:

  * the loss terms of each step: |port - JAX bf16| <= 2 |JAX bf16 - JAX
    fp32| + 1 bf16 ulp of the JAX value (measured 0.2-1.2 of the bound);
  * every parameter and BN statistic after step 2, as one vector:
    ||port - JAX bf16|| <= 1.5 ||JAX bf16 - JAX fp32|| (measured 1.08).

At lr 0.05 (the float64 step tests' rate) the same 1e-3 change of the
images moves the JAX bf16 step-2 loss by 6 %: the comparison takes a
rate at which the second step is not chaotic. A port step that ran in
float32 instead would pass these bounds, so the dtypes are checked on
their own: bf16 head outputs, and float32 parameters, BN statistics and
momentum buffers after the steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests import torch_parity as tp
from tests.test_torch_train_step import _draw_variables
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_SIZE = (128, 128)
_CLASSES = 4
_LR = 0.002
_LOSS_FLOOR, _STATE_FLOOR = 2.0, 1.5


def _ulp(x):
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.fixture(scope="module")
def steps():
    jd16 = jax_ssdlite(num_classes=_CLASSES, size=_SIZE, dtype=jnp.bfloat16)
    jd32 = jax_ssdlite(num_classes=_CLASSES, size=_SIZE)
    variables = _draw_variables(jax.eval_shape(jd32.init,
                                               jax.random.PRNGKey(0)),
                                np.random.default_rng(0))
    batch = tp.train_batch(3, _SIZE, _CLASSES, b=4)
    m16, after16 = tp.jax_steps(jd16, variables, batch, 2, jnp.bfloat16,
                                lr=_LR)
    m32, after32 = tp.jax_steps(jd32, variables, batch, 2, jnp.float32,
                                lr=_LR)
    pd = port_ssdlite(num_classes=_CLASSES, size=_SIZE, device="cpu",
                      dtype=torch.bfloat16)
    load_jax_variables(pd.model, variables)
    state = create_train_state(pd, make_optimizer(_LR, tp.MOMENTUM, tp.WD))
    step = make_train_step(pd)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"pd": pd, "state": state, "port": metrics, "jax16": m16,
            "jax32": m32, "after16": tp.jax_state(after16),
            "after32": tp.jax_state(after32), "batch": batch}


def test_bf16_steps_keep_float32_state(steps):
    pd, state = steps["pd"], steps["state"]
    assert pd.dtype == torch.bfloat16
    for name, v in pd.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert v.dtype == torch.float32, name
    buffers = [s["momentum_buffer"] for s in state.optimizer.state.values()]
    assert len(buffers) == len(list(pd.model.parameters()))
    assert all(b.dtype == torch.float32 for b in buffers)
    pd.model.eval()    # no update of the statistics the next test reads
    with torch.no_grad():
        out = pd.model(torch.from_numpy(steps["batch"]["images"]))
    assert out["cls_logits"].dtype == torch.bfloat16


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("term", ["bbox_regression", "classification"])
def test_bf16_loss_terms_within_bf16_noise_of_jax(steps, i, term):
    got = steps["port"][i][term]
    want = steps["jax16"][i][term]
    floor = abs(want - steps["jax32"][i][term])
    assert np.isfinite(got)
    assert abs(got - want) <= _LOSS_FLOOR * floor + _ulp(want), (
        got, want, steps["jax32"][i][term])


def test_bf16_state_after_two_steps_within_bf16_noise_of_jax(steps):
    got = {n: v.double() for n, v in steps["pd"].model.state_dict().items()
           if not n.endswith("num_batches_tracked")}
    want, floor = steps["after16"], steps["after32"]
    assert got.keys() == want.keys()

    def distance(a, b):
        return float(sum(((a[n] - b[n]) ** 2).sum() for n in a) ** 0.5)

    d, noise = distance(got, want), distance(want, floor)
    assert noise > 0 and d <= _STATE_FLOOR * noise, (d, noise)
