"""The rematerialised train step (`make_train_step(remat=True)`, the JAX
package's `jax.checkpoint` over the train-mode apply) against the plain
step, on the CPU: the flagship at 64x64, 4 classes, B = 2, two SGD
updates, in float64, float32 and bfloat16 compute, one step a call and
steps_per_call = 2.

The recomputed forward runs inside `layers.hold_running_stats()`, so it
normalises by the same batch statistics and leaves the running ones
alone: each step moves them once. On the CPU every op is deterministic,
so the two steps are bit-equal: metrics, every parameter and BN
statistic, and every momentum buffer. A forward hook counts the
extractor's forwards: two a step with remat (forward, recompute), one
without. (The recompute stops once it has made what the backward needs,
before the head's last ops, so the model's own forward hook sees it
start but not end.)
"""

import pytest
import torch

from demonet_tpu_torch.engine.state import create_train_state, make_optimizer
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models import layers
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from tests import torch_parity as tp
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_SIZE = (64, 64)
_DTYPES = ("float64", "float32", "bfloat16")


def _run(dtype, remat, steps_per_call):
    """Two updates from the same seeded model; returns the state, the
    metrics of each update and the extractor's forward count."""
    det = port_ssdlite(num_classes=4, size=_SIZE, device="cpu", seed=3,
                       dtype=torch.bfloat16 if dtype == "bfloat16"
                       else torch.float32)
    if dtype == "float64":
        det.model.double()
    forwards = []
    det.model.extractor.register_forward_hook(lambda *a: forwards.append(1))
    state = create_train_state(det, make_optimizer(0.05, 0.9, 1e-4))
    step = make_train_step(det, remat=remat, steps_per_call=steps_per_call)
    batches = [tp.train_batch(s, _SIZE, 4, b=2) for s in (1, 2)]
    if dtype == "float64":
        batches = [dict(b, images=b["images"].astype("float64"))
                   for b in batches]
    metrics = []
    if steps_per_call == 1:
        for b in batches:
            state, m = step(state, b)
            metrics.append(m)
    else:
        stacked = {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
                   for k in batches[0]}
        state, m = step(state, stacked)
        metrics = [{k: v[i] for k, v in m.items()} for i in range(2)]
    return state, metrics, len(forwards)


@pytest.mark.parametrize("steps_per_call", [1, 2], ids=["single", "spc2"])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_remat_step_bit_equal_to_plain_step(dtype, steps_per_call):
    plain, m_plain, n_plain = _run(dtype, False, steps_per_call)
    remat, m_remat, n_remat = _run(dtype, True, steps_per_call)
    assert (n_plain, n_remat) == (2, 4)
    for a, b in zip(m_plain, m_remat):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    want = plain.model.state_dict()
    for name, value in remat.model.state_dict().items():
        assert value.dtype == want[name].dtype
        assert torch.equal(value, want[name]), name
    for p_plain, p_remat in zip(plain.optimizer.state.values(),
                                remat.optimizer.state.values()):
        assert torch.equal(p_plain["momentum_buffer"],
                           p_remat["momentum_buffer"])
    assert remat.step == plain.step == 2


def test_remat_moves_running_statistics_once_a_step():
    """One remat update moves each BN's running statistics by one
    momentum step of the batch statistics, as one plain update does, not
    two: the same value, and unlike the value two updates of them give."""
    det = port_ssdlite(num_classes=4, size=_SIZE, device="cpu", seed=3)
    bn = det.model.extractor.trunk.stem.bn
    before = bn.running_mean.clone()
    state = create_train_state(det, make_optimizer(0.0, 0.0, 0.0))
    batch = tp.train_batch(1, _SIZE, 4, b=2)
    make_train_step(det, remat=True)(state, batch)
    once = bn.running_mean.clone()
    assert not torch.equal(once, before)
    with torch.no_grad():   # the same model at lr 0: the same batch means
        x = det.model.extractor.trunk.stem.conv(
            ((torch.from_numpy(batch["images"]) - 0.5) / 0.5).permute(
                0, 3, 1, 2))
    mean = x.mean((0, 2, 3))
    decay = 1.0 - bn.momentum
    torch.testing.assert_close(once, decay * before + (1 - decay) * mean,
                               rtol=0, atol=1e-6)
    twice = decay * once + (1 - decay) * mean
    assert not torch.allclose(once, twice, rtol=0, atol=1e-6)


def test_hold_running_stats_keeps_them_and_nests():
    bn = layers.BatchNorm(4, momentum=0.1).train()
    x = torch.randn(2, 4, 3, 3)
    with layers.hold_running_stats():
        with layers.hold_running_stats():
            y = bn(x)
        bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    torch.testing.assert_close(y.mean((0, 2, 3)), bn.bias.detach(),
                               rtol=0, atol=1e-5)
    bn(x)                                    # outside: updated again
    assert not torch.equal(bn.running_mean, torch.zeros(4))
