"""Port vs JAX package: numerics debugging (demonet_tpu_torch/utils/
debug.py) and the metrics writer's flush and TensorBoard stream
(utils/metrics_writer.py).

`find_bad_gradients` and `tree_finite_report` take the same numpy inputs
as the JAX functions and must report the same paths and numbers, written
as the JAX package writes them (`['w']`, `[0]`).
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demonet_tpu.utils import debug as jax_debug
from demonet_tpu.utils.metrics_writer import MetricsWriter as JaxWriter
from demonet_tpu_torch.utils import debug, spans
from demonet_tpu_torch.utils.metrics_writer import MetricsWriter


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def test_find_bad_gradients_finds_the_jax_paths():
    """The JAX package's own case (tests/test_misc.py): the gradient 1/w
    explodes at a tiny w."""
    params = {"w": np.asarray([1e-9, 1.0], np.float32),
              "ok": np.asarray([1.0], np.float32)}
    got = debug.find_bad_gradients(
        lambda p: torch.sum(torch.log(p["w"])) + torch.sum(p["ok"]),
        _torch_tree(params))
    want = jax_debug.find_bad_gradients(
        lambda p: jnp.sum(jnp.log(p["w"])) + jnp.sum(p["ok"]),
        _jax_tree(params))
    assert got == want
    assert [path for path, _ in got] == ["['w']"]


@pytest.mark.parametrize("magnitude", [1e6, 10.0])
def test_find_bad_gradients_nested_nan_and_magnitude(magnitude):
    params = {"a": {"x": np.asarray([-1.0, 4.0], np.float32),
                    "y": np.asarray([[2.0, 3.0]], np.float32)},
              "b": np.asarray([0.5, 30.0], np.float32),
              "unused": np.ones(3, np.float32)}
    x = np.asarray([2.0, 1.0], np.float32)

    def port_loss(p, x):
        return (torch.sum(torch.sqrt(p["a"]["x"])) + torch.sum(p["a"]["y"])
                + torch.sum(p["b"] ** 2 * x))

    def jax_loss(p, x):
        return (jnp.sum(jnp.sqrt(p["a"]["x"])) + jnp.sum(p["a"]["y"])
                + jnp.sum(p["b"] ** 2 * x))

    got = debug.find_bad_gradients(port_loss, _torch_tree(params),
                                   torch.from_numpy(x), magnitude=magnitude)
    want = jax_debug.find_bad_gradients(jax_loss, _jax_tree(params),
                                        jnp.asarray(x), magnitude=magnitude)
    assert got == want
    assert got[0][0] == "['a']['x']" and got[0][1]["nan_count"] == 1
    assert (len(got) == 2) == (magnitude == 10.0)   # ['b']: 2 * 30 * 1


def test_tree_finite_report_equals_jax():
    tree = {"a": np.asarray([np.inf, 1.0], np.float32),
            "b": [np.ones(2, np.float32), np.asarray([np.nan], np.float32)],
            "c": {"d": np.asarray([-7.0], np.float32),
                  "e": np.zeros((0,), np.float32)}}
    got = debug.tree_finite_report(_torch_tree(tree))
    want = jax_debug.tree_finite_report(_jax_tree(tree))
    assert got == want
    assert got["non_finite_paths"] == ["['a']", "['b'][1]"]
    assert got["num_leaves"] == 5 and got["max_abs"] == float("inf")


def test_tree_finite_report_reads_a_state_dict():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                torch.nn.BatchNorm1d(2))
    with torch.no_grad():
        model[0].bias[1] = float("nan")
    rep = debug.tree_finite_report(model.state_dict())
    assert rep["num_leaves"] == len(model.state_dict())
    assert rep["non_finite_paths"] == ["['0.bias']"]
    assert debug.is_bad_grad(torch.tensor([1.0, 2e6]))
    assert not debug.is_bad_grad(np.asarray([1.0, -3.0]))


def test_graph_to_dot_draws_a_module():
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                                torch.nn.Flatten())
    dot = debug.graph_to_dot(model, torch.zeros(2, 3, 8, 8))
    assert dot.startswith("digraph") and dot.endswith("}")
    assert 'label="input float32[2, 3, 8, 8]"' in dot
    for op in ("Conv2d 0", "ReLU 1", "Flatten 2"):
        assert f'label="{op}"' in dot
    assert "in0 -> op0;" in dot and "op2 -> out0;" in dot
    short = debug.graph_to_dot(lambda x: torch.relu(x) * 2 + 1, max_nodes=1)
    assert "2 more ops" in short and 'label="input x"' in short


def test_nan_checks_and_annotate():
    debug.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        # the backward raises, and the warning names the forward op
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="SqrtBackward"):
            torch.sqrt(x).sum().backward()
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    # the named trace span (the JAX package's `annotate`): the program's
    # span recorder, a CPU range on the profiler's timeline
    spans.reset()
    with torch.profiler.profile() as prof:
        with spans.span("demonet.port_span"):
            torch.ones(4).sum()
    got = [e for e in prof.events() if e.name == "demonet.port_span"]
    assert len(got) == 1 and not got[0].is_user_annotation
    assert spans.summary()["demonet.port_span"]["calls"] == 1
    spans.reset()


def test_metrics_writer_jsonl_flush_and_tensorboard(tmp_path):
    rows = [(1, {"loss": 2.5, "lr": 0.01}), (2, {"loss": 1.25, "lr": 0.02})]
    for cls, sub in ((MetricsWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / sub))
        for step, m in rows:
            w.write(step, m)
        w.flush()
    read = {sub: [json.loads(ln) for ln in open(tmp_path / sub /
                                                 "metrics.jsonl")]
            for sub in ("port", "jax")}
    for got, want in zip(read["port"], read["jax"]):
        assert {k: v for k, v in got.items() if k != "time"} == \
            {k: v for k, v in want.items() if k != "time"}
    assert not MetricsWriter(str(tmp_path / "plain")).tensorboard
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        assert not MetricsWriter(str(tmp_path / "tb"),
                                 tensorboard=True).tensorboard
        return
    w = MetricsWriter(str(tmp_path / "tb"), tensorboard=True)
    assert w.tensorboard
    for step, m in rows:
        w.write(step, m, prefix="val")
    w.flush()
    events = glob.glob(str(tmp_path / "tb" / "tb" / "events.out.tfevents.*"))
    assert len(events) == 1
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(events[0])
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["val/loss", "val/lr"]
    assert [(e.step, e.value) for e in acc.Scalars("val/loss")] == [
        (1, 2.5), (2, 1.25)]
