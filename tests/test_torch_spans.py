"""The port's span recorder (demonet_tpu_torch/utils/spans.py) in its steps,
and the kernel libraries' set-up counter (ops/_build.py's `seconds`), on
the CPU.

  * with no profiler the predict and train steps record nothing, and
    `span` is the shared no-op;
  * under a CPU `torch.profiler` a tiny detector's predict step (the
    reference and the fused postprocess) and train step give exactly
    their span trees: names, parents, one root a call, the all-reduce's
    span with a mesh (one gloo rank) and not without; each span is a CPU
    range of the trace and no user annotation (which the profiler would
    mirror as a device row);
  * `tally`'s self-time arithmetic on canned rows;
  * `torch.export` under a profiler records no span and puts no profiler
    op in the graph;
  * `_build.seconds` with nvcc replaced by a stub.
"""

import os
import stat

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from demonet_tpu_torch.engine.evaluate import make_predict_step
from demonet_tpu_torch.engine.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.export import export_detector
from demonet_tpu_torch.models import detection
from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
from demonet_tpu_torch.ops import _build
from demonet_tpu_torch.parallel.mesh import data_mesh
from demonet_tpu_torch.utils import spans
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_SIZE = (64, 64)
_B = 2

PREDICT_TREE = [
    ("demonet.predict", None),
    ("demonet.preprocess", "demonet.predict"),
    ("demonet.forward", "demonet.predict"),
    ("demonet.model.extractor", "demonet.forward"),
    ("demonet.model.head", "demonet.forward"),
    ("demonet.postprocess", "demonet.predict"),
    ("demonet.postprocess.decode", "demonet.postprocess"),
]
REFERENCE_TAIL = [
    ("demonet.postprocess.topk", "demonet.postprocess"),
    ("demonet.postprocess.gather", "demonet.postprocess"),
    ("demonet.postprocess.nms", "demonet.postprocess"),
    ("demonet.postprocess.select", "demonet.postprocess"),
]
TRAIN_TREE = [
    ("demonet.train_step", None),
    ("demonet.train.upload", "demonet.train_step"),
    ("demonet.forward", "demonet.train_step"),
    ("demonet.model.extractor", "demonet.forward"),
    ("demonet.model.head", "demonet.forward"),
    ("demonet.loss", "demonet.train_step"),
    ("demonet.loss.match", "demonet.loss"),
    ("demonet.loss.mine", "demonet.loss"),
    ("demonet.train.backward", "demonet.train_step"),
    ("demonet.train.optimizer", "demonet.train_step"),
]


@pytest.fixture(scope="module")
def det():
    return ssdlite320_mobilenet_v3_large(num_classes=5, size=_SIZE,
                                         device="cpu")


@pytest.fixture(autouse=True)
def no_records():
    spans.reset()
    yield
    spans.reset()


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((_B, *_SIZE, 3), dtype=np.float32))


def _batch():
    return {"images": _images(1),
            "gt_boxes": torch.tensor([[[4.0, 4.0, 40.0, 40.0]]] * _B),
            "gt_labels": torch.ones((_B, 1), dtype=torch.int64),
            "gt_valid": torch.ones((_B, 1), dtype=torch.bool)}


def _train(det):
    state = create_train_state(det, make_optimizer(make_lr_schedule(0.01,
                                                                    100)))
    return state, make_train_step(det)


def _tree(calls):
    """The records of `calls` consecutive calls as (name, parent) per
    call, checking that each call is one root with one call number."""
    got = spans.records()
    roots = [i for i, (_, parent, _) in enumerate(got) if parent is None]
    assert len(roots) == calls
    out = []
    for j, start in enumerate(roots):
        end = roots[j + 1] if j + 1 < len(roots) else len(got)
        rows = got[start:end]
        assert len({call for _, _, call in rows}) == 1
        out.append([(name, parent) for name, parent, _ in rows])
    assert len({got[i][2] for i in roots}) == calls
    return out


def test_off_path_records_nothing(det):
    assert spans.span("demonet.anything") is spans.OFF
    step = make_predict_step(det)
    step(det.model, _images())
    state, tstep = _train(det)
    tstep(state, _batch())
    assert spans.records() == [] and spans.summary() == {}


def test_predict_step_span_tree_reference(det):
    step = make_predict_step(det)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(det.model, _images())
    for tree in _tree(2):
        assert tree == PREDICT_TREE + REFERENCE_TAIL
    s = spans.summary()
    assert set(s) == {n for n, _ in PREDICT_TREE + REFERENCE_TAIL}
    for row in s.values():
        assert row["calls"] == 2
        assert row["host_ms"] > 0
        assert row["device_ms"] >= row["self_device_ms"] >= 0
    # off the card the device clock is the host's: the root holds its
    # children
    assert s["demonet.predict"]["device_ms"] >= s["demonet.forward"][
        "device_ms"] + s["demonet.postprocess"]["device_ms"]
    events = [e for e in prof.events() if e.name.startswith("demonet.")]
    assert len(events) == len(spans.records())
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation


@pytest.mark.parametrize("branch", ["tier", "fallback"])
def test_predict_step_span_tree_fused(det, branch, monkeypatch):
    if branch == "fallback":
        monkeypatch.setattr(detection, "_fused_capacity",
                            lambda scores, config: None)
    step = make_predict_step(det, impl="fused")
    detection._postprocess_fused.branches.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        step(det.model, _images())
    (taken,) = detection._postprocess_fused.branches
    assert taken.startswith(branch)
    fused = [("demonet.postprocess.fused", "demonet.postprocess"),
             ("demonet.postprocess.fused_guard",
              "demonet.postprocess.fused")]
    # the exact fallback's spans open inside the fused one
    tail = [(n, "demonet.postprocess.fused") for n, _ in REFERENCE_TAIL]
    assert _tree(1) == [PREDICT_TREE + fused
                        + (tail if branch == "fallback" else [])]


def test_train_step_span_tree_and_phases(det):
    state, step = _train(det)
    phases = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, _batch(), on_phase=phases.append)
    assert phases == ["forward", "loss", "backward", "optimizer"] * 2
    for tree in _tree(2):
        assert tree == TRAIN_TREE
    assert "demonet.train.allreduce" not in spans.summary()
    for e in prof.events():
        if e.name.startswith("demonet."):
            assert e.device_type == torch.autograd.DeviceType.CPU
            assert not e.is_user_annotation


def test_train_step_mesh_span(det, tmp_path):
    """A mesh step (one gloo rank) adds `demonet.train.allreduce` between
    the backward and the optimizer."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = data_mesh([torch.device("cpu")])
        assert mesh.group is not None
        state = create_train_state(det, make_optimizer(make_lr_schedule(
            0.01, 100)))
        step = make_train_step(det, mesh=mesh)
        with profile(activities=[ProfilerActivity.CPU]):
            step(state, _batch())
    finally:
        dist.destroy_process_group()
    want = list(TRAIN_TREE)
    want.insert(-1, ("demonet.train.allreduce", "demonet.train_step"))
    assert _tree(1) == [want]


def test_tally_self_time_on_canned_rows():
    # call 1: root 0..10 with children 1..4 and 3..6 (union 5) and 8..12
    # (clipped to 8..10); a grandchild 1..2 inside the first child;
    # call 2: the root again, 0..4, no children
    rows = [("r", -1, 1, 11.0, 0.0, 10.0),
            ("a", 0, 1, 3.0, 1.0, 4.0),
            ("g", 1, 1, 1.0, 1.0, 2.0),
            ("a", 0, 1, 3.0, 3.0, 6.0),
            ("b", 0, 1, 2.0, 8.0, 12.0),
            ("r", -1, 2, 5.0, 0.0, 4.0)]
    s = spans.tally(rows)
    assert s["r"] == {"calls": 2, "host_ms": 8.0, "device_ms": 7.0,
                      "self_device_ms": pytest.approx((3.0 + 4.0) / 2)}
    # a: two rows in one call; the first's self time less its grandchild
    assert s["a"] == {"calls": 1, "host_ms": 6.0, "device_ms": 6.0,
                      "self_device_ms": pytest.approx(5.0)}
    assert s["b"]["self_device_ms"] == pytest.approx(4.0)
    assert s["g"]["calls"] == 1
    assert spans.tally([]) == {}


def test_export_under_a_profiler_records_no_span(det):
    with profile(activities=[ProfilerActivity.CPU]):
        exported = export_detector(det, batch_size=1, with_postprocess=False)
    assert spans.records() == []
    for node in exported.graph_module.graph.nodes:
        target = str(node.target)
        assert "profiler" not in target and "record_function" not in target


def test_build_seconds_with_a_stub_nvcc(tmp_path, monkeypatch):
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=$2; fi; shift\n"
        "done\n"
        "sleep 0.2\n"
        "echo built > \"$out\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "seconds", {})
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    lib = _build.load("nms")
    assert lib == ("lib", _build.library_path("nms"))
    assert os.path.exists(_build.library_path("nms"))
    first = dict(_build.seconds["nms"])
    assert 0.2 <= first["build_s"] < 30 and first["load_s"] >= 0
    # built already: the library is linked again at no nvcc cost, and a
    # second load is the cached library
    _build.build("nms")
    _build.load("nms")
    assert _build.seconds["nms"] == first
    assert set(_build.seconds) == {"nms"}
