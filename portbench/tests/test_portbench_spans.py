"""The readers of the program's own spans and set-up counter
(`harness/program_spans.py` and the metrics that read it) on canned
summaries, their None cases, the idle-gap label a program span gives,
and a traced run of a shrunk serve and train cell on the CPU."""

import math
import time

import pytest

from conftest import shrink
from harness import manifest, program_spans, runner, trace
from harness.runner import Run

BENCH = manifest.load_benchmark()
SPAN_READERS = [("head_ms.serve", "serve", "demonet.model.head"),
                ("decode_ms.serve", "serve", "demonet.postprocess.decode"),
                ("topk_ms.serve", "serve", "demonet.postprocess.topk"),
                ("optimizer_ms.train", "train", "demonet.train.optimizer"),
                ("optimizer_ms.train_host_paced", "train",
                 "demonet.train.optimizer")]


def _run(entry, spans=None):
    cell = manifest.cell(BENCH, {"serve": "ssdlite320-serve-b128",
                                 "train": "ssdlite320-train-b128"}[entry])
    r = Run(cell, trace=True)
    if spans is not None:
        r.program_spans = spans
    return r


def _row(device_ms):
    return {"calls": 4, "host_ms": 0.5, "device_ms": device_ms,
            "self_device_ms": device_ms / 2}


@pytest.mark.parametrize("metric,entry,span", SPAN_READERS)
def test_span_reader_on_a_canned_summary(metric, entry, span):
    read = manifest.reader(metric).read
    canned = {span: _row(2.5), "demonet.other": _row(9.0)}
    assert read(_run(entry, canned)) == pytest.approx(2.5)
    other = "train" if entry == "serve" else "serve"
    # another entry, a summary without the span, no recorder at all
    assert read(_run(other, canned)) is None
    assert read(_run(entry, {"demonet.other": _row(9.0)})) is None
    assert read(_run(entry, {})) is None
    r = _run(entry)
    r.program_spans = None
    assert read(r) is None


def test_summary_is_read_once_and_clears_the_records():
    import torch

    from demonet_tpu_torch.utils import spans

    spans.reset()
    r = _run("serve")
    assert program_spans.summary(r) is None      # nothing recorded
    with torch.profiler.profile():
        with spans.span("demonet.predict"):
            pass
    r = _run("serve")
    got = program_spans.summary(r)
    assert got["demonet.predict"]["calls"] == 1
    assert spans.records() == []
    assert program_spans.summary(r) is got


def test_kernel_build_reader(monkeypatch):
    from demonet_tpu_torch.ops import _build

    read = manifest.reader("kernel_build_s").read
    monkeypatch.setattr(_build, "seconds", {
        "nms": {"build_s": 4.5, "load_s": 0.25},
        "gather": {"build_s": 0.0, "load_s": 0.125}})
    assert read(_run("serve")) == pytest.approx(4.875)
    monkeypatch.setattr(_build, "seconds", {})
    assert read(_run("train")) == 0.0
    # an older program without the counter
    monkeypatch.delattr(_build, "seconds")
    assert read(_run("serve")) is None


def test_a_gap_inside_a_program_span_takes_its_name():
    device = [("kernA", 10.0, 30.0), ("kernB", 60.0, 90.0)]
    host = [(trace.WINDOW, 0.0, 100.0), ("portbench.step", 0.0, 95.0),
            ("demonet.predict", 2.0, 94.0),
            ("demonet.postprocess.topk", 25.0, 58.0),
            ("aten::sort", 26.0, 29.0)]
    s = trace.reduce(device, host)
    gaps = dict(s["idle_gaps"])
    # 30..60: the host in Python inside the top-k span
    assert gaps["step/demonet.postprocess.topk"] == pytest.approx(30e-6)
    # 0..10, labelled at its middle, inside the predict span; 90..100
    # past the end of it, Python in the benchmark's own span
    assert gaps["step/demonet.predict"] == pytest.approx(10e-6)
    assert gaps["step/python"] == pytest.approx(10e-6)
    assert not any(name.startswith("demonet.") for name, _ in
                   s["device_ops"])


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("name", ["ssdlite320-serve-b128",
                                  "ssdlite320-train-b128"])
def test_a_traced_cpu_run_reports_the_new_metrics(name):
    out = runner.run(BENCH, name, 2 ** 31 + 45, 0.0, True,
                     time.perf_counter(), device="cpu", tweak=shrink)
    metrics = out["result"]["metrics"]
    new = [m["name"] for m in BENCH["per_layer"]
           if m["source"] == "program_span" and name in m["workloads"]
           and m["name"].split("_ms")[0] in ("head", "decode", "topk",
                                             "optimizer")]
    assert new and "kernel_build_s" in metrics
    for m in new + ["kernel_build_s"]:
        assert math.isfinite(metrics[m]["value"]), m
        assert metrics[m]["value"] >= 0
    assert out["result"]["correct"], out["result"]["checks"]
