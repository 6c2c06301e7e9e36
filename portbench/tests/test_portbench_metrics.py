"""The metric arithmetic on canned data: a trace's busy time, idle share
and gaps, the tail percentile, K1's roofline share, the work counts."""

import statistics

import pytest
import torch

from harness import manifest, trace, work
from harness.runner import Run

BENCH = manifest.load_benchmark()


def _run(entry, **kw):
    cell = manifest.cell(BENCH, {"serve": "ssdlite320-serve-b128",
                                 "train": "ssdlite320-train-b128"}[entry])
    r = Run(cell, trace=True)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


CANNED_DEVICE = [("kernA", 10.0, 30.0), ("kernB", 25.0, 40.0),
                 ("Memcpy HtoD", 60.0, 70.0), ("kernA", 100.0, 150.0),
                 ("kernC", 190.0, 260.0)]
CANNED_HOST = [(trace.WINDOW, 0.0, 200.0), ("portbench.step", 0.0, 95.0),
               ("aten::conv2d", 40.0, 55.0), ("cudaLaunchKernel", 41.0, 44.0),
               ("portbench.download", 150.0, 200.0),
               ("cudaStreamSynchronize", 150.0, 199.0)]


def test_busy_union_and_gaps_of_a_canned_trace():
    s = trace.reduce(CANNED_DEVICE, CANNED_HOST)
    # window 0..200 us; busy [10,40] + [60,70] + [100,150] + [190,200]
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(100e-6)
    assert s["kernels"]["kernA"] == [pytest.approx(70e-6), 2]
    assert s["kernels"]["kernC"][0] == pytest.approx(10e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["step/aten::conv2d"] == pytest.approx(20e-6)      # 40..60
    assert gaps["download/cudaStreamSynchronize"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(100e-6)
    assert s["device_ops"][0][0] == "kernA"
    idle = manifest.reader("device_idle_pct.serve").read(
        _run("serve", trace_summary=s))
    assert idle == pytest.approx(50.0)


def test_a_trace_without_host_events_spans_the_device_activity():
    s = trace.reduce(CANNED_DEVICE, [])
    assert s["window_s"] == pytest.approx(250e-6)
    assert s["busy_s"] == pytest.approx(160e-6)
    assert trace.reduce([], []) is None


def test_p95_is_over_every_request():
    lat = [0.010] * 95 + [0.100] * 5
    r = _run("serve", latencies_s=lat)
    want = statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
    assert manifest.reader("predict_p95_ms").read(r) == pytest.approx(want)
    r = _run("serve", images=1280, window_s=2.0)
    assert manifest.reader("predict_img_s").read(r) == pytest.approx(640.0)
    assert manifest.reader("train_img_s").read(r) is None


def test_k1_roofline_share():
    s = {"kernels": {"(anonymous namespace)::nms_block_kernel(float4 const*)":
                     [0.004, 16], "other": [1.0, 3]}}
    r = _run("serve", trace_summary=s, launches={"k1_nms": 1.0},
             k1_bound_ms=0.025)
    r.cell["traffic"]["trace_requests"] = 16
    # 0.25 ms a launch against a 0.025 ms bound
    assert manifest.reader("k1_nms_roofline.serve").read(r) == \
        pytest.approx(10.0)
    assert manifest.reader("k1_nms_roofline.serve").read(
        _run("serve", trace_summary={"kernels": {}}, launches={},
             k1_bound_ms=0.025)) is None


def test_mfu_and_phase_means():
    r = _run("train", trace_summary={"busy_s": 1.0}, flops_per_image=1e9,
             images=1000, window_s=1.0, peak_flops=1e13,
             phase_ms={"forward": [1.0, 3.0], "loss": [1.0],
                       "backward": [4.0]}, step_host_s=[0.002, 0.004])
    assert manifest.reader("mfu.train").read(r) == pytest.approx(10.0)
    assert manifest.reader("forward_ms.train").read(r) == pytest.approx(2.0)
    assert manifest.reader("step_host_ms.train").read(r) == pytest.approx(3.0)
    assert manifest.reader("mfu.serve").read(r) is None


def test_nms_work_and_bound():
    scores = torch.tensor([[0.9, 0.8, 0.7, -1e30], [0.5, -1e30, -1e30,
                                                     -1e30]])
    keep = torch.tensor([[True, False, True, False], [True, False, False,
                                                      False]])
    nbytes, ops = work.nms_work(keep, scores, -5e29)
    # 8 scores, 4 live boxes of 16 B, 8 mask bytes; pairs: 1 (two kept in
    # row 0) + 1 suppressed live
    assert nbytes == 8 * 4 + 4 * 16 + 8
    assert ops == 2 * work.OPS_PER_IOU + 4 * 3
    assert work.bound_ms(3.35e9, 0.0) == pytest.approx(1.0)
    assert work.bound_ms(0.0, 67e9) == pytest.approx(1.0)
