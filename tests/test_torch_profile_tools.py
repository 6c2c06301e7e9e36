"""The port's profiling tools on the CPU: tools/profile_model_torch.py,
tools/trace_op_stats_torch.py and tools/roofline_report_torch.py.

The profile tool traces the flagship's predict and train steps at b2 with
`--device cpu` (the trace holds the step's convolutions and their flop
counts, and its last line the program's spans over the traced call), raises with no GPU unless asked for the CPU, builds the
lane-packed flagship under `--lane-pack`, and refuses `--frames` of
another size than the model's before any step runs. The stats tool
reads a small trace written here in the format torch.profiler writes on
the card (host ops with flops, runtime
launches, kernels and a copy linked by `correlation`, an idle gap), and
its rollup, TFLOP/s, launches and top list are stated below; it refuses a
trace with no device events. The roofline tool's flops over the
Conv2d/Linear leaves equal 2*N*Ho*Wo*Co*(Ci/groups)*k^2 counted from
forward hooks, for the flagship and ssd300_vgg16, in both modes, and its
speed-of-light arithmetic is checked on records written by hand.
"""

import gzip
import json
import os
import sys

import pytest
import torch
from torch import nn

from tests.torch_parity import one_thread  # noqa: F401 (fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import profile_model_torch  # noqa: E402
import roofline_report_torch  # noqa: E402
import trace_op_stats_torch  # noqa: E402

from demonet_tpu_torch.models.builders import get_model  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")


def _profile_args(tmp_path, *extra):
    return profile_model_torch.get_args_parser().parse_args(
        ["--batch-size", "2", "--iters", "1", "--logdir", str(tmp_path),
         *extra])


@pytest.mark.parametrize("mode", ["predict", "train"])
def test_profile_tool_traces_the_step_on_the_cpu(tmp_path, mode):
    out = profile_model_torch.main(
        _profile_args(tmp_path, "--mode", mode, "--device", "cpu"))
    name = f"ssdlite320_mobilenet_v3_large_{mode}.pt.trace.json.gz"
    want = os.path.join(str(tmp_path), name)
    assert out["trace"] == want and os.listdir(tmp_path) == [name]
    with gzip.open(want, "rt") as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    names = [e["name"] for e in ops]
    # the flagship's 98 convolutions (trunk, extras, heads), once a call
    assert names.count("aten::convolution") == 98
    assert names.count("aten::convolution_backward") == (
        98 if mode == "train" else 0)
    conv_flops = [e["args"].get("flops") for e in ops
                  if e["name"] == "aten::conv2d"]
    assert len(conv_flops) == 98 and all(conv_flops)
    assert out["events_with_flops"] >= 98
    # no card, so no kernel launched
    assert not any(out["launches"].values())
    # the program's spans over the one traced call, in the trace too
    root = {"predict": "demonet.predict", "train": "demonet.train_step"}[mode]
    assert out["spans"][root]["calls"] == 1
    assert out["spans"]["demonet.model.head"]["device_ms"] > 0
    assert set(out["spans"]) <= set(names)
    with pytest.raises(SystemExit, match="no device events"):
        trace_op_stats_torch.summarize(want, iters=1)


def test_profile_tool_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_model_torch.main(_profile_args(tmp_path))
    assert not os.listdir(tmp_path)


def test_profile_tool_lane_pack_traces_the_packed_model(tmp_path,
                                                        monkeypatch):
    from demonet_tpu_torch.models import builders

    built, get = [], builders.get_model

    def spy(name, **kw):
        built.append(get(name, **kw))
        return built[-1]

    monkeypatch.setattr(builders, "get_model", spy)
    out = profile_model_torch.main(
        _profile_args(tmp_path, "--lane-pack", "--device", "cpu"))
    trunk = built[0].model.extractor.trunk
    assert trunk.plan[:3] == [8, 2, 1]
    assert type(trunk.blocks[0].depthwise.conv).__name__ == "PackedConv2d"
    with gzip.open(out["trace"], "rt") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "cpu_op"]
    assert names.count("aten::convolution") == 98


def test_profile_tool_refuses_frames_of_another_size(tmp_path):
    """The 320x320 frames for ssd300_vgg16 (300x300): refused, naming both
    sizes, before weights, frames or a step are read or run."""
    frames = os.path.join(_REPO, "bench_assets", "val_images_320.npz")
    with pytest.raises(ValueError, match="320x320 frames .* 300x300"):
        profile_model_torch.main(_profile_args(
            tmp_path, "--model", "ssd300_vgg16", "--frames", frames,
            "--device", "cpu"))
    assert not os.listdir(tmp_path)


def _op(name, ts, dur, flops=None):
    args = {"External id": ts}
    if flops:
        args["flops"] = flops
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 100,
            "tid": 100, "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel", dur=5):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 100,
            "tid": 100, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7}}


_XMMA = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
_NVJET = "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT"
_ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::AUnaryFunctor<float, float, float>>(int, float*)")
_K1 = ("(anonymous namespace)::nms_block_kernel(float4 const*, float const*, "
       "bool*, int, int, float, float)")


def _card_trace():
    """One iteration: a convolution (2 GFLOP on aten::conv2d, its cuDNN
    kernel and an elementwise kernel launched inside it), K1, a pageable
    copy, a kernel of no known kind, an idle gap of 150 us, then a matrix
    product (1 GFLOP on aten::matmul and again on the aten::mm inside
    it) and the synchronize."""
    return [
        _op("aten::conv2d", 0, 50, flops=2e9),
        _op("aten::cudnn_convolution", 5, 40),
        _launch(10, 11), _launch(20, 12),
        _op("demonet_tpu_torch::nms_keep_batch", 55, 10),
        _launch(60, 13),
        _launch(70, 14, name="cudaMemcpyAsync"),
        _launch(75, 16),
        _op("aten::matmul", 200, 30, flops=1e9),
        _op("aten::mm", 205, 20, flops=1e9),
        _launch(210, 15),
        _launch(240, 17, name="cudaDeviceSynchronize", dur=540),
        _kernel(_XMMA, 100, 200, 11),
        _kernel(_ELEMENTWISE, 300, 50, 12),
        _kernel(_K1, 400, 100, 13),
        _kernel("Memcpy HtoD (Pageable -> Device)", 500, 50, 14,
                cat="gpu_memcpy"),
        _kernel("my_unknown_kernel", 550, 50, 16),
        _kernel(_NVJET, 750, 100, 15),
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": -50, "dur": 2000},
    ]


def test_trace_stats_on_a_card_trace(tmp_path, capsys):
    older = tmp_path / "old.pt.trace.json"
    older.write_text(json.dumps({"traceEvents": [_op("aten::add", 0, 1)]}))
    path = tmp_path / "step" / "card.pt.trace.json.gz"
    path.parent.mkdir()
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": _card_trace()}, f)
    os.utime(older, (0, 0))
    s = trace_op_stats_torch.main(
        trace_op_stats_torch.get_args_parser().parse_args(
            [str(tmp_path), "--iters", "1", "--top", "3"]))
    assert s["trace"] == str(path)
    assert s["device_events"] == 6
    # busy 200 + 50 + 100 + 50 + 50 + 100 us; window 0 .. 850 us
    assert s["device_busy_ms_per_iter"] == pytest.approx(0.55)
    assert s["window_ms_per_iter"] == pytest.approx(0.85)
    assert s["device_idle_share"] == pytest.approx(1 - 550 / 850)
    # conv2d's 2 GFLOP go to its cuDNN kernel alone; mm's 1 GFLOP to the
    # matmul kernel, and matmul's own count is not added
    assert s["gflop_per_iter"] == pytest.approx(3.0)
    assert s["tflops_per_s"] == pytest.approx(3e9 / 550e-6 / 1e12)
    cats = s["categories"]
    # by device time; ties in the order the trace first shows them
    assert list(cats) == ["convolution and matrix products",
                          "nms_keep_batch", "elementwise", "copies", "other"]
    prod = cats["convolution and matrix products"]
    assert prod["ms_per_iter"] == pytest.approx(0.3)
    assert prod["share"] == pytest.approx(300 / 550)
    assert prod["launches_per_iter"] == 2
    assert prod["tflops_per_s"] == pytest.approx(10.0)
    assert cats["nms_keep_batch"]["ms_per_iter"] == pytest.approx(0.1)
    assert cats["nms_keep_batch"]["tflops_per_s"] is None
    assert cats["copies"]["ms_per_iter"] == pytest.approx(0.05)
    assert cats["elementwise"]["gflop_per_iter"] == 0
    assert cats["other"]["launches_per_iter"] == 1
    assert s["hand_written_launches_per_iter"] == {
        "nms_keep_batch": 1, "gather_rows_batch": 0, "topk_sparse": 0,
        "fused_inverted_residual": 0}
    top = s["top"]
    assert [k["name"] for k in top] == [_XMMA, _K1, _NVJET]
    assert top[0]["tflops_per_s"] == pytest.approx(10.0)
    assert top[0]["category"] == "convolution and matrix products"
    assert top[1]["category"] == "nms_keep_batch"
    # the last line printed is the same numbers as JSON
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(s))


@pytest.mark.parametrize("name, want", [
    ("void gather_rows_kernel(float4 const*, int const*, float4*, int)",
     "gather_rows_batch"),
    ("topk_sparse_long_kernel(float const*, float*, int*, int, int)",
     "topk_sparse"),
    ("void (anonymous namespace)::topk_sparse_classes_kernel(float const*, "
     "float*, int*, int, int, long, long, int, float)", "topk_sparse"),
    ("fused_block_kernel(float const*, float const*)",
     "fused_inverted_residual"),
    ("void (anonymous namespace)::nms_sweep_kernel<2>(float const*, long "
     "const*, bool*, int, int)", "nms_keep_batch"),
    ("(anonymous namespace)::gather_rows_coord_major_kernel(float4 const*)",
     "gather_rows_batch"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(float*)", "batch norm"),
    ("void at::native::batch_norm_collect_statistics_kernel<float>(int)",
     "batch norm"),
    (_XMMA, "convolution and matrix products"),
    ("wgrad2d_shmem_tiling", "convolution and matrix products"),
    ("dgrad2d_c1_k1_nhwc_specialized", "convolution and matrix products"),
    ("void conv2d_grouped_direct_kernel<float, float>(float*)",
     "convolution and matrix products"),
    ("void at::native::reduce_kernel<512, 1>(float*)", "reduction"),
    ("void cub::DeviceRadixSortOnesweepKernel<int>(int*)", "sort and select"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel>()",
     "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, Mul>(int)",
     "elementwise"),
])
def test_trace_stats_categories(name, want):
    got = trace_op_stats_torch.category({"cat": "kernel", "name": name})
    assert got == want


def _hook_count(model_name, mode):
    """Forward-hook count over every Conv2d and Linear:
    2 * N * Ho * Wo * Co * (Ci / groups) * kh * kw a forward (Linear: 2 *
    rows * in * out), and in train mode one more for the weight's
    gradient and one for the input's where the input needs one."""
    det = get_model(model_name, num_classes=91, device="meta")
    model = det.model.train(mode == "train")
    total = [0]

    def hook(m, args, out):
        x = args[0]
        if isinstance(m, nn.Conv2d):
            n, co, ho, wo = out.shape
            kh, kw = m.kernel_size
            f = 2 * n * ho * wo * co * (m.in_channels // m.groups) * kh * kw
        else:
            f = 2 * out.numel() * m.in_features
        if mode == "train":
            f *= 2 + x.requires_grad
        total[0] += f

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.register_forward_hook(hook)
    h, w = det.config.size
    model(torch.zeros((1, h, w, 3), device="meta"))
    return total[0]


@pytest.mark.parametrize("mode", ["infer", "train"])
@pytest.mark.parametrize("model_name", ["ssdlite320_mobilenet_v3_large",
                                        "ssd300_vgg16"])
def test_roofline_flops_equal_the_hook_count(model_name, mode):
    records, input_bytes, counted = roofline_report_torch.leaf_records(
        model_name, 91, 1, "fp32", mode)
    products = sum(r["flops"] for r in records
                   if r["type"] in ("Conv2d", "Linear"))
    want = _hook_count(model_name, mode)
    assert products == want
    # every counted flop sits on a product leaf
    assert sum(r["flops"] for r in records) == counted == want
    h, w = get_model(model_name, device="meta").config.size
    assert input_bytes == h * w * 3 * 4


def test_roofline_speed_of_light_arithmetic():
    records = [{"path": "a", "type": "Conv2d", "flops": 989e9,
                "in_bytes": 1e9, "out_bytes": 2e9, "param_bytes": 0.35e9},
               {"path": "b", "type": "ReLU", "flops": 0.0,
                "in_bytes": 2e9, "out_bytes": 2e9, "param_bytes": 0.0}]
    layers, tot = roofline_report_torch.roofline(
        records, 0.5e9, "bf16", "infer", measured=4.0)
    assert tot["tensor_core_ms"] == pytest.approx(1.0)
    assert tot["hbm_unfused_ms"] == pytest.approx(7.35e9 / 3.35e12 * 1e3)
    # fused floor: each output written and read once, input and params once
    fused = 2 * 4e9 + 0.5e9 + 0.35e9
    assert tot["fused_bytes"] == pytest.approx(fused)
    assert tot["speed_of_light_ms"] == pytest.approx(fused / 3.35e12 * 1e3)
    assert tot["bound_by"] == "bytes"
    assert tot["measured_over_floor"] == pytest.approx(
        4.0 / tot["speed_of_light_ms"])
    assert tot["share_of_speed_of_light"] == pytest.approx(
        tot["speed_of_light_ms"] / 4.0)
    assert [r["path"] for r in layers] == ["b", "a"]
    assert layers[1]["min_ms"] == pytest.approx(1.0)
    # train: bytes 3x, flops as given; fp32 is held to the same peak
    _, tr = roofline_report_torch.roofline(records, 0.5e9, "fp32", "train")
    assert tr["fused_bytes"] == pytest.approx(3 * fused)
    assert tr["tensor_core_ms"] == pytest.approx(1.0)
    assert "measured_ms" not in tr
    # a product-bound case
    _, big = roofline_report_torch.roofline(
        [{**records[0], "flops": 989e12}], 0.5e9, "bf16", "infer")
    assert big["speed_of_light_ms"] == pytest.approx(1000.0)
    assert big["bound_by"] == "operations"
