"""The export CLI's Caffe flags (demonet_tpu_torch/export/cli.py:
`--format caffe`, `--generic`, `--verify`), driven through `main` with
`--device cpu`; the emitted caffemodel decoded by an independent reader
of the protobuf wire format."""

import copy
import os
import struct

import numpy as np
import pytest

from demonet_tpu.export.caffe import export_caffe as jax_export_caffe
from demonet_tpu.utils.checkpoints import (
    load_npz_variables as jax_load_npz_variables,
)
from demonet_tpu_torch.export import cli
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NPZ = os.path.join(_REPO, "bench_assets", "ssdlite320_shapes_trained.npz")
_MODEL = "ssdlite320_mobilenet_v3_large"


def _run(*argv):
    return cli.main(cli.get_args_parser().parse_args(
        ["--device", "cpu", *argv]))


def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"wire {wire}")
        yield field, wire, val


def _parse_layer(buf):
    layer = {"bottoms": [], "tops": [], "blobs": []}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            layer["name"] = val.decode()
        elif field == 2:
            layer["type"] = val.decode()
        elif field == 3:
            layer["bottoms"].append(val.decode())
        elif field == 4:
            layer["tops"].append(val.decode())
        elif field == 7:
            blob = {}
            for f2, _, v2 in _iter_fields(val):
                if f2 == 7:  # shape
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            dims, p = [], 0
                            while p < len(v3):
                                d, p = _read_varint(v3, p)
                                dims.append(d)
                            blob["shape"] = dims
                elif f2 == 5:  # packed data
                    blob["data"] = np.frombuffer(v2, np.float32)
            layer["blobs"].append(blob)
        elif field == 110:  # eltwise_param
            layer["eltwise_op"] = dict(
                (f2, v2) for f2, _, v2 in _iter_fields(val)).get(1, 1)
    return layer


def _decode(path):
    buf = open(path, "rb").read()
    name, layers = None, []
    for field, _, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 100:
            layers.append(_parse_layer(val))
    return name, layers


def test_cli_caffe_hand_graph_decodes(tmp_path):
    """The flagship's hand-built graph from the trained npz: written under
    the output less `.pt2`, decoded layer by layer, each blob's bits the
    module's, and both files byte-equal to the JAX exporter's on the npz
    variables."""
    net = _run("--num-classes", "91", "--npz-weights", _NPZ, "--format",
               "caffe", "--output", str(tmp_path / "deploy.pt2"))
    prototxt, caffemodel = (str(tmp_path / f"deploy.{ext}")
                            for ext in ("prototxt", "caffemodel"))
    assert sorted(os.listdir(tmp_path)) == ["deploy.caffemodel",
                                            "deploy.prototxt"]
    name, layers = _decode(caffemodel)
    assert name == _MODEL
    txt = open(prototxt).read()
    assert txt.count("layer {") == len(layers) == len(net.layers)
    for got, layer in zip(layers, net.layers):
        assert (got["name"], got["type"], got["bottoms"], got["tops"]) == (
            layer.name, layer.type, layer.bottoms, layer.tops)
        assert len(got["blobs"]) == len(layer.blobs)
        for blob, want in zip(got["blobs"], layer.blobs):
            assert blob["shape"] == list(want.shape)
            np.testing.assert_array_equal(blob["data"], want.reshape(-1))
        if layer.type == "Eltwise":
            assert got["eltwise_op"] == layer.params["operation"]
    by_name = {layer["name"]: layer for layer in layers}
    assert by_name["stem"]["blobs"][0]["shape"] == [16, 3, 3, 3]
    assert by_name["stem_bn"]["blobs"][2]["data"].tolist() == [1.0]
    assert txt.count('"Permute"') == 12 and "scale_param { axis: 0 }" in txt
    jax_export_caffe(_MODEL, jax_load_npz_variables(_NPZ),
                     str(tmp_path / "jax.prototxt"),
                     str(tmp_path / "jax.caffemodel"), num_classes=91)
    for ext, path in (("prototxt", prototxt), ("caffemodel", caffemodel)):
        assert (open(tmp_path / f"jax.{ext}", "rb").read()
                == open(path, "rb").read()), ext


def test_cli_caffe_bf16_writes_float32_parameters(tmp_path):
    """--bf16 builds the model with bf16 compute; its parameters stay
    float32, and the hand-built files are those of the float32 model, as
    the JAX CLI writes its float32 variables."""
    files = {}
    for flags in ((), ("--bf16",)):
        prefix = str(tmp_path / ("bf16" if flags else "fp32"))
        _run("--num-classes", "91", "--npz-weights", _NPZ, "--format",
             "caffe", "--output", prefix, *flags)
        files[flags] = [open(f"{prefix}.{ext}", "rb").read()
                        for ext in ("prototxt", "caffemodel")]
    assert files[()] == files[("--bf16",)]


def test_cli_caffe_generic_classifier(tmp_path, capsys):
    """--generic on a classifier (224x224, its logits): the `.bin` suffix
    comes off, no check runs without --verify."""
    net = _run("--model", "mobilenet_v3_small", "--num-classes", "10",
               "--format", "caffe", "--generic", "--output",
               str(tmp_path / "small.bin"))
    assert sorted(os.listdir(tmp_path)) == ["small.caffemodel",
                                            "small.prototxt"]
    assert net.layers[0].params["input_shape"] == [1, 3, 224, 224]
    assert len(net.output_tops) == 1
    assert "verified" not in capsys.readouterr().out
    name, layers = _decode(str(tmp_path / "small.caffemodel"))
    assert name == "mobilenet_v3_small" and len(layers) == len(net.layers)
    assert "BatchNorm" not in {layer["type"] for layer in layers}


def test_cli_caffe_generic_verify(tmp_path, capsys, monkeypatch):
    """--generic --verify on the trained flagship: the graph of its raw
    heads runs and matches the forward before the files are written. The
    same graph with its first conv weight scaled by 1.01 fails the check
    and writes nothing."""
    from demonet_tpu_torch.export import tracing

    trace, traced = tracing.trace_to_caffe, []
    monkeypatch.setattr(tracing, "trace_to_caffe", lambda *a, **k: (
        traced.append(trace(*a, **k)) or traced[-1]))
    argv = ("--num-classes", "91", "--npz-weights", _NPZ, "--format",
            "caffe", "--generic", "--verify", "--output")
    net = _run(*argv, str(tmp_path / "flagship"))
    assert "verified numerically" in capsys.readouterr().out
    assert len(net.output_tops) == 2
    assert sorted(os.listdir(tmp_path)) == ["flagship.caffemodel",
                                            "flagship.prototxt"]

    bad = copy.deepcopy(traced[0])
    conv = next(layer for layer in bad.layers if layer.type == "Convolution")
    conv.blobs[0] = conv.blobs[0] * np.float32(1.01)
    monkeypatch.setattr(tracing, "trace_to_caffe", lambda *a, **k: bad)
    with pytest.raises(AssertionError):
        _run(*argv, str(tmp_path / "bad"))
    assert sorted(os.listdir(tmp_path)) == ["flagship.caffemodel",
                                            "flagship.prototxt"]


def test_cli_caffe_mlir_still_refused(tmp_path):
    """The C++ runner's package (--aoti, the JAX --mlir) is of the
    torch.export program: --format caffe refuses both flags."""
    with pytest.raises(ValueError, match="--aoti"):
        _run("--format", "caffe", "--mlir", "m.mlir", "--output",
             str(tmp_path / "x"))
    with pytest.raises(ValueError, match="--format caffe"):
        _run("--format", "caffe", "--aoti", str(tmp_path / "x.pt2"),
             "--output", str(tmp_path / "x"))
    assert not os.listdir(tmp_path)


def test_cli_caffe_refuses_a_family_without_a_hand_graph(tmp_path):
    with pytest.raises(ValueError, match="--generic|tracing"):
        _run("--model", "ssd512_vgg16", "--format", "caffe", "--output",
             str(tmp_path / "x"))
    assert not os.listdir(tmp_path)
