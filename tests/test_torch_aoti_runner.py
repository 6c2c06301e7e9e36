"""The C++ runner (demonet_tpu_torch/csrc/aoti_runner.cc, aoti_ops.cc and
export/aoti.py; counterpart of cpp/pjrt_runner.cc and
tools/check_pjrt_parity.py), built and run here on the CPU.

Two AOTInductor packages of tests/test_torch_export.py's 5-class
detector at 64x64, b2 (the JAX variables drawn with numpy and carried in
by `load_jax_variables`): the raw heads and the reference postprocess
(the fused one: tests/test_torch_aoti_fused.py). On the same seeded input
(numpy default_rng(0)):

  * the runner's dumped outputs are bit-equal to `aoti_load_package` of
    the same package in Python. Both run the same compiled code; K1 and K2
    run in the runner as aoti_ops.cc's C++ plain versions and in Python as
    ops/nms.py's and ops/gather.py's, so this also holds the C++ CPU ops
    bit-equal to the Python ones;
  * they match the JAX `export_detector` artifact within
    tests/test_torch_export.py's tolerances: heads 1e-4, scores 1e-5,
    boxes 1e-3 px, labels and valid counts equal;
  * the reference package holds K1 and K2 as extern nodes, and the runner
    counts 1 NMS and 2 gathers a call;
  * without the ops library, or with an input file of the wrong size, the
    runner exits nonzero and says why.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from demonet_tpu_torch.export import aoti
from tests.torch_aoti import (  # noqa: F401 (fixtures)
    SHAPE,
    assert_detections_match,
    dumped,
    extern_targets,
    frames,
    jax_outputs,
    package_and_run,
    ref,
    runner,
)
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_HEADS = ("cls_logits", "bbox_regression")


@pytest.fixture(scope="module")
def runs(ref, runner, frames, tmp_path_factory):
    return package_and_run(("raw", "reference"), ref, runner, frames,
                           tmp_path_factory.mktemp("aoti"))


@pytest.mark.parametrize("kind", ["raw", "reference"])
def test_runner_dumps_equal_python_call(kind, runs, frames):
    package, result, prefix = runs[kind]
    assert result.device == "cpu"
    assert len(result.outputs) == (2 if kind == "raw" else 4)
    assert result.iters == 2 and result.ms["p50"] > 0
    diffs = aoti.check_parity(package, prefix, frames[0])
    assert diffs == [0.0] * len(result.outputs)


def test_runner_raw_heads_match_jax_export(ref, runs, frames):
    want = jax_outputs(ref, frames[0], with_postprocess=False)
    package, _, prefix = runs["raw"]
    got = dumped(package, prefix, frames[0])
    assert sorted(got) == sorted(_HEADS)
    for key in _HEADS:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)


def test_runner_detections_match_jax_export(ref, runs, frames):
    package, _, prefix = runs["reference"]
    assert_detections_match(dumped(package, prefix, frames[0]),
                            jax_outputs(ref, frames[0]))


def test_reference_package_keeps_kernels_as_extern_nodes(runs):
    assert sorted(extern_targets(runs["reference"][0])) == [
        "demonet_tpu_torch::gather_rows_batch",
        "demonet_tpu_torch::gather_rows_batch",
        "demonet_tpu_torch::nms_keep_batch"]
    assert extern_targets(runs["raw"][0]) == []


@pytest.mark.parametrize("kind,nms,gathers", [("raw", 0, 0),
                                              ("reference", 1, 2)])
def test_runner_counts_kernel_calls(kind, nms, gathers, runs):
    result = runs[kind][1]
    assert result.launches == {"nms_keep_batch": nms,
                               "gather_rows_batch": gathers}
    assert result.calls == result.iters + 3


def test_runner_without_ops_library_names_the_missing_schema(
        runner, runs, frames):
    result = aoti.run_runner(runner, runs["reference"][0], SHAPE, iters=1,
                             ops=False, input_file=frames[1], check=False)
    assert result.returncode != 0
    assert "Could not find schema for demonet_tpu_torch::" in result.stderr
    assert "OK" not in result.stdout.split()


def test_runner_refuses_input_of_the_wrong_size(runner, runs, tmp_path):
    short = str(tmp_path / "short.bin")
    np.zeros(SHAPE, np.float32)[1:].tofile(short)
    result = aoti.run_runner(runner, runs["raw"][0], SHAPE, iters=1,
                             input_file=short, check=False)
    assert result.returncode != 0
    assert re.search(r"has \d+ bytes, want \d+", result.stderr)


def test_ops_library_schemas_equal_the_python_ops():
    """A text check of csrc/aoti_ops.cc (the library is never loaded into
    this process, where the Python ops define the namespace)."""
    with open(os.path.join(aoti.CSRC_DIR, "aoti_ops.cc")) as f:
        source = f.read()
    defs = re.findall(r'm\.def\(((?:\s*"[^"]*")+)\);', source)
    schemas = sorted("".join(re.findall(r'"([^"]*)"', d)) for d in defs)
    ops = torch.ops.demonet_tpu_torch
    want = sorted(str(getattr(ops, n).default._schema).split("::", 1)[1]
                  for n in ("nms_keep_batch", "gather_rows_batch"))
    assert schemas == want


def test_cuda_build_links_the_kernel_libraries():
    """The card's build, read from its command lines: the CUDA ops, K1's
    and K2's libraries with their rpath, libtorch_cuda kept as needed."""
    libs = {"nms": "/b/nms-0123.so", "gather": "/b/gather-4567.so"}
    cmds = aoti._commands("cuda", libs)
    ops = cmds["aoti_ops"]
    assert "-DDEMONET_WITH_CUDA" in ops and "-shared" in ops
    assert "-l:nms-0123.so" in ops and "-l:gather-4567.so" in ops
    assert f"-Wl,-rpath,{aoti.BUILD_DIR}" in ops
    for cmd in cmds.values():
        keep = cmd.index("-Wl,--no-as-needed")
        assert keep < cmd.index("-ltorch") < cmd.index("-Wl,--as-needed")
        assert keep < cmd.index("-ltorch_cuda") < cmd.index("-Wl,--as-needed")
        assert any(c.startswith("-Wl,-rpath,") and c.endswith("torch/lib")
                   for c in cmd)
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"
    assert all(abi in cmd for cmd in cmds.values())
    assert "-DDEMONET_WITH_CUDA" not in aoti._commands("cpu", {})["aoti_ops"]


def test_build_honours_cxx(monkeypatch):
    """The runner's build takes $CXX, as Inductor does for a package, and
    the g++ on PATH without it."""
    monkeypatch.setenv("CXX", "custom-g++")
    cmds = aoti._commands("cpu", {})
    assert all(cmd[0] == "custom-g++" for cmd in cmds.values())
    monkeypatch.delenv("CXX")
    assert aoti.compiler() == shutil.which("g++")


def test_parity_tool_flow(runner, runs, tmp_path, capsys):
    """`python -m demonet_tpu_torch.export.aoti`: --make-input, the
    runner on that input, the check; a changed dump fails it."""
    package, prefix = runs["reference"][0], str(tmp_path / "out")
    aoti.main([package, prefix, "--make-input"])
    x = np.fromfile(f"{prefix}.input.bin", np.float32)
    assert x.size == np.prod(SHAPE)
    aoti.run_runner(runner, package, SHAPE, iters=1, threads=1,
                    input_file=f"{prefix}.input.bin", dump_out=prefix)
    aoti.main([package, prefix])
    assert "PARITY OK" in capsys.readouterr().out
    scores = np.fromfile(f"{prefix}.1.bin", np.float32)
    scores[0] += 1.0
    scores.tofile(f"{prefix}.1.bin")
    with pytest.raises(SystemExit):
        aoti.main([package, prefix])
    assert "MISMATCH" in capsys.readouterr().out
