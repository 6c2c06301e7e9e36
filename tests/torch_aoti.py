"""Shared fixtures and helpers of the C++ runner's tests
(tests/test_torch_aoti_runner.py, tests/test_torch_aoti_fused.py): the
5-class detector of tests/test_torch_export.py at 64x64, its packages at
b2, the runner built for the CPU, and the comparisons with the JAX
`export_detector` artifact at tests/test_torch_export.py's tolerances."""

import jax
import numpy as np
import pytest
import torch

from demonet_tpu.export.stablehlo import export_detector as jax_export
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.export import aoti
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import draw_variables

SIZE = (64, 64)
B = 2
SHAPE = (B, *SIZE, 3)
DETECTIONS = ("boxes", "scores", "labels", "valid")
PACKAGE_KWARGS = {"raw": {"with_postprocess": False}, "reference": {},
                  "fused": {"postprocess_impl": "fused"}}


@pytest.fixture(scope="module")
def ref():
    """The 5-class detector at 64x64, its JAX variables drawn with numpy
    and carried into the port."""
    jd = jax_ssdlite(num_classes=5, size=SIZE)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
    variables = draw_variables(shapes, np.random.default_rng(0))
    pd = port_ssdlite(num_classes=5, size=SIZE, device="cpu")
    load_jax_variables(pd.model, variables)
    return {"jd": jd, "pd": pd, "variables": variables}


@pytest.fixture(scope="module")
def runner():
    return aoti.build_runner("cpu")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The seeded input (numpy default_rng(0)) and its raw file."""
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)
    path = str(tmp_path_factory.mktemp("input") / "input.bin")
    x.tofile(path)
    return x, path


def package_and_run(kinds, ref, runner, frames, tmp):
    """Package each kind at b2 and run it through the runner on the seeded
    frames, its outputs dumped: {kind: (package, RunnerResult, dump
    prefix)}. One thread, as the tests call the packages in Python
    (`one_thread`, which a module fixture runs before): Inductor writes
    the CPU code for the thread count it compiles under (one: no OpenMP
    regions beside the other test workers), and the runner's convolutions
    round by the count they run with."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kind in kinds:
            package = aoti.package_detector(
                ref["pd"], str(tmp / f"{kind}.pt2"), batch_size=B,
                **PACKAGE_KWARGS[kind])
            prefix = str(tmp / kind)
            result = aoti.run_runner(runner, package, SHAPE, iters=2,
                                     input_file=frames[1], dump_out=prefix,
                                     threads=1)
            out[kind] = (package, result, prefix)
    finally:
        torch.set_num_threads(threads)
    return out


def jax_outputs(ref, x, **kwargs):
    return {k: np.asarray(v) for k, v in jax_export(
        ref["jd"], ref["variables"], batch_size=B, platforms=("cpu",),
        **kwargs).call(x).items()}


def dumped(package, prefix, x):
    """The runner's dumps, keyed as the program's outputs, read with the
    Python call's dtypes and shapes."""
    with torch.no_grad():
        want = aoti.load_package(package)(torch.from_numpy(x))
    keys = list(want)
    got = aoti.read_dumps(prefix, [want[k] for k in keys])
    return {k: g.numpy() for k, g in zip(keys, got)}


def _sorted_dets(d, i):
    v = d["valid"][i]
    s, lab, box = d["scores"][i][v], d["labels"][i][v], d["boxes"][i][v]
    order = np.lexsort((lab, -s))
    return s[order], lab[order], box[order]


def assert_detections_match(got, want):
    """tests/test_torch_export.py's comparison with the JAX artifact:
    equal valid counts and labels, scores within 1e-5, boxes within 1e-3
    px, each image's detections sorted by (-score, label)."""
    assert list(got) == list(DETECTIONS)
    for key in want:
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
    assert np.array_equal(want["valid"].sum(1), got["valid"].sum(1))
    assert want["valid"].any()
    for i in range(B):
        ws, wl, wb = _sorted_dets(want, i)
        gs, gl, gb = _sorted_dets(got, i)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)


def extern_targets(package):
    """The ops a package calls by name: its wrapper.json's extern nodes
    (a package that calls none has no such file)."""
    import json
    import zipfile

    with zipfile.ZipFile(package) as z:
        return [node["node"]["target"]
                for name in z.namelist() if name.endswith(".wrapper.json")
                for node in json.loads(z.read(name))["nodes"]]
