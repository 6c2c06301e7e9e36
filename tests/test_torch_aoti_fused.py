"""The C++ runner on the fused postprocess's package
(demonet_tpu_torch/export/aoti.py; tests/test_torch_aoti_runner.py has the
raw heads and the reference postprocess): tests/test_torch_export.py's
5-class detector at 64x64, b2, its branch chosen inside the package by
nested `torch.cond`s. On the seeded input (numpy default_rng(0)) the
runner's dumps are bit-equal to the Python call of the same package and
match the JAX fused `export_detector` artifact within
tests/test_torch_export.py's tolerances (scores 1e-5, boxes 1e-3 px,
labels and valid counts equal); K1, K2 and K3 are extern nodes (K3 in
the exact fallback branch), and on this input, which takes a tier, the
runner calls K1 and K2 and not K3.
"""

import pytest

from demonet_tpu_torch.export import aoti
from tests.torch_aoti import (  # noqa: F401 (fixtures)
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


@pytest.fixture(scope="module")
def fused(ref, runner, frames, tmp_path_factory):
    return package_and_run(("fused",), ref, runner, frames,
                           tmp_path_factory.mktemp("aoti"))["fused"]


def test_fused_runner_dumps_equal_python_call(fused, frames):
    package, result, prefix = fused
    assert result.device == "cpu" and len(result.outputs) == 4
    assert aoti.check_parity(package, prefix, frames[0]) == [0.0] * 4


def test_fused_runner_detections_match_jax_export(ref, fused, frames):
    package, _, prefix = fused
    assert_detections_match(dumped(package, prefix, frames[0]),
                            jax_outputs(ref, frames[0],
                                        postprocess_impl="fused"))


def test_fused_package_calls_k1_and_k2_not_k3(fused):
    targets = set(extern_targets(fused[0]))
    assert {"demonet_tpu_torch::nms_keep_batch",
            "demonet_tpu_torch::gather_rows_batch",
            "demonet_tpu_torch::topk_sparse"} <= targets
    assert fused[1].launches == {"nms_keep_batch": 1,
                                 "gather_rows_batch": 2, "topk_sparse": 0}
