"""`demonet_tpu_torch/utils/debug.py::dump_hlo` (counterpart of
demonet_tpu/utils/debug.py::dump_hlo, held as tests/test_cli.py holds the
JAX one): the compiler's IR of a function or module at the JAX package's
three stages, here mapped onto `torch.export` and Inductor, on the CPU."""

import pytest
import torch
import torch.nn.functional as F

from demonet_tpu_torch.utils.debug import dump_hlo
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _fn(x):
    return F.hardsigmoid(x * 2 + 1).sum()


def test_dump_hlo_jaxpr_stage_is_the_export_graph():
    text = dump_hlo(_fn, torch.ones((4, 4)), stage="jaxpr")
    assert text.startswith("ExportedProgram")
    assert "aten.mul.Tensor" in text
    assert "aten.hardsigmoid.default" in text   # not yet decomposed


def test_dump_hlo_stablehlo_stage_is_core_aten(tmp_path):
    path = tmp_path / "m.txt"
    text = dump_hlo(_fn, torch.ones((4, 4)), stage="stablehlo",
                    path=str(path))
    assert path.read_text() == text
    # hardsigmoid is not a core-ATen op: run_decompositions() writes it out
    assert "aten.hardsigmoid" not in text
    assert "aten.clamp.default" in text and "aten.div.Tensor" in text


def test_dump_hlo_optimized_stage_is_the_aoti_wrapper(tmp_path):
    path = tmp_path / "opt.cpp"
    text = dump_hlo(_fn, torch.ones((4, 4)), stage="optimized",
                    path=str(path))
    assert path.read_text() == text
    assert "AOTInductorModel" in text      # the C++ wrapper on the CPU
    assert ".kernel.cpp" in text           # and its kernel source


def test_dump_hlo_takes_a_module():
    conv = torch.nn.Conv2d(3, 4, 3)
    text = dump_hlo(conv, torch.ones((1, 3, 8, 8)), stage="jaxpr")
    assert "aten.conv2d" in text or "aten.convolution" in text


def test_dump_hlo_refuses_an_unknown_stage():
    with pytest.raises(ValueError, match="jaxpr|stablehlo|optimized"):
        dump_hlo(_fn, torch.ones((4, 4)), stage="relay")
