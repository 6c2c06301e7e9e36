"""The PyTorch port stands alone: demonet_tpu_torch and chip_smoke.py import
nothing of JAX, flax, optax, orbax or the JAX package, import with no GPU,
nvcc or triton, and never fall back to the CPU unasked."""

import os
import re
import subprocess
import sys

import pytest
import torch

from demonet_tpu_torch.models.builders import (
    resolve_device,
    ssdlite320_mobilenet_v3_large,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `import jax`, `from jax...`, optax, orbax, any flax, or the JAX package
# by name; the port's own name `demonet_tpu_torch` does not match; in C++,
# an XLA or PJRT header
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax\b|flax\b|optax\b|orbax\b"
    r"|demonet_tpu(?!_torch)\b)"
    r"|\bflax\b|\bdemonet_tpu\."
    r"|^\s*#\s*include\s*[<\"](xla|tsl|pjrt)/", re.MULTILINE)


def _port_sources():
    root = os.path.join(_REPO, "demonet_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cc")):
                yield os.path.join(d, f)
    yield os.path.join(_REPO, "chip_smoke.py")


def test_import_pulls_in_no_jax():
    modules = ", ".join("demonet_tpu_torch." + m for m in (
        "models.builders", "models.losses", "models.matcher",
        "engine.evaluate", "engine.state", "engine.train",
        "ops.fused_block", "parallel.dist", "parallel.mesh",
        "utils.checkpoints",
        "utils.freeze", "utils.logging", "utils.metrics_writer",
        "utils.weights", "data", "data.coco", "data.coco_eval",
        "data.group_by_aspect_ratio", "data.loader", "data.presets",
        "data.synthetic", "data.transforms", "data.voc", "data.voc_eval",
        "data.native", "utils.torch_weights", "utils.pretrained", "utils.viz",
        "utils.debug", "hub", "predict", "eval_voc", "train",
        "ops.library", "export", "export.program", "export.cli",
        "export.caffe", "export.caffe_eval", "export.tracing",
        "export.aoti"))
    code = (f"import demonet_tpu_torch, {modules}; import sys; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'demonet_tpu', 'triton')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                   timeout=120)


_PROBE_DATASET = """
import sys

from demonet_tpu_torch.data.synthetic import SyntheticDetection

_BANNED = ('jax', 'flax', 'optax', 'orbax', 'demonet_tpu', 'triton')


class ProbeDataset(SyntheticDetection):
    def __getitem__(self, idx, rng=None):
        bad = [m for m in sys.modules if m.split('.')[0] in _BANNED]
        if bad:
            raise RuntimeError(f"loader worker imported {bad[:5]}")
        return super().__getitem__(idx, rng)
"""


def test_loader_worker_imports_no_jax(tmp_path):
    """A DetectionLoader spawn worker, which imports the port's data
    modules to unpickle its dataset, pulls in no JAX."""
    (tmp_path / "probe_dataset.py").write_text(_PROBE_DATASET)
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r})\n"
            "from probe_dataset import ProbeDataset\n"
            "from demonet_tpu_torch.data.loader import DetectionLoader\n"
            "ld = DetectionLoader(ProbeDataset(n=4, image_size=(32, 32)), 2,"
            " (32, 32), num_workers=1)\n"
            "assert [b['batch_valid'].all() for b in ld] == [True, True]\n")
    subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                   timeout=120)


def test_sources_name_no_jax():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            text = f.read()
        hits = [m.group(0) for m in _FORBIDDEN.finditer(text)]
        assert not hits, f"{os.path.relpath(path, _REPO)}: {hits}"


def test_scan_pattern_catches_what_it_should():
    for bad in ("import jax\n", "from jax import numpy\n",
                "import flax.linen\n", "from demonet_tpu.ops import nms\n",
                "x = demonet_tpu.models\n", "import optax\n",
                "from orbax import checkpoint\n",
                '#include "xla/pjrt/c/pjrt_c_api.h"\n'):
        assert _FORBIDDEN.search(bad), bad
    for fine in ("import demonet_tpu_torch\n",
                 "from demonet_tpu_torch.ops import nms\n",
                 "# counterpart of demonet_tpu/ops/nms.py\n",
                 "#include <torch/library.h>\n",
                 "// counterpart of cpp/pjrt_runner.cc\n"):
        assert not _FORBIDDEN.search(fine), fine


def test_no_gpu_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssdlite320_mobilenet_v3_large(num_classes=5, size=(64, 64))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
