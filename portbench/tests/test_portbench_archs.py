"""A configuration whose reference net lives in a file of its own
(`reference/archs/<arch>.py`) enters as new files and new entries only:
a copy of the tree with such a configuration runs a whole serve cell."""

import functools
import json
import os
import re
import shutil
import time

import pytest

import flops
from conftest import shrink
from harness import manifest, runner
from reference import nets

BENCH = manifest.load_benchmark()
ARCH_FILE = '''"""SSD300's VGG16 net, from the reference package's parts."""

from reference import nets


def build(config, anchors_per_location, num_classes):
    ext = nets.VGGExtractor()
    head = nets.Head(lambda ci, co: nets.Conv(ci, co, 3, padding=1),
                     ext.out_channels, anchors_per_location, num_classes)
    return nets.Net(ext, head)
'''
CONFIG, CELL = "ssd300_vgg16_file", "ssd300file-serve-b128"
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A copy of the tree with one more configuration (arch
    `ssd_vgg16_file`, known to `nets.build` only by its file, run by the
    program's `ssd300_vgg16`) and one serve cell of it; the harness
    reads the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "assets"))
    pb = root / "portbench"
    (pb / "reference/archs").mkdir(exist_ok=True)
    (pb / "reference/archs/ssd_vgg16_file.py").write_text(ARCH_FILE)
    cfg = json.loads((pb / "configs/ssd300_vgg16.json").read_text())
    cfg.update(name=CONFIG, arch="ssd_vgg16_file")
    (pb / f"configs/{CONFIG}.json").write_text(json.dumps(cfg))
    work = json.loads((pb / "workloads/ssd300-serve-b128.json").read_text())
    work["name"] = CELL
    (pb / f"workloads/{CELL}.json").write_text(json.dumps(work))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": CONFIG, "source": cfg["source"],
        "file": f"portbench/configs/{CONFIG}.json", "reduced": [],
        "why": "ssd300's net from a file of its own"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "serve-b128", "chips": 1,
        "why": "a cell of a configuration that only new files make"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ssd300-serve-b128" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(nets, "ARCHS", str(pb / "reference/archs"))
    monkeypatch.setattr(manifest, "cell",
                        functools.partial(manifest.cell, root=str(root)))
    return manifest.load_benchmark(str(root))


def test_a_whole_cell_of_an_arch_file_is_correct(checkout, monkeypatch):
    def small(cell):
        shrink(cell)
        cell["dtype"] = "float32"

    runs = []
    read_metrics = manifest.read_metrics
    monkeypatch.setattr(manifest, "read_metrics",
                        lambda *a: runs.append(a[-1]) or read_metrics(*a))
    out = runner.run(checkout, CELL, 2 ** 31 + 13, 0.0, True,
                     time.perf_counter(), device="cpu", tweak=small)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["checks"]["dets_mismatch"]["value"] == 0
    assert "forward_ms.serve" in res["metrics"]
    # the CPU has no device trace, so mfu.serve reads nothing here; given
    # one, it reads the arch file's FLOPs, which are ssd300's
    run = runs[-1]
    ssd300 = manifest.cell(checkout, "ssd300-serve-b128")["config"]
    assert run.flops_per_image == flops.flops_per_image(ssd300, "serve") > 0
    run.trace_summary = {"busy_s": 1.0, "window_s": 1.0}
    assert manifest.reader("mfu.serve").read(run) > 0


def test_an_unknown_arch_names_the_file_it_looked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(nets, "ARCHS", str(tmp_path))
    cfg = {"arch": "no_such_arch", "aspect_ratios": [[2]], "num_classes": 3}
    with pytest.raises(ValueError, match=re.escape(
            str(tmp_path / "no_such_arch.py"))):
        nets.build(cfg, "meta")
