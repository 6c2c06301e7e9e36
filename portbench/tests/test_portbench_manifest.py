"""BENCHMARK.json against the contract's shape, and every name it holds
resolving to a file of its own."""

import json
import os
import re
import shutil

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_whys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    cell = manifest.cell(BENCH, name)
    assert cell["chips"] == 1
    assert cell["traffic"]["entry"] in ("serve", "train")
    assert set(cell["limits"]) and cell["config"]["reduced"] == []
    e2e = manifest.metrics_for(BENCH, name, trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert manifest.metrics_for(BENCH, name, trace=True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_resolves_to_its_reader(metric):
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    assert callable(manifest.reader(metric).read)
    if "layer" in entry:
        moves = next(m for m in BENCH["end_to_end"]
                     if m["name"] == entry["moves"])
        for cell in entry["workloads"]:
            assert cell in moves.get("workloads", CELLS)


def test_configs_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_a_new_cell_is_new_files_only(tmp_path):
    """A cell added by a data file and an entry, no edit of any file."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "assets"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "ssdlite320-serve-b64", "config": BENCH["configs"][0]["name"],
        "traffic": "serve-b64", "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ssdlite320-serve-b128" in m.get("workloads", []):
            m["workloads"].append("ssdlite320-serve-b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "portbench/traffic/serve-b128.json")
                         .read_text())
    traffic.update(name="serve-b64", batch=64)
    (root / "portbench/traffic/serve-b64.json").write_text(json.dumps(traffic))
    work = json.loads((root / "portbench/workloads/ssdlite320-serve-b128.json")
                      .read_text())
    work["name"] = "ssdlite320-serve-b64"
    (root / "portbench/workloads/ssdlite320-serve-b64.json").write_text(
        json.dumps(work))
    loaded = manifest.load_benchmark(str(root))
    cell = manifest.cell(loaded, "ssdlite320-serve-b64", root=str(root))
    assert cell["traffic"]["batch"] == 64 and cell["limits"] == work["limits"]
    names = {m["name"] for m in manifest.metrics_for(
        loaded, "ssdlite320-serve-b64", trace=True)}
    assert "forward_ms.serve" in names and "mfu.serve" in names
