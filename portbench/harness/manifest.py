"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Everything particular to one of them sits in a file of its own:

  * `configs` entries name their file (`portbench/configs/<config>.json`):
    the model, its sizes and thresholds, where its weights come from;
  * `portbench/reference/archs/<arch>.py`: the reference net of a
    configuration's `arch` where `reference/nets.py` has no branch for it
    (the file's contract is in that module's doc);
  * `portbench/traffic/<traffic>.json`: the entry (`serve` or `train`),
    batch, pool of frames, postprocess mode, optimizer settings;
  * `portbench/workloads/<cell>.json`: the compute dtype, the weights, the
    lower-precision control and the limits of the numbers that decide
    `correct`;
  * `portbench/metrics/<metric>.py`: one reader per metric, end-to-end
    or per-layer, with `read(run) -> float | None`.

So a later cell, configuration or metric is new files and new entries in
BENCHMARK.json, and no edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell `name` with its files read: {'name', 'chips', 'why',
    'config': {...}, 'traffic': {...}, and the workload file's keys}."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    out = dict(entry)
    out.update(_json(os.path.join(root, "portbench", "workloads",
                                  f"{name}.json")))
    out["config"] = _json(os.path.join(root, conf["file"]))
    out["traffic"] = _json(os.path.join(root, "portbench", "traffic",
                                        f"{entry['traffic']}.json"))
    for key in ("config", "traffic"):
        if out[key]["name"] != entry[key]:
            raise ValueError(f"{key} file of {name!r} is named "
                             f"{out[key]['name']!r}, not {entry[key]!r}")
    return out


def metrics_for(bench: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell `name` reports: its end-to-end metrics
    with trace off, its per-layer metrics with trace on. A metric with a
    `workloads` key covers those cells; an end-to-end metric without one
    covers every cell, and a per-layer one every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(metric: str, root: str = ROOT) -> ModuleType:
    """portbench/metrics/<metric>.py as a module."""
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(bench: dict, name: str, trace: bool, run) -> Dict[str, dict]:
    """{metric: {'value', 'unit'}} for the metrics whose reader found
    something to read."""
    out = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
