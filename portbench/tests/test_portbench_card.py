"""On the card: each cell run as the driver runs it, a short window."""

import json
import os
import subprocess
import sys

import pytest

from harness import manifest

ROOT = manifest.ROOT
BENCH = manifest.load_benchmark()


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(card, name, trace):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, *BENCH["command"][1:]),
         "--workload", name, "--seed", str(2 ** 31 + 77), "--seconds", "3",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    want = {m["name"] for m in manifest.metrics_for(BENCH, name, bool(trace))}
    assert set(result["metrics"]) <= want and result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def test_without_a_card_the_run_prints_no_result(tmp_path):
    """Exit 3 and no result line where torch sees no CUDA device."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, *BENCH["command"][1:]),
         "--workload", BENCH["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=env)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""
