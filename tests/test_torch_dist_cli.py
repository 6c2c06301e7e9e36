"""The train CLI on two processes: `python -m torch.distributed.run
--nproc_per_node 2 -m demonet_tpu_torch.train --device cpu` (gloo).

One epoch of 8 synthetic frames at --batch-size 2 per rank from the
trained npz, then `--test-only --resume`: both ranks print the same COCO
summary, the resumed one equals the trained one, and only rank 0 writes
(one checkpoint, one metrics line per step). The summary equals the
one-process CLI's at --batch-size 4: the loader's shards (frames 0, 2,
... and 1, 3, ...) make each step's global batch the same 4 frames as
its batch, in another order, which only reorders float sums. One --bf16
epoch: finite losses, both ranks printing the same summary. Each rank's
output goes to its own file (torchrun's --log-dir).
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from demonet_tpu_torch import train as port_train
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NPZ = os.path.join(_REPO, "bench_assets", "ssdlite320_shapes_trained.npz")
_ARGS = ["--dataset", "synthetic", "--synthetic-size", "8",
         "--num-classes", "91", "--device", "cpu", "--print-freq", "1"]
_SUMMARY = re.compile(r"^ Average (Precision|Recall) .* = -?\d+\.\d+$",
                      re.MULTILINE)


def _torchrun(tmp_path, name, *argv):
    """The CLI on two ranks; each rank's printed COCO summary lines."""
    logs = tmp_path / f"logs_{name}"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "--log-dir", str(logs), "--redirects",
           "1", "-m", "demonet_tpu_torch.train", *_ARGS, "--batch-size",
           "2", *argv]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=_REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    outs = [open(glob.glob(str(logs / "*" / "attempt_*" / str(r) /
                               "stdout.log"))[0]).read() for r in (0, 1)]
    assert proc.returncode == 0, (proc.stderr[-3000:], outs)
    return [[m.group(0) for m in _SUMMARY.finditer(o)] for o in outs]


def test_two_rank_cli_trains_resumes_and_only_rank_zero_writes(
        tmp_path, one_thread, capsys):
    out = tmp_path / "run"
    trained = _torchrun(tmp_path, "train", "--epochs", "1", "--npz-weights",
                        _NPZ, "--output-dir", str(out))
    assert len(trained[0]) == 12 and trained[0] == trained[1]
    assert sorted(os.listdir(out)) == ["checkpoint_0",
                                       "checkpoint_0.meta.json",
                                       "metrics.jsonl"]
    with open(out / "metrics.jsonl") as f:
        steps = [json.loads(line) for line in f if line.strip()]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["train/loss"]) for s in steps)
    resumed = _torchrun(tmp_path, "resume", "--test-only", "--resume",
                        str(out / "checkpoint_0"))
    assert resumed[0] == resumed[1] == trained[0]

    capsys.readouterr()
    one = port_train.main(port_train.get_args_parser().parse_args(
        [*_ARGS, "--batch-size", "4", "--epochs", "1", "--npz-weights",
         _NPZ, "--output-dir", str(tmp_path / "one")]))
    printed = [m.group(0) for m in _SUMMARY.finditer(capsys.readouterr().out)]
    assert printed == trained[0]
    assert np.isfinite(one.stats).all() and one.stats[1] > 0


def test_two_rank_cli_bf16_epoch(tmp_path, one_thread):
    out = tmp_path / "run"
    summaries = _torchrun(tmp_path, "bf16", "--bf16", "--epochs", "1",
                          "--npz-weights", _NPZ, "--output-dir", str(out))
    assert len(summaries[0]) == 12 and summaries[0] == summaries[1]
    with open(out / "metrics.jsonl") as f:
        losses = [json.loads(line)["train/loss"] for line in f if line.strip()]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
