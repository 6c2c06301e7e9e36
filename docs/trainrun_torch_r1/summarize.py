"""Read the logs of docs/trainrun_torch_r1/run.sh and check the protocol's
gates; print the numbers TRAINRUN.md quotes, as JSON.

    python docs/trainrun_torch_r1/summarize.py [LOG_DIR]

For each family whose logs are in LOG_DIR (default: this directory):
the stages' exit codes and wall seconds (<family>_stages.log), the
COCO summary of every epoch's evaluation, the epoch stage 2 resumed at,
the first printed loss of stage 1 and the mean loss of the last epoch,
s per epoch and ms per step (the CLI's "s / it"), the loader's `data:`
time, the evaluation's img/s, and whether each test-only summary equals
stage 2's last one (all 12 numbers, as printed). Exit code 1 if a gate
fails: a stage that did not exit 0, a resume at the wrong epoch, a loss
that did not fall, a final mAP at or below 0.5, a test-only summary
that differs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_DOCS = os.path.dirname(_HERE)
# each family's test-only runs beside its stage 1 and stage 2
_FAMILIES = {"ssdlite": ("testonly", "testonly_fused"),
             "pelee": ("testonly",),
             "sslv2": ("testonly",),
             "vgg300": ("testonly", "testonly_fused"),
             "vgg512": ("testonly",)}


def _jax_logs(folder, prefix):
    return [os.path.join(_DOCS, folder, f"{prefix}_{s}.log")
            for s in ("stage1", "stage2", "testonly")]


# the JAX package's runs of the same protocol on the TPU (a reference,
# not a target): stage 1, stage 2 and test-only logs. ssd512_vgg16's JAX
# stage 2 was stopped in epoch 17 (its last evaluation is epoch 16's),
# and its test-only stage read checkpoint_16, not checkpoint_23
# (docs/trainrun_r5/TRAINRUN.md).
_JAX_LOGS = {
    "ssdlite": _jax_logs("trainrun_r3", "shapes_r3"),
    "pelee": _jax_logs("trainrun_r5", "pelee"),
    "sslv2": _jax_logs("trainrun_r5", "sslv2"),
    "vgg300": _jax_logs("trainrun_r4", "vgg_r4"),
    "vgg512": _jax_logs("trainrun_r5", "vgg512"),
}
_SUMMARY = re.compile(r"^ Average (Precision|Recall) .* = (-?\d+\.\d+)$")
_EPOCH_TOTAL = re.compile(
    r"^Epoch: \[(\d+)\] Total time: \S+ \((\S+) s / it\)")
_TEST_TOTAL = re.compile(r"^Test: Total time: \S+ \((\S+) s / it\)")
_STEP_LINE = re.compile(
    r"^Epoch: \[(\d+)\]\s+\[\s*(\d+)/(\d+)\].*\bloss: (\S+) \((\S+)\)"
    r".*\btime: (\S+)\s+data: (\S+)")
_TEST_LINE = re.compile(r"^Test:\s+\[\s*(\d+)/(\d+)\]")
_RESUMED = re.compile(r"^resumed from \S+ at epoch (\d+)")
_STAGE = re.compile(r"^\S+ (\S+) rc=(-?\d+) seconds=(\S+)$")
_VAL_IMAGES = 200
# the protocol's gate on the final mAP
_MIN_MAP = 0.5


def parse_log(path):
    """One CLI log: its evaluations (12 numbers each, as printed), the
    epochs and their s / it, the printed step lines, the test passes'
    s / it and batches, and the resume epoch."""
    out = {"summaries": [], "epochs": [], "steps": [], "tests": [],
           "resumed_at": None}
    summary, test_batches = [], 0
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            m = _SUMMARY.match(line)
            if m:
                summary.append(m.group(2))
                if len(summary) == 12:
                    out["summaries"].append(summary)
                    summary = []
                continue
            m = _EPOCH_TOTAL.match(line)
            if m:
                out["epochs"].append((int(m.group(1)), float(m.group(2))))
                continue
            m = _STEP_LINE.match(line)
            if m:
                out["steps"].append({
                    "epoch": int(m.group(1)), "i": int(m.group(2)),
                    "n": int(m.group(3)), "loss": float(m.group(4)),
                    "loss_epoch_mean": float(m.group(5)),
                    "time": float(m.group(6)), "data": float(m.group(7))})
                continue
            m = _TEST_LINE.match(line)
            if m:
                test_batches = int(m.group(2))
                continue
            m = _TEST_TOTAL.match(line)
            if m:
                out["tests"].append((float(m.group(1)), test_batches))
                continue
            m = _RESUMED.match(line)
            if m:
                out["resumed_at"] = int(m.group(1))
    return out


def stages(path):
    """{stage: (exit code, wall seconds)} from run.sh's stage lines."""
    got = {}
    with open(path) as f:
        for line in f:
            m = _STAGE.match(line.strip())
            if m:
                got[m.group(1)] = (int(m.group(2)), float(m.group(3)))
    return got


def jax_reference(name):
    """The JAX run's per-epoch mAP / AP50, first and last losses and
    test-only summary, read from its committed logs."""
    s1, s2, test = (parse_log(p) for p in _JAX_LOGS[name])
    epochs = s1["epochs"] + s2["epochs"]
    evals = s1["summaries"] + s2["summaries"]
    steps = s1["steps"] + s2["steps"]
    last = [s for s in steps if s["epoch"] == epochs[-1][0]][-1]
    return {"logs": [os.path.relpath(p, _DOCS) for p in _JAX_LOGS[name]],
            "per_epoch": [{"epoch": e, "map": float(ev[0]),
                           "ap50": float(ev[1])}
                          for (e, _), ev in zip(epochs, evals)],
            "loss_first_printed": steps[0]["loss"],
            "loss_last_epoch_mean": last["loss_epoch_mean"],
            "test_only": [float(v) for v in test["summaries"][-1][:3]]}


def family(log_dir, name, test_only):
    logs = {s: parse_log(os.path.join(log_dir, f"{name}_{s}.log"))
            for s in ("stage1", "stage2", *test_only)}
    ran = stages(os.path.join(log_dir, f"{name}_stages.log"))
    s1, s2 = logs["stage1"], logs["stage2"]
    evals = s1["summaries"] + s2["summaries"]
    epochs = s1["epochs"] + s2["epochs"]
    steps = s1["steps"] + s2["steps"]
    last_epoch = epochs[-1][0]
    last = [s for s in steps if s["epoch"] == last_epoch][-1]
    per_epoch = [{"epoch": e, "map": float(ev[0]), "ap50": float(ev[1]),
                  "ap75": float(ev[2]), "s_per_it": spi,
                  "train_s": spi * steps[0]["n"]}
                 for (e, spi), ev in zip(epochs, evals)]
    steady = [p["s_per_it"] for p in per_epoch if p["epoch"]
              not in (0, s2["epochs"][0][0])]
    # each epoch's last printed line: the loader's wait, averaged over
    # the window of the last 20 steps
    data = [[s for s in steps if s["epoch"] == e][-1]["data"]
            for e, _ in epochs]
    tests = s1["tests"] + s2["tests"]
    eval_s = [spi * n for spi, n in tests]
    out = {
        "stages": {k: {"rc": v[0], "seconds": v[1]} for k, v in ran.items()},
        "epochs_stage1": len(s1["epochs"]), "epochs_stage2": len(s2["epochs"]),
        "resumed_at": s2["resumed_at"],
        "resume_expected": s1["epochs"][-1][0] + 1,
        "loss_first_printed": steps[0]["loss"],
        "loss_last_epoch_mean": last["loss_epoch_mean"],
        "final": {"map": float(evals[-1][0]), "ap50": float(evals[-1][1]),
                  "ap75": float(evals[-1][2])},
        "per_epoch": per_epoch,
        "s_per_epoch_train_median": statistics.median(steady) * steps[0]["n"],
        "ms_per_step_median": statistics.median(steady) * 1e3,
        "time_column_median_ms": statistics.median(
            s["time"] for s in steps if s["i"]) * 1e3,
        "data_column_median_ms": statistics.median(data) * 1e3,
        "eval_seconds_median": statistics.median(eval_s),
        "eval_img_per_s_median": _VAL_IMAGES / statistics.median(eval_s),
        "test_only": {},
    }
    for t in test_only:
        got = logs[t]["summaries"]
        out["test_only"][t] = {
            "summary": got[-1] if got else None,
            "equals_stage2_last": bool(got) and got[-1] == evals[-1],
            "eval_seconds": (logs[t]["tests"][0][0] * logs[t]["tests"][0][1]
                             if logs[t]["tests"] else None),
            "resumed_at": logs[t]["resumed_at"]}
    gates = {
        "every_stage_exit_0": len(ran) == 2 + len(test_only) and all(
            rc == 0 for rc, _ in ran.values()),
        "resumed_at_next_epoch": s2["resumed_at"] == out["resume_expected"],
        "loss_fell": out["loss_last_epoch_mean"] < out["loss_first_printed"],
        "final_map_above": out["final"]["map"] > _MIN_MAP,
        "test_only_equal": all(v["equals_stage2_last"]
                               for v in out["test_only"].values()),
    }
    out["gates"] = gates
    out["jax_reference"] = jax_reference(name)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("log_dir", nargs="?", default=_HERE)
    args = p.parse_args(argv)
    result = {}
    card = os.path.join(args.log_dir, "card.log")
    if os.path.exists(card):
        # one line a call of run.sh: the families it ran and the card
        with open(card) as f:
            result["card"] = [ln.strip() for ln in f if ln.strip()]
    for name, test_only in _FAMILIES.items():
        if os.path.exists(os.path.join(args.log_dir, f"{name}_stage1.log")):
            result[name] = family(args.log_dir, name, test_only)
    print(json.dumps(result, indent=1))
    ok = all(all(v["gates"].values()) for k, v in result.items()
             if k != "card")
    return 0 if ok and len(result) > ("card" in result) else 1


if __name__ == "__main__":
    sys.exit(main())
