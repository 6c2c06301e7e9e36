"""The shapes train-run protocol (docs/trainrun_torch_r1/run.sh) on the
CPU, and the committed script's flags.

The protocol's three stages run in process through
`demonet_tpu_torch.train.main` on a tools/make_dataset.py corpus of 8
train and 4 val JPEGs, at b4 in bf16 (`--bf16 --seed 0 --score-thresh
0.01`): a fresh stage of one epoch, a `--resume` stage to epoch 2 from
its checkpoint, and `--test-only --resume` of the last checkpoint, whose
COCO stats must equal stage 2's last evaluation bit for bit with the
reference postprocess, with `--postprocess fused` and with `-j 2`.

run.sh runs here with `python` and `nvidia-smi` replaced by stand-ins
that record their arguments (the `python` stand-in also makes the
checkpoint directories a training stage would write): every
`demonet_tpu_torch.train` invocation must parse with the port's parser,
carry its family's recipe (docs/trainrun_r3/TRAINRUN.md for the
flagship, docs/trainrun_r5/run.sh for pelee304, ssd_lite_mobilenet_v2
and ssd512_vgg16, docs/trainrun_r4/TRAINRUN.md for ssd300_vgg16), each
`--resume` must name the `checkpoint_{epochs - 1}` of the stage before
it, only the last checkpoint may be left, and card.log gains one line.

The committed logs of its run on the GPU pass the protocol's gates as
docs/trainrun_torch_r1/summarize.py reads them, each family's final mAP
within 0.05 of the JAX package's run of the same protocol.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from demonet_tpu_torch import train as cli
from tools import make_dataset

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUN_SH = os.path.join(_REPO, "docs", "trainrun_torch_r1", "run.sh")
_COMMON = ["--dataset", "coco", "--num-classes", "91", "--batch-size", "4",
           "--bf16", "--seed", "0", "--score-thresh", "0.01",
           "--print-freq", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """The three stages on a corpus of 8 train and 4 val images, with one
    intra-op thread (beside the other test workers)."""
    root = tmp_path_factory.mktemp("trainrun")
    corpus, out = str(root / "shapes"), str(root / "run")
    make_dataset.make_split(corpus, "train", 8, 0)
    make_dataset.make_split(corpus, "val", 4, 1)
    argv = [*_COMMON, "--data-path", corpus, "--output-dir", out]

    printed = {}

    def run(name, *extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = cli.main(cli.get_args_parser().parse_args([*argv, *extra]))
        printed[name] = buf.getvalue()
        return got

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stage1 = run("stage1", "--epochs", "1")
        stage2 = run("stage2", "--epochs", "2", "--resume",
                     os.path.join(out, "checkpoint_0"))
        last = os.path.join(out, "checkpoint_1")
        test_only = {
            "reference": run("reference", "--test-only", "--resume", last),
            "fused": run("fused", "--test-only", "--resume", last,
                         "--postprocess", "fused"),
            "j2": run("j2", "--test-only", "--resume", last, "-j", "2")}
    finally:
        torch.set_num_threads(threads)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f if line.strip()]
    return {"stage1": stage1, "stage2": stage2, "test_only": test_only,
            "metrics": metrics, "out": out, "printed": printed}


def test_stage2_resumes_at_the_next_epoch(protocol):
    out = protocol["out"]
    assert (f"resumed from {out}/checkpoint_0 at epoch 1"
            in protocol["printed"]["stage2"])
    assert "Epoch: [1]" in protocol["printed"]["stage2"]
    assert "Epoch: [0]" not in protocol["printed"]["stage2"]
    with open(os.path.join(out, "checkpoint_1.meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 1
    assert meta["metadata"]["args"]["resume"].endswith("checkpoint_0")
    # 8 images at b4: 2 steps an epoch, stage 2 from step 3 on
    assert [m["step"] for m in protocol["metrics"]] == [1, 2, 3, 4]


def test_logged_losses_are_finite(protocol):
    losses = [m["train/loss"] for m in protocol["metrics"]]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.isfinite(protocol["stage1"].stats).all()


@pytest.mark.parametrize("mode", ["reference", "fused", "j2"])
def test_test_only_reproduces_the_last_evaluation(protocol, mode):
    want = protocol["stage2"].stats
    got = protocol["test_only"][mode].stats
    assert got.dtype == want.dtype and got.shape == want.shape == (12,)
    np.testing.assert_array_equal(got, want)


# the `python` stand-in: its arguments, one line a call, appended to
# $CALLS; a training stage's checkpoint_0 ... checkpoint_{epochs - 1}
# made under its --output-dir
_FAKE_PYTHON = """#!/bin/sh
printf "%s\\n" "$*" >> "$CALLS"
out= epochs= test_only=
while [ $# -gt 0 ]; do
    case $1 in
    --output-dir) out=$2 ;;
    --epochs) epochs=$2 ;;
    --test-only) test_only=1 ;;
    esac
    shift
done
if [ -n "$out" ] && [ -n "$epochs" ] && [ -z "$test_only" ]; then
    e=0
    while [ $e -lt $epochs ]; do
        mkdir -p "$out/checkpoint_$e"
        : > "$out/checkpoint_$e.meta.json"
        e=$((e + 1))
    done
fi
"""


def _fake_bin(folder):
    """`python` and `nvidia-smi` stand-ins (see _FAKE_PYTHON)."""
    os.makedirs(folder)
    with open(os.path.join(folder, "python"), "w") as f:
        f.write(_FAKE_PYTHON)
    with open(os.path.join(folder, "nvidia-smi"), "w") as f:
        f.write('#!/bin/sh\necho "stand-in, 0 W"\n')
    for name in ("python", "nvidia-smi"):
        os.chmod(os.path.join(folder, name), 0o755)


@pytest.fixture(scope="module")
def run_sh_calls(tmp_path_factory):
    """run.sh with stand-ins, from an empty directory: the argument
    vectors of its train CLI invocations, parsed, in order, and its
    stage lines."""
    root = tmp_path_factory.mktemp("run_sh")
    _fake_bin(str(root / "bin"))
    calls = str(root / "calls.txt")
    env = dict(os.environ, CALLS=calls,
               PATH=str(root / "bin") + os.pathsep + os.environ["PATH"])
    work = root / "work"
    work.mkdir()
    done = subprocess.run([shutil.which("sh"), _RUN_SH], cwd=work, env=env,
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr
    with open(calls) as f:
        argvs = [line.split() for line in f if line.strip()]
    assert argvs[0][:1] == ["tools/make_dataset.py"]
    assert argvs[0][1:] == ["--root", ".data/shapes", "--train", "1500",
                            "--val", "200"]
    train = []
    for argv in argvs[1:]:
        assert argv[:2] == ["-m", "demonet_tpu_torch.train"], argv
        train.append(cli.get_args_parser().parse_args(argv[2:]))
    return {"train": train, "stdout": done.stdout, "work": work}


# each family's flags, the epochs of its stages 1 and 2, and the
# postprocess of each of its test-only runs
_RECIPES = {
    "ssdlite320_mobilenet_v3_large": (
        dict(batch_size=32, lr=0.02, lr_steps=[16, 20], score_thresh=None),
        (16, 24), ["reference", "fused"]),
    "pelee304": (
        dict(batch_size=32, lr=0.02, lr_steps=[10, 14], score_thresh=0.01),
        (10, 16), ["reference"]),
    "ssd_lite_mobilenet_v2": (
        dict(batch_size=32, lr=0.02, lr_steps=[10, 14], score_thresh=0.01),
        (10, 16), ["reference"]),
    "ssd300_vgg16": (
        dict(batch_size=32, lr=0.001, lr_steps=[22, 26], score_thresh=None),
        (16, 28), ["reference", "fused"]),
    "ssd512_vgg16": (
        dict(batch_size=16, lr=0.001, lr_steps=[18, 22], score_thresh=0.01),
        (14, 24), ["reference"]),
}
# run.sh's name of each family, in its default order
_FAMILY_NAMES = {"ssdlite320_mobilenet_v3_large": "ssdlite",
                 "pelee304": "pelee", "ssd_lite_mobilenet_v2": "sslv2",
                 "ssd300_vgg16": "vgg300", "ssd512_vgg16": "vgg512"}
_SHARED = dict(dataset="coco", data_path=".data/shapes", num_classes=91,
               warmup_iters=500, num_workers=2, print_freq=10, bf16=True,
               seed=0, device="cuda", momentum=0.9, weight_decay=1e-4)


def test_run_sh_runs_every_stage_in_order(run_sh_calls):
    models = [a.model for a in run_sh_calls["train"]]
    stages = {m: 2 + len(_RECIPES[m][2]) for m in _FAMILY_NAMES}
    assert models == [m for m, n in stages.items() for _ in range(n)]
    lines = run_sh_calls["stdout"].splitlines()
    assert lines[-1] == "ALL DONE"
    assert [line.split(" rc=")[0] for line in lines[:-1]] == [
        f"{_FAMILY_NAMES[m]} {s}" for m in _FAMILY_NAMES
        for s in ("stage1", "stage2", "testonly", "testonly_fused")[
            :stages[m]]]
    logs = run_sh_calls["work"] / "docs" / "trainrun_torch_r1"
    for model, name in _FAMILY_NAMES.items():
        assert (logs / f"{name}_stages.log").read_text().count(
            " rc=0 ") == stages[model]


@pytest.mark.parametrize("model", sorted(_RECIPES))
def test_run_sh_carries_the_family_recipe(run_sh_calls, model):
    recipe, (e1, e2), modes = _RECIPES[model]
    stages = [a for a in run_sh_calls["train"] if a.model == model]
    fresh, resumed, *tests = stages
    for args in stages:
        for key, value in {**_SHARED, **recipe}.items():
            assert getattr(args, key) == value, (model, key)
        assert args.output_dir == stages[0].output_dir
        assert not (args.remat or args.lane_pack or args.u8_transfer)
    assert (fresh.epochs, fresh.resume, fresh.test_only) == (e1, "", False)
    assert (resumed.epochs, resumed.test_only) == (e2, False)
    assert [t.test_only for t in tests] == [True] * len(modes)
    assert [t.postprocess for t in tests] == modes


@pytest.mark.parametrize("model", sorted(_RECIPES))
def test_run_sh_resumes_the_last_checkpoint(run_sh_calls, model):
    fresh, resumed, *tests = [a for a in run_sh_calls["train"]
                              if a.model == model]
    out = fresh.output_dir
    assert resumed.resume == f"{out}/checkpoint_{fresh.epochs - 1}"
    for t in tests:
        assert t.resume == f"{out}/checkpoint_{resumed.epochs - 1}"


@pytest.mark.parametrize("model", sorted(_RECIPES))
def test_run_sh_leaves_only_the_last_checkpoint(run_sh_calls, model):
    fresh, resumed, *_ = [a for a in run_sh_calls["train"]
                          if a.model == model]
    out = run_sh_calls["work"] / fresh.output_dir
    assert sorted(p.name for p in out.iterdir()) == [
        f"checkpoint_{resumed.epochs - 1}",
        f"checkpoint_{resumed.epochs - 1}.meta.json"]


def test_run_sh_appends_one_card_line_a_call(run_sh_calls):
    card = run_sh_calls["work"] / "docs" / "trainrun_torch_r1" / "card.log"
    assert card.read_text().splitlines() == [
        " ".join(_FAMILY_NAMES.values()) + ": stand-in, 0 W"]


def test_committed_logs_pass_the_gates(capsys):
    path = os.path.join(_REPO, "docs", "trainrun_torch_r1", "summarize.py")
    spec = importlib.util.spec_from_file_location("trainrun_summary", path)
    summary = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summary)
    assert summary.main([]) == 0
    result = json.loads(capsys.readouterr().out)
    assert sorted(k for k in result if k != "card") == sorted(
        _FAMILY_NAMES.values())
    for name in _FAMILY_NAMES.values():
        fam = result[name]
        assert all(fam["gates"].values()), (name, fam["gates"])
        jax_map = fam["jax_reference"]["test_only"][0]
        assert fam["final"]["map"] >= jax_map - 0.05, name
    for name in ("ssdlite", "vgg300"):
        assert result[name]["test_only"]["testonly_fused"][
            "equals_stage2_last"]
