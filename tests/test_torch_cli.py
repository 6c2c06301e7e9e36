"""Port vs JAX package: the train CLI (`python -m demonet_tpu_torch.train`)
and the model registry.

The port's parser keeps every flag and default of the JAX CLI and adds
`--device` (default `cuda`). `--dataset synthetic` trains an epoch on the
CPU (`--device cpu`), writes a checkpoint, and `--test-only --resume`
evaluates it to the same COCO summary, with the loader's worker pool and
with the fused postprocess too; so does ssd_lite_mobilenet_v2, at its own
320x320, and so do `--bf16` and `--remat` (the checkpoint resuming across
`--bf16` either way). A classifier's name raises before training. The datasets and
evaluators the CLI builds equal the JAX CLI's. The registry builds all
nine of the JAX package's names. No JAX model is built.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from demonet_tpu import train as jax_train
from demonet_tpu_torch import train as port_train
from demonet_tpu_torch.models import builders

_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets", "ssdlite320_shapes_trained.npz")
_JAX_MODELS = ("ssdlite320_mobilenet_v3_large", "ssd300_vgg16", "ssd512_vgg16",
               "ssd_lite_mobilenet_v2", "pelee304", "mobilenet_v2",
               "mobilenet_v3_large", "mobilenet_v3_small", "peleenet_v1")


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_keeps_every_jax_flag_and_default():
    want, got = (_actions(m.get_args_parser())
                 for m in (jax_train, port_train))
    assert sorted(got) == sorted([*want, "device"])
    for dest, a in want.items():
        g = got[dest]
        assert (g.option_strings, g.default, g.type, g.choices, g.nargs) == (
            a.option_strings, a.default, a.type, a.choices, a.nargs), dest
    args = port_train.get_args_parser().parse_args([])
    assert args.device == "cuda"


@pytest.mark.parametrize("flag", ["--lane-pack", "--stem-s2d"])
def test_layout_flags_reach_get_model(flag, tmp_path, monkeypatch):
    """The twin of tests/test_cli.py's lane-pack wiring test: the flag
    reaches get_model, and a --test-only run with --postprocess fused
    evaluates the layout's model (at 64x64) end to end."""
    seen, get = [], builders.get_model

    def small(name, **kw):
        seen.append(kw)
        return get(name, **dict(kw, size=(64, 64)))

    monkeypatch.setattr(builders, "get_model", small)
    args = port_train.get_args_parser().parse_args([
        "--dataset", "synthetic", "--synthetic-size", "8", "--num-classes",
        "5", "--batch-size", "8", "--test-only", flag, "--postprocess",
        "fused", "--output-dir", str(tmp_path), "--device", "cpu"])
    ev = port_train.main(args)
    key = flag[2:].replace("-", "_")
    assert [kw.get(key) for kw in seen] == [True]
    assert np.isfinite(ev.stats).all()


def test_cuda_default_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_train.get_args_parser().parse_args(["--dataset", "synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(args)


def test_registry_holds_the_jax_names(monkeypatch):
    """Every name builds, on the CPU when asked; on `cuda` by default, so
    with no GPU each raises; builders.py raises NotImplementedError
    nowhere."""
    import inspect

    assert sorted(builders.MODEL_REGISTRY) == sorted(_JAX_MODELS)
    assert set(builders.DETECTORS) == set(_JAX_MODELS[:5])
    for name in _JAX_MODELS:
        model = builders.get_model(name, num_classes=5, device="cpu")
        if name in builders.DETECTORS:
            assert model.config.num_classes == 5
            assert model.device == torch.device("cpu")
            assert not model.model.training
        else:
            assert model.classifier.out_features == 5
            assert not model.training
    assert "NotImplementedError" not in inspect.getsource(builders)
    with pytest.raises(ValueError, match="Unknown model"):
        builders.get_model("resnet50")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in _JAX_MODELS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            builders.get_model(name, num_classes=5)


@pytest.mark.parametrize("policy", ["hflip", "ssd"])
def test_datasets_and_evaluator_equal_jax(policy):
    argv = ["--dataset", "synthetic", "--synthetic-size", "4", "--seed", "3",
            "--data-augmentation", policy]
    a_w = jax_train.get_args_parser().parse_args(argv)
    a_g = port_train.get_args_parser().parse_args(argv)
    tr_w, val_w, n_w = jax_train.build_datasets(a_w)
    tr_g, val_g, n_g = port_train.build_datasets(a_g)
    assert n_g == n_w == 7 and len(tr_g) == len(tr_w) == 4
    for ds_g, ds_w in ((tr_g, tr_w), (val_g, val_w)):
        for i in range(4):
            (img_g, t_g) = ds_g.__getitem__(i, rng=np.random.default_rng(i))
            (img_w, t_w) = ds_w.__getitem__(i, rng=np.random.default_rng(i))
            np.testing.assert_array_equal(img_g, img_w)
            for k in t_w:
                np.testing.assert_array_equal(t_g[k], t_w[k])
    ev_g = port_train.make_evaluator(a_g, val_g)
    ev_w = jax_train.make_evaluator(a_w, val_w)
    assert type(ev_g).__name__ == type(ev_w).__name__ == "CocoEvaluator"
    assert ev_g.category_ids == ev_w.category_ids
    assert sorted(ev_g.gts) == sorted(ev_w.gts) == list(range(4))
    for i, g in ev_w.gts.items():
        for k in g:
            np.testing.assert_array_equal(ev_g.gts[i][k], g[k])


@pytest.fixture
def one_thread():
    """One intra-op thread for the full-width model on the CPU: beside the
    other test workers, a thread per core in every worker makes it run
    many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(argv):
    args = port_train.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--synthetic-size", "4", "--batch-size",
         "2", "--num-classes", "91", "--device", "cpu", *argv])
    return port_train.main(args)


def test_cli_synthetic_train_checkpoint_and_resume_agree(tmp_path,
                                                         one_thread):
    out = str(tmp_path)
    trained = _run(["--epochs", "1", "--npz-weights", _NPZ,
                    "--output-dir", out, "--print-freq", "1"])
    ckpt = os.path.join(out, "checkpoint_0")
    assert os.path.exists(os.path.join(ckpt, "state.pt"))
    assert os.path.exists(ckpt + ".meta.json")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [line for line in f if line.strip()]
    assert len(steps) == 2                   # 4 frames at batch 2
    assert np.isfinite(trained.stats).all() and trained.stats[1] > 0
    for extra in ([], ["-j", "2"], ["--postprocess", "fused"]):
        resumed = _run(["--test-only", "--resume", ckpt, *extra])
        np.testing.assert_array_equal(resumed.stats, trained.stats)


def test_cli_trains_ssd_lite_mobilenet_v2_and_resumes(tmp_path, one_thread):
    """Another family through the CLI at its own size (320x320, no resize):
    2 steps, a checkpoint, an evaluation, and --test-only --resume to the
    same summary."""
    out = str(tmp_path)
    argv = ["--dataset", "synthetic", "--synthetic-size", "4",
            "--batch-size", "2", "--device", "cpu", "--model",
            "ssd_lite_mobilenet_v2", "--score-thresh", "0.05"]
    args = port_train.get_args_parser().parse_args(
        [*argv, "--epochs", "1", "--output-dir", out, "--print-freq", "1"])
    trained = port_train.main(args)
    ckpt = os.path.join(out, "checkpoint_0")
    assert os.path.exists(os.path.join(ckpt, "state.pt"))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len([line for line in f if line.strip()]) == 2
    assert np.isfinite(trained.stats).all()
    resumed = port_train.main(port_train.get_args_parser().parse_args(
        [*argv, "--test-only", "--resume", ckpt]))
    np.testing.assert_array_equal(resumed.stats, trained.stats)


@pytest.mark.parametrize("flags", [["--bf16"], ["--remat"],
                                   ["--bf16", "--remat"]],
                         ids=["bf16", "remat", "bf16_remat"])
def test_bf16_and_remat_flags_train_and_resume(tmp_path, one_thread,
                                               monkeypatch, flags):
    """--bf16 builds the model with bfloat16 compute and --remat reaches
    both train steps; each trains an epoch (steps_per_call 2 takes the
    remat too), checkpoints float32 tensors, and --test-only --resume with
    the same flags gives the same summary; the checkpoint resumes across
    --bf16 either way. A --remat run is bit-equal to the run without it."""
    from demonet_tpu_torch.engine import train as train_mod

    built, remats = [], []
    get_model, make_step = builders.get_model, train_mod.make_train_step

    def spy_model(name, **kw):
        built.append(kw["dtype"])
        return get_model(name, **kw)

    def spy_step(detector, **kw):
        remats.append(kw.get("remat", False))
        return make_step(detector, **kw)

    monkeypatch.setattr(builders, "get_model", spy_model)
    monkeypatch.setattr(train_mod, "make_train_step", spy_step)
    out = str(tmp_path / "run")
    trained = _run([*flags, "--epochs", "1", "--npz-weights", _NPZ,
                    "--output-dir", out, "--steps-per-call", "2"])
    bf16 = "--bf16" in flags
    assert built == [torch.bfloat16 if bf16 else torch.float32]
    assert remats == ["--remat" in flags] * 2
    assert np.isfinite(trained.stats).all() and trained.stats[1] > 0
    ckpt = os.path.join(out, "checkpoint_0")
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in saved["model"].values())
    resumed = _run(["--test-only", "--resume", ckpt, *flags])
    np.testing.assert_array_equal(resumed.stats, trained.stats)
    crossed = _run(["--test-only", "--resume", ckpt,
                    *([] if bf16 else ["--bf16"])])
    assert np.isfinite(crossed.stats).all()
    if flags == ["--remat"]:
        plain = _run(["--epochs", "1", "--npz-weights", _NPZ, "--output-dir",
                      str(tmp_path / "plain"), "--steps-per-call", "2"])
        np.testing.assert_array_equal(plain.stats, trained.stats)


@pytest.mark.parametrize("name", ["mobilenet_v2", "peleenet_v1"])
def test_cli_classifier_raises_before_training(tmp_path, name):
    args = port_train.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--device", "cpu", "--model", name,
         "--output-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="ssd300_vgg16"):
        port_train.main(args)
    assert not os.listdir(tmp_path)
