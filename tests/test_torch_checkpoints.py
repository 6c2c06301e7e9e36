"""The port's checkpoints: save, resume and latest_checkpoint round trips in
tmp_path, with the JAX package's layout (checkpoint_<epoch>/ beside
checkpoint_<epoch>.meta.json). A resumed state's next step is bit-equal to
the next step of the state that went on (the CPU is deterministic)."""

import json
import os

import numpy as np
import pytest
import torch

from demonet_tpu.utils.checkpoints import (
    load_npz_variables as jax_load_npz_variables,
)
from demonet_tpu_torch.engine.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from demonet_tpu_torch.engine.train import make_train_step
from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
from demonet_tpu_torch.utils import checkpoints
from demonet_tpu_torch.utils.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    load_npz_variables,
    load_variables,
    save_checkpoint,
)
from demonet_tpu_torch.utils.freeze import (
    masked_optimizer,
    mobilenet_trainable_mask,
)

_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets", "ssdlite320_shapes_trained.npz")


def _detector(seed=0):
    return ssdlite320_mobilenet_v3_large(num_classes=4, size=(64, 64),
                                         device="cpu", seed=seed)


def _batch(seed):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 30, (2, 2, 2))
    boxes = np.concatenate([xy, xy + rng.integers(8, 30, (2, 2, 2))], -1)
    return {"images": torch.from_numpy(rng.random((2, 64, 64, 3)).astype(
                np.float32)),
            "gt_boxes": torch.from_numpy(boxes.astype(np.float32)),
            "gt_labels": torch.tensor([[1, 2], [3, 0]]),
            "gt_valid": torch.tensor([[True, True], [True, False]])}


def _recipe(mask=None):
    tx = make_optimizer(make_lr_schedule(0.05, 4, (1,)), 0.9, 1e-4)
    return tx if mask is None else masked_optimizer(tx, mask)


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "masked"])
def test_resume_continues_bit_equal(tmp_path, frozen):
    det = _detector()
    mask = mobilenet_trainable_mask(det.model, 2) if frozen else None
    state = create_train_state(det, _recipe(mask))
    step = make_train_step(det)
    for s in range(3):
        state, _ = step(state, _batch(s))
    path = save_checkpoint(str(tmp_path), state, epoch=2,
                           metadata={"note": "three steps"})
    assert path == os.path.join(str(tmp_path), "checkpoint_2")
    assert os.path.isdir(path) and os.path.exists(path + ".meta.json")

    fresh = _detector(seed=1)
    resumed, epoch, meta = load_checkpoint(
        path, create_train_state(fresh, _recipe(mask)))
    assert (epoch, meta, resumed.step) == (2, {"note": "three steps"}, 3)
    state, m_cont = step(state, _batch(3))
    resumed, m_res = make_train_step(fresh)(resumed, _batch(3))
    assert resumed.step == state.step == 4
    for key in m_cont:
        assert torch.equal(m_cont[key], m_res[key]), key
    for (name, a), b in zip(det.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert state.optimizer.param_groups[0]["lr"] == \
        resumed.optimizer.param_groups[0]["lr"]


def test_latest_checkpoint_picks_highest_epoch(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    det = _detector()
    state = create_train_state(det, _recipe())
    for epoch in (0, 10, 2):
        save_checkpoint(str(tmp_path), state, epoch)
    (tmp_path / "checkpoint_notanumber").mkdir()
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_10")
    with open(tmp_path / "checkpoint_10.meta.json") as f:
        assert json.load(f) == {"epoch": 10, "metadata": {}}


def test_load_variables_ignores_the_optimizer(tmp_path):
    """Inference weights from a checkpoint of any optimizer recipe (here a
    masked one with momentum) load into a plain model, by a relative path
    too."""
    det = _detector()
    mask = mobilenet_trainable_mask(det.model, 0)
    state = create_train_state(det, _recipe(mask))
    state, _ = make_train_step(det)(state, _batch(0))
    save_checkpoint(str(tmp_path), state, epoch=0)
    rel = os.path.relpath(str(tmp_path / "checkpoint_0"))
    weights = load_variables(rel)
    other = _detector(seed=3)
    other.model.load_state_dict(weights)
    for (name, a), b in zip(det.model.state_dict().items(),
                            other.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert all(v.device.type == "cpu" for v in weights.values())


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoints, "is_main_process", lambda: False)
    state = create_train_state(_detector(), _recipe())
    path = save_checkpoint(str(tmp_path), state, epoch=1)
    assert path == os.path.join(str(tmp_path), "checkpoint_1")
    assert os.listdir(tmp_path) == []


def test_load_npz_variables_equals_jax_package():
    want = jax_load_npz_variables(_NPZ)
    got = load_npz_variables(_NPZ)

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])

    walk(want, got)
    assert set(got) == {"params", "batch_stats"}
