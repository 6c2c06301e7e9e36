"""Port vs JAX package: the whole train step of ssdlite320_mobilenet_v3_large
at 64x64 (4 classes, A = 144 anchors), from the same variables (drawn with
numpy, carried into the port by `load_jax_variables`) on the same batch,
two steps of SGD at lr 0.05, momentum 0.9, weight decay 1e-4.

The reference is the JAX package's jitted train step on its float64
model (the builder's dtype=float64, under jax.enable_x64). At this size
the BN layers see 2-16 values per channel, and the float32 JAX step's own
error (its batch statistics summed in float32) reaches 4e-3 in the
logits and 5 % in early gradients, against 8e-5 for the port's float32
step; so both frameworks are compared in float64, where their steps are
the same function, and the port's float32 step against that.

Both encode the regression targets in float32 (the JAX package does so
whatever the model's dtype), and float32 `log` differs by an ulp or two
between the frameworks, which moves the float64 comparison by ~1e-7.
Tolerances, with what was measured on this test's inputs:

  * port float64 vs JAX float64, after each of 2 steps: loss terms rtol
    5e-7 (measured 1.2e-7); every parameter and BN running mean and
    variance atol 1e-5 + rtol 1e-5 (largest difference 3.7e-6);
  * port float32 vs JAX float64: loss terms rtol 1e-4 (4.1e-5 at step
    2); parameters and BN statistics after 2 steps atol 2e-3 + rtol 2e-3
    (largest difference 7.1e-4);
  * the matching of step 1, and the hard-negative mask on the same
    logits: bit-equal.

The port's own properties are checked bit for bit on the CPU: K steps in
one call equal K single steps, predict after training equals a fresh
model in eval mode, frozen parameters do not move.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.engine.state import TrainState as JaxTrainState
from demonet_tpu.engine.state import make_optimizer as jax_optimizer
from demonet_tpu.engine.train import make_train_step as jax_train_step
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu_torch.engine.evaluate import make_predict_step
from demonet_tpu_torch.engine.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
from demonet_tpu_torch.engine.train import make_train_step, train_one_epoch
from demonet_tpu_torch.models.builders import (
    ssdlite320_mobilenet_v3_large as port_ssdlite,
)
from demonet_tpu_torch.models.losses import classification_terms, match_batch
from demonet_tpu_torch.utils.freeze import (
    masked_optimizer,
    mobilenet_trainable_mask,
)
from demonet_tpu_torch.utils.weights import load_jax_variables, torch_name

_SIZE = (64, 64)
_CLASSES = 4
_LR, _MOMENTUM, _WD = 0.05, 0.9, 1e-4
_RTOL_LOSS_64, _ATOL_64, _RTOL_64 = 5e-7, 1e-5, 1e-5
_RTOL_LOSS_32, _ATOL_32, _RTOL_32 = 1e-4, 2e-3, 2e-3


def _draw_variables(shapes, rng):
    """Numpy values for the abstract JAX variable tree: He fan-out in the
    trunk, lecun in the SE convs, normal(0, 0.03) in the extras and head;
    BN scale and var in [0.5, 1.5], biases and means N(0, 0.1)."""
    def fill(tree, path):
        out = {}
        for k, leaf in tree.items():
            if not hasattr(leaf, "shape"):
                out[k] = fill(leaf, path + (k,))
                continue
            s = leaf.shape
            if k in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, s)
            elif k in ("mean", "bias"):
                v = rng.normal(0.0, 0.1, s)
            elif "se" in path:
                v = rng.normal(0.0, np.sqrt(1.0 / np.prod(s[:-1])), s)
            elif "trunk" in path:
                v = rng.normal(0.0, np.sqrt(2.0 / (s[-1] * s[0] * s[1])), s)
            else:
                v = rng.normal(0.0, 0.03, s)
            out[k] = v.astype(np.float32)
        return out
    return {c: fill(shapes[c], (c,)) for c in shapes}


def _batch(seed, b=2, g=3):
    """Frames with filled rectangles and their boxes as gt (labels 1-3),
    some rows padded."""
    rng = np.random.default_rng(seed)
    images = (rng.random((b, *_SIZE, 3)) * 0.2).astype(np.float32)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(1 + i % g):
            x0, y0 = rng.integers(0, 36, 2)
            w, h = rng.integers(10, 28, 2)
            x1, y1 = min(x0 + w, 64), min(y0 + h, 64)
            images[i, y0:y1, x0:x1] = rng.random(3)
            boxes[i, j] = [x0, y0, x1, y1]
            labels[i, j] = rng.integers(1, _CLASSES)
            valid[i, j] = True
    return {"images": images, "gt_boxes": boxes, "gt_labels": labels,
            "gt_valid": valid}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX detector in float64, its variables (float32 values) and two
    steps of its jitted train step on one batch: each step's metrics and
    the variables after steps 1 and 2."""
    with jax.enable_x64(True):
        jd = jax_ssdlite(num_classes=_CLASSES, size=_SIZE, dtype=jnp.float64)
        shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
        variables = _draw_variables(shapes, np.random.default_rng(0))
        v64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                     variables)
        state = JaxTrainState.create(
            apply_fn=jd.model.apply, params=v64["params"],
            batch_stats=v64["batch_stats"],
            tx=jax_optimizer(_LR, _MOMENTUM, _WD))
        step = jax_train_step(jd, donate=False)
        batch = _batch(1)
        b64 = dict(batch, images=batch["images"].astype(np.float64))
        metrics, after = [], []
        for _ in range(2):
            state, m = step(state, b64)
            metrics.append({k: float(v) for k, v in m.items()})
            after.append(jax.device_get({"params": state.params,
                                         "batch_stats": state.batch_stats}))
    return {"variables": variables, "batch": batch, "metrics": metrics,
            "after": after, "anchors": np.asarray(jd.anchors)}


def _port(variables, device="cpu"):
    pd = port_ssdlite(num_classes=_CLASSES, size=_SIZE, device=device)
    load_jax_variables(pd.model, variables)
    return pd


def _sgd():
    return make_optimizer(_LR, _MOMENTUM, _WD)


def _jax_state(tree):
    """The JAX variable tree as the port's state_dict entries, float64,
    conv kernels (H, W, I, O) moved to (O, I, H, W)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        arr = np.array(leaf, np.float64)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[torch_name("/".join(k.key for k in path))] = torch.from_numpy(arr)
    return out


def _assert_state_close(model, want, atol, rtol):
    got = {n: v for n, v in model.state_dict().items()
           if not n.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for name, value in got.items():
        torch.testing.assert_close(value.double(), want[name], atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_train_steps_match_jax(ref, dtype):
    pd = _port(ref["variables"])
    rtol_loss, atol, rtol = ((_RTOL_LOSS_64, _ATOL_64, _RTOL_64)
                             if dtype == "float64" else
                             (_RTOL_LOSS_32, _ATOL_32, _RTOL_32))
    batch = _torch_batch(ref["batch"])
    if dtype == "float64":
        pd.model.double()
        batch["images"] = batch["images"].double()
    state = create_train_state(pd, _sgd())
    step = make_train_step(pd)
    for want, after in zip(ref["metrics"], ref["after"]):
        state, m = step(state, batch)
        for key in ("bbox_regression", "classification", "loss"):
            np.testing.assert_allclose(float(m[key]), want[key],
                                       rtol=rtol_loss, err_msg=key)
        if dtype == "float64":
            _assert_state_close(pd.model, _jax_state(after), atol, rtol)
    _assert_state_close(pd.model, _jax_state(ref["after"][1]), atol, rtol)
    assert state.step == 2 and pd.model.training
    # the steps moved every parameter and BN statistic
    start = _jax_state(ref["variables"])
    assert not any(torch.equal(v.double(), start[n])
                   for n, v in pd.model.state_dict().items() if n in start)


def test_step_one_matching_and_masks_equal_jax(ref):
    """The port's matching of the batch, and its mining on the port's
    train-mode logits, equal the JAX package's on the same inputs."""
    from demonet_tpu.models import losses as jax_losses

    b = ref["batch"]
    matched_j = np.asarray(jax.jit(jax_losses.match_batch)(
        ref["anchors"], b["gt_boxes"], b["gt_valid"]))
    matched = match_batch(torch.from_numpy(ref["anchors"]),
                          torch.from_numpy(b["gt_boxes"]),
                          torch.from_numpy(b["gt_valid"]))
    np.testing.assert_array_equal(matched.numpy(), matched_j)
    assert (matched_j >= 0).sum() >= 3
    pd = _port(ref["variables"])
    with torch.no_grad():
        logits = pd.model.train()(
            (torch.from_numpy(b["images"]) - 0.5) / 0.5)["cls_logits"]
    _, fg, bg = classification_terms(logits, matched,
                                     torch.from_numpy(b["gt_labels"]))

    @jax.jit
    def jax_mined(cls, idx, labels):
        # demonet_tpu/models/losses.py:79-118 on the same logits
        fg_j = idx >= 0
        tgt = jnp.where(fg_j, jnp.take_along_axis(
            labels, jnp.clip(idx, 0, labels.shape[1] - 1), 1), 0)
        ce = jax.nn.logsumexp(cls, -1) - jnp.take_along_axis(
            cls, tgt[..., None], -1)[..., 0]
        neg = jnp.where(fg_j, -jnp.inf, ce)
        rank = jnp.argsort(jnp.argsort(-neg, axis=1), axis=1)
        return rank < (3.0 * jnp.sum(fg_j, axis=1))[:, None]

    want = np.asarray(jax_mined(logits.numpy(), matched_j, b["gt_labels"]))
    np.testing.assert_array_equal(bg.numpy(), want)
    assert int(bg.sum()) == 3 * int(fg.sum())


def test_detector_loss_equals_step_metrics(ref):
    pd = _port(ref["variables"])
    b = _torch_batch(ref["batch"])
    terms, stats = pd.loss((b["images"] - 0.5) / 0.5, b["gt_boxes"],
                           b["gt_labels"], b["gt_valid"])
    want = ref["metrics"][0]
    for key in ("bbox_regression", "classification"):
        np.testing.assert_allclose(float(terms[key].detach()), want[key],
                                   rtol=_RTOL_LOSS_32, err_msg=key)
    assert pd.model.training
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                 for m in pd.model.modules())
    start = _jax_state(ref["variables"])
    assert not any(torch.equal(v.double(), start[n]) for n, v in stats.items())


def test_steps_per_call_equals_single_steps(ref):
    batches = [_torch_batch(_batch(s)) for s in (2, 3)]
    single = _port(ref["variables"])
    s_state, s_step = create_train_state(single, _sgd()), make_train_step(
        single)
    rows = []
    for b in batches:
        s_state, m = s_step(s_state, b)
        rows.append(m)
    multi = _port(ref["variables"])
    m_state = create_train_state(multi, _sgd())
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    m_state, m = make_train_step(multi, steps_per_call=2)(m_state, stacked)
    assert m_state.step == s_state.step == 2
    for key in rows[0]:
        assert m[key].shape == (2,)
        assert torch.equal(m[key], torch.stack([r[key] for r in rows])), key
    for (name, a), b in zip(single.model.state_dict().items(),
                            multi.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_predict_after_train_step_equals_eval_model(ref):
    """A train step leaves the module in train mode; predict must run it
    in eval mode anyway (the JAX predict passes train=False)."""
    pd = _port(ref["variables"])
    state = create_train_state(pd, _sgd())
    state, _ = make_train_step(pd)(state, _torch_batch(ref["batch"]))
    assert pd.model.training
    fresh = port_ssdlite(num_classes=_CLASSES, size=_SIZE, device="cpu")
    fresh.model.load_state_dict(pd.model.state_dict())
    images = torch.from_numpy(
        (np.random.default_rng(9).random((2, *_SIZE, 3)) * 255).astype(
            np.uint8))
    want = make_predict_step(fresh)(fresh.model.eval(), images)
    for got in (make_predict_step(pd)(pd.model, images),
                pd.predict(images)):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert not pd.model.training


@pytest.mark.parametrize("layers", [0, 3])
def test_frozen_parameters_do_not_move(ref, layers):
    pd = _port(ref["variables"])
    mask = mobilenet_trainable_mask(pd.model, layers)
    state = create_train_state(pd, masked_optimizer(_sgd(), mask))
    before = {n: v.clone() for n, v in pd.model.state_dict().items()}
    state, _ = make_train_step(pd)(state, _torch_batch(ref["batch"]))
    after = pd.model.state_dict()
    params = dict(pd.model.named_parameters())
    assert any(not v for v in mask.values())
    for name, trainable in mask.items():
        assert torch.equal(params[name], before[name]) != trainable, name
    # BN statistics update in frozen layers too
    frozen_bn = [n for n in after if "trunk.stem.bn.running" in n]
    assert frozen_bn and all(not torch.equal(after[n], before[n])
                             for n in frozen_bn)
    assert sum(len(g["params"]) for g in state.optimizer.param_groups) == sum(
        mask.values())


def test_train_one_epoch_steps_and_tail(ref, tmp_path, capsys):
    """Five batches with steps_per_call 2: two windows of 2 and a single
    step of tail; the same metrics and weights as five single steps."""
    from demonet_tpu_torch.utils.metrics_writer import MetricsWriter

    batches = [_torch_batch(_batch(s)) for s in range(5)]
    single = _port(ref["variables"])
    s_state = create_train_state(single, _sgd())
    step = make_train_step(single)
    want = []
    for b in batches:
        s_state, m = step(s_state, b)
        want.append(float(m["loss"]))

    pd = _port(ref["variables"])
    state = create_train_state(pd, _sgd())
    writer = MetricsWriter(str(tmp_path))
    schedule = make_lr_schedule(_LR, 5)
    state = train_one_epoch(
        make_train_step(pd), state, batches, 0, print_freq=2,
        lr_schedule=schedule, metrics_writer=writer,
        multi_step=make_train_step(pd, steps_per_call=2), steps_per_call=2)
    assert state.step == 5
    import json
    rows = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert [r["train/loss"] for r in rows] == want
    assert [r["train/lr"] for r in rows] == [schedule(s) for s in range(1, 6)]
    out = capsys.readouterr().out
    assert "Epoch: [0]" in out and "Total time" in out
    for (name, a), b in zip(single.model.state_dict().items(),
                            pd.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_one_epoch_stops_on_non_finite_loss(ref, capsys):
    pd = _port(ref["variables"])
    state = create_train_state(pd, _sgd())
    good = _torch_batch(ref["batch"])
    bad = dict(good, images=torch.full_like(good["images"], float("nan")))
    with pytest.raises(SystemExit) as exc:
        train_one_epoch(make_train_step(pd), state, [good, bad, good], 0,
                        print_freq=10)
    assert exc.value.code == 1
    assert "Loss is nan, stopping training" in capsys.readouterr().out


def test_unported_options_raise(ref):
    pd = _port(ref["variables"])
    with pytest.raises(NotImplementedError, match="remat"):
        make_train_step(pd, remat=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        make_train_step(pd, mesh=object())
    state = create_train_state(pd, _sgd())
    with pytest.raises(NotImplementedError, match="mesh"):
        train_one_epoch(make_train_step(pd), state, [], 0, mesh=object())
    make_train_step(pd, donate=False)       # accepted, and means nothing


def test_uint8_images_normalized_in_step(ref):
    """uint8 frames are scaled on the device: the same step as their float
    version."""
    b = _batch(4)
    u8 = (b["images"] * 255).round().astype(np.uint8)
    runs = []
    for images in (torch.from_numpy(u8),
                   torch.from_numpy(u8).float() * np.float32(1 / 255)):
        pd = _port(ref["variables"])
        state = create_train_state(pd, _sgd())
        _, m = make_train_step(pd)(state, dict(_torch_batch(b),
                                               images=images))
        runs.append(m)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
