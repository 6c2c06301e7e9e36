"""Shared pieces of the port's parity tests for the detector families and
the classifiers (tests/test_torch_vgg.py, _mobilenetv2.py, _pelee.py,
_classifiers.py): numpy draws for an abstract JAX variable tree, the JAX
tree as the port's state_dict, head-output and detection comparisons, a
seeded training batch, and the JAX train step as the reference.

Build a JAX reference with `jax.eval_shape(det.init)` and numpy draws,
and jit what runs: eager flax init and apply are many times slower.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demonet_tpu.engine.state import TrainState as JaxTrainState
from demonet_tpu.engine.state import make_optimizer as jax_optimizer
from demonet_tpu.engine.train import make_train_step as jax_train_step
from demonet_tpu.models import detection as jax_det
from demonet_tpu_torch.models import detection as port_det
from demonet_tpu_torch.utils.weights import torch_name

# SGD of the train-step tests
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4


def draw_variables(shapes, rng):
    """Numpy values for every leaf of an abstract JAX variable tree, near
    the JAX package's initializers so activations stay moderate through
    deep trunks: conv kernels normal with variance 2 / fan_out (the
    MobileNets' init) in extractors and 1 / fan_in in heads, Dense
    kernels lecun-normal; BN scale and var in [0.5, 1.5], biases and means
    N(0, 0.1); VGG's L2 rescale in [10, 30]."""
    def fill(tree, path):
        out = {}
        for k, leaf in tree.items():
            if not hasattr(leaf, "shape"):
                out[k] = fill(leaf, path + (k,))
                continue
            s = leaf.shape
            if k in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, s)
            elif k == "scale_weight":
                v = rng.uniform(10.0, 30.0, s)
            elif k in ("mean", "bias"):
                v = rng.normal(0.0, 0.1, s)
            elif len(s) == 4 and "head" in path:
                v = rng.normal(0.0, np.sqrt(1.0 / np.prod(s[:3])), s)
            elif len(s) == 4:
                v = rng.normal(0.0, np.sqrt(2.0 / (s[0] * s[1] * s[3])), s)
            else:
                v = rng.normal(0.0, np.sqrt(1.0 / s[0]), s)
            out[k] = v.astype(np.float32)
        return out
    return {c: fill(shapes[c], (c,)) for c in shapes}


def jax_variables(init, rng_seed=0, *args):
    """numpy variables for `init`'s abstract tree (jax.eval_shape)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return draw_variables(shapes, np.random.default_rng(rng_seed))


def jax_state(tree):
    """A JAX variable tree as the port's state_dict entries, float64:
    conv kernels (H, W, I, O) moved to (O, I, H, W), Dense kernels
    (in, out) to (out, in)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        arr = np.array(leaf, np.float64)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        out[torch_name("/".join(k.key for k in path))] = torch.from_numpy(arr)
    return out


def assert_state_close(model, want, atol, rtol):
    """Every parameter and BN statistic of `model` against `want` (a
    jax_state)."""
    got = {n: v for n, v in model.state_dict().items()
           if not n.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for name, value in got.items():
        torch.testing.assert_close(value.double(), want[name], atol=atol,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


def assert_close_to_scale(got, want, rtol, what=""):
    """max |got - want| within rtol of max |want|: fp32 convs summed in
    another order, judged against the size of the outputs."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert scale > 0 and err <= rtol * scale, (what, err, scale)


def images(seed, size, b=1):
    return np.random.default_rng(seed).random((b, *size, 3)).astype(
        np.float32)


def head_logits(seed, a, c, b=2, regime="dense"):
    """Seeded head outputs (B, A, C) logits and (B, A, 4) deltas: 'dense'
    N(0, 1) logits (every class live above 0.01 at C <= 50); 'sparse' a
    background that wins nearly everywhere and 24 peaked (anchor, class)
    entries per image, the trained-model regime the fused path serves."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.0, (b, a, c)).astype(np.float32)
    if regime == "sparse":
        logits[..., 0] += 12.0
        for i in range(b):
            hot = rng.integers(0, a, 24)
            logits[i, hot, rng.integers(1, c, 24)] += 14.0
    deltas = rng.normal(0.0, 0.5, (b, a, 4)).astype(np.float32)
    return logits, deltas


def assert_predict_matches_jax(jd, pd, logits, deltas, sizes, impl,
                               topk_impl="exact"):
    """The port's padded detections against the JAX package's, given the
    same softmaxed scores and decoded, clipped boxes (the JAX package's,
    so the two frameworks' last-ulp differences in softmax and exp cannot
    swap near-tied ranks), in one serving mode: impl "reference" with
    topk_impl, or "fused". Every output bit-equal. The port runs its
    kernels' plain versions (CPU tensors); the JAX package its XLA NMS
    and gathers. Returns the JAX detections and the port's fused branch
    (None off the fused path)."""
    from demonet_tpu.ops.boxes import clip_boxes_to_image, decode_boxes

    cfg = jd.config

    @jax.jit
    def scores_boxes(lg, dl, an):
        boxes = decode_boxes(dl, an[None], cfg.box_coder_weights)
        return (jax.nn.softmax(lg, axis=-1),
                clip_boxes_to_image(boxes, cfg.size))

    scores, boxes = (np.array(t) for t in scores_boxes(
        logits, deltas, jnp.asarray(jd.anchors)))
    if impl == "fused":
        core = functools.partial(jax_det._postprocess_fused, config=cfg,
                                 nms_impl="xla", gather_impl="xla")
    else:
        core = functools.partial(jax_det._postprocess_reference_core,
                                 config=cfg, nms_impl="xla",
                                 topk_impl=topk_impl, gather_impl="xla")
    want = jax.jit(core)(scores, boxes, original_sizes=jnp.asarray(sizes))
    want = {k: np.asarray(v) for k, v in want.items()}
    args = (torch.from_numpy(scores), torch.from_numpy(boxes), pd.config,
            torch.from_numpy(sizes))
    branches = port_det._postprocess_fused.branches
    before = dict(branches)
    if impl == "fused":
        got = port_det._postprocess_fused(*args, "auto", "auto")
    else:
        got = port_det._postprocess_reference_core(*args, "auto", topk_impl,
                                                   "auto")
    taken = [k for k in branches if branches[k] != before.get(k, 0)]
    for key in ("boxes", "scores", "labels", "valid"):
        g = got[key].numpy()
        assert g.dtype == want[key].dtype, key
        np.testing.assert_array_equal(g, want[key], err_msg=key)
    return want, (taken[0] if taken else None)


def train_batch(seed, size, classes, b=1, g=3):
    """Frames with filled rectangles and their boxes as ground truth
    (labels 1 .. classes - 1), some rows padded."""
    rng = np.random.default_rng(seed)
    h, w = size
    images_ = (rng.random((b, h, w, 3)) * 0.2).astype(np.float32)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(1 + i % g):
            bw, bh = rng.integers(w // 6, w // 2), rng.integers(h // 6, h // 2)
            x0, y0 = rng.integers(0, w - bw), rng.integers(0, h - bh)
            images_[i, y0:y0 + bh, x0:x0 + bw] = rng.random(3)
            boxes[i, j] = [x0, y0, x0 + bw, y0 + bh]
            labels[i, j] = rng.integers(1, classes)
            valid[i, j] = True
    return {"images": images_, "gt_boxes": boxes, "gt_labels": labels,
            "gt_valid": valid}


def jax_steps(jd, variables, batch, steps, dtype, lr=LR):
    """The JAX package's jitted train step, `steps` times from
    `variables` on `batch`, in `dtype` (the model must be built in it):
    each step's metrics and the variables after the last. The variables
    and images are in `dtype` or float32, whichever is wider: a bfloat16
    model keeps float32 parameters and takes float32 images, as the JAX
    CLI's `--bf16` does."""
    wide = jnp.promote_types(dtype, jnp.float32)
    cast = lambda a: a.astype(wide)  # noqa: E731
    v = jax.tree_util.tree_map(cast, variables)
    state = JaxTrainState.create(
        apply_fn=jd.model.apply, params=v["params"],
        batch_stats=v.get("batch_stats", {}),
        tx=jax_optimizer(lr, MOMENTUM, WD))
    step = jax_train_step(jd, donate=False)
    b = dict(batch, images=batch["images"].astype(wide))
    metrics = []
    for _ in range(steps):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    after = {"params": state.params}
    if state.batch_stats:
        after["batch_stats"] = state.batch_stats
    return metrics, jax.device_get(after)


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's convs on the CPU: beside the
    other test workers, a thread per core in every worker makes them run
    many times slower than alone (ssd_lite_mobilenet_v2's float64
    train-step test at 64x64 took 748 s in a tier-1 run of six workers,
    under 20 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
