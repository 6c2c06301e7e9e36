"""Ranks of the port's data-parallel tests (tests/test_torch_dist_*.py),
not a test file.

`spawn(target, world, tmp_path, *args)` starts `world` processes with the
spawn method; each joins a gloo group over a FileStore under `tmp_path`
(no TCP port for parallel test workers to race for), with a 60 s timeout
on every collective, pins one intra-op thread, runs `target(rank, world,
*args)` and saves what it returns. The parent joins each child within
180 s, kills what is left, and returns the ranks' results in rank order.
A child imports this module and what it names: nothing of JAX.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch

_JOIN_S = 180.0
_COLLECTIVE_S = 60.0


def _child(target, rank, world, store, out_dir, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from demonet_tpu_torch.parallel import initialize

    try:
        initialize("file://" + store, world, rank, "gloo",
                   timeout_s=_COLLECTIVE_S)
        result = target(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target, world, tmp_path, *args):
    """Run target(rank, world, *args) on `world` gloo ranks; their
    results, in rank order. Fails if a rank fails or outlives 180 s."""
    return join(start(target, world, tmp_path, *args))


def start(target, world, tmp_path, *args):
    """Start the ranks of `spawn` and return at once; `join` waits for
    them and gives their results (within 180 s of this call)."""
    out_dir = str(tmp_path)
    store = os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(target, r, world, store, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out_dir, time.monotonic() + _JOIN_S


def join(started):
    """The results of the ranks `start` started, in rank order. Fails if
    a rank failed or is still running at its deadline (it is killed)."""
    procs, out_dir, deadline = started
    world = len(procs)
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: open(os.path.join(out_dir, f"rank{r}.err")).read()
              for r in range(world)
              if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))}
    assert not hung, f"ranks {hung} still ran after {_JOIN_S} s; {errors}"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"exit codes {codes}: {errors}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- the train step ----------------------------------------------------------

_SIZE, _CLASSES = (64, 64), 4
# the recipe's lr (the train CLI's default): at 0.05 two steps on 8 rows
# of 64x64 frames are ill-conditioned (see tests/test_torch_dist_train.py)
_LR, _MOMENTUM, _WD = 0.02, 0.9, 1e-4


def port_detector(variables):
    """The flagship at 64x64 with 4 classes, from a JAX variable tree, in
    float64."""
    from demonet_tpu_torch.models.builders import (
        ssdlite320_mobilenet_v3_large,
    )
    from demonet_tpu_torch.utils.weights import load_jax_variables

    pd = ssdlite320_mobilenet_v3_large(num_classes=_CLASSES, size=_SIZE,
                                       device="cpu")
    load_jax_variables(pd.model, variables)
    pd.model.double()
    return pd


def local_rows(batch, rank, world):
    """This rank's rows of a global batch, as tensors, images in float64."""
    n = len(batch["images"]) // world
    rows = {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:
                                                       (rank + 1) * n]))
            for k, v in batch.items()}
    rows["images"] = rows["images"].double()
    return rows


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def train_two_steps(pd, rows, mesh=None, **kw):
    """Two steps of SGD on `rows` (with steps_per_call=2, one call over
    the rows twice): each step's metrics as floats, and the state after
    each step (after the last only, with steps_per_call=2)."""
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step

    state = create_train_state(pd, make_optimizer(_LR, _MOMENTUM, _WD))
    step = make_train_step(pd, mesh=mesh, **kw)
    if kw.get("steps_per_call", 1) == 2:
        state, m = step(state, {k: torch.stack([v, v])
                                for k, v in rows.items()})
        metrics = [{k: float(v[i]) for k, v in m.items()} for i in (0, 1)]
        return {"metrics": metrics, "states": [None, _state(pd.model)]}
    metrics, states = [], []
    for _ in range(2):
        state, m = step(state, rows)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_state(pd.model))
    return {"metrics": metrics, "states": states}


def mesh_train_steps(rank, world, variables, batch):
    """This rank's rows through two mesh steps, plain, with
    steps_per_call=2 and with remat, each from the same variables."""
    from demonet_tpu_torch.parallel import data_mesh

    mesh = data_mesh([torch.device("cpu")])
    rows = local_rows(batch, rank, world)
    out = {}
    for name, kw in (("plain", {}), ("steps_per_call", {"steps_per_call": 2}),
                     ("remat", {"remat": True})):
        out[name] = train_two_steps(port_detector(variables), rows, mesh, **kw)
    return out


def mesh2d_steps_and_evaluate(rank, world, model_axis, variables, batch,
                              npz, n_frames, eval_batch):
    """This rank's place in the (data, model) mesh of `model_axis`
    replicas, two mesh steps on its data shard's rows, and the sharded
    evaluation (`sharded_evaluate`) over that mesh and over the 1-D mesh
    of every rank."""
    import torch.distributed as dist

    from demonet_tpu_torch.parallel import data_mesh

    mesh = data_mesh([torch.device("cpu")], model_axis=model_axis)
    rows = local_rows(batch, mesh.data_index, mesh.data_size)
    return {"place": (mesh.data_index, mesh.model_index, mesh.data_size),
            "group": dist.get_process_group_ranks(mesh.group),
            "steps": train_two_steps(port_detector(variables), rows, mesh),
            "evaluate": {m: sharded_evaluate(rank, world, npz, n_frames,
                                             eval_batch, model_axis=m)
                         for m in (model_axis, 1)}}


def one_rank_steps(rank, world, variables, batch):
    """Two mesh steps in a group of one, and two steps without a mesh."""
    from demonet_tpu_torch.parallel import data_mesh

    rows = local_rows(batch, rank, world)
    mesh = data_mesh([torch.device("cpu")])
    assert mesh.group is not None and mesh.world_size == 1
    return {"mesh": train_two_steps(port_detector(variables), rows, mesh),
            "plain": train_two_steps(port_detector(variables), rows)}


# -- the merges ---------------------------------------------------------------

def exact_arrays(rank):
    """Arrays whose every bit matters: float64 specials, int64 extremes,
    uint8, bool and a 0-d int64, different on each rank."""
    rng = np.random.default_rng(rank)
    f = rng.normal(size=(3, 5))
    f.flat[:6] = [np.nan, -0.0, np.inf, -np.inf, 5e-324, np.pi * (rank + 1)]
    i = rng.integers(-2 ** 62, 2 ** 62, (7,), dtype=np.int64)
    i[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max - rank]
    return {"float64": f, "int64": i,
            "uint8": rng.integers(0, 256, (2, 3, 4), dtype=np.uint8),
            "bool": rng.random(6) < 0.5,
            "scalar": np.asarray(np.int64(rank - 2 ** 40))}


class VocSet:
    """What VocEvaluator reads of a VOC dataset: image names and, by
    name, the objects ({'name', 'bbox', 'difficult'})."""

    def __init__(self, annotations):
        self.image_names = list(annotations)
        self._annotations = annotations

    def annotations_by_name(self):
        return self._annotations


def merges(rank, world, gts, sets, voc_set, classes, ckpt_root):
    """all_gather_arrays on `exact_arrays`; meters summed; this rank's
    COCO and VOC detection sets merged (stats and merged detections);
    a checkpoint saved into this rank's own directory and rank 0's read
    back right after."""
    from demonet_tpu_torch.data.coco_eval import CocoEvaluator
    from demonet_tpu_torch.data.voc_eval import VocEvaluator
    from demonet_tpu_torch.engine.state import TrainState, make_optimizer
    from demonet_tpu_torch.parallel import all_gather_arrays
    from demonet_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )
    from demonet_tpu_torch.utils.logging import MetricLogger

    out = {"gathered": {k: all_gather_arrays(v)
                        for k, v in exact_arrays(rank).items()}}

    logger = MetricLogger()
    for v in range(rank + 2):
        logger.update(loss=10.0 * rank + v, time=0.5)
    logger.synchronize_between_processes()
    out["meters"] = {k: (m.count, m.total) for k, m in logger.meters.items()}

    coco = CocoEvaluator(gts)
    coco.update(sets[rank])
    coco.synchronize_between_processes()
    coco.accumulate()
    coco.summarize()
    out["coco"] = {"detections": coco.detections, "stats": coco.stats}
    voc = VocEvaluator(voc_set, classes=classes)
    voc.update(sets[rank])
    voc.synchronize_between_processes()
    voc.accumulate()
    out["voc"] = {"detections": voc._dets, "aps": voc.summarize()}

    torch.manual_seed(rank)
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, make_optimizer(0.1)(model.named_parameters()),
                       step=rank + 1)
    mine = save_checkpoint(os.path.join(ckpt_root, f"rank{rank}"), state, 0)
    out["own_dir"] = sorted(os.listdir(os.path.dirname(mine))) \
        if os.path.isdir(os.path.dirname(mine)) else []
    other = torch.nn.Linear(3, 2)
    read = TrainState(other, make_optimizer(0.1)(other.named_parameters()))
    read, epoch, _ = load_checkpoint(
        os.path.join(ckpt_root, "rank0", "checkpoint_0"), read)
    out["read_back"] = {"step": read.step, "epoch": epoch,
                        "weight": read.model.weight.detach().clone()}
    return out


# -- evaluation ---------------------------------------------------------------

def sharded_evaluate(rank, world, npz, n_frames, batch, model_axis=1):
    """evaluate(mesh=...) of the trained flagship over this rank's shard
    of the CLI's synthetic validation frames (its data index's, on a mesh
    of `model_axis` replicas): the merged COCO summary, the image ids
    this rank fed its evaluator, and the merged set's ids."""
    from demonet_tpu_torch.data.coco_eval import CocoEvaluator
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.data.presets import DetectionPresetEval
    from demonet_tpu_torch.data.synthetic import SyntheticDetection
    from demonet_tpu_torch.engine.evaluate import evaluate, make_predict_step
    from demonet_tpu_torch.models.builders import (
        ssdlite320_mobilenet_v3_large,
    )
    from demonet_tpu_torch.parallel import data_mesh
    from demonet_tpu_torch.utils.checkpoints import load_npz_variables
    from demonet_tpu_torch.utils.weights import load_jax_variables

    mesh = data_mesh([torch.device("cpu")], model_axis=model_axis)
    det = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu")
    load_jax_variables(det.model, load_npz_variables(npz))
    ds = SyntheticDetection(n=n_frames, num_classes=7, seed=1,
                            transforms=DetectionPresetEval())
    loader = DetectionLoader(ds, batch, image_size=(320, 320),
                             num_shards=mesh.data_size,
                             shard_index=mesh.data_index)
    seen = []

    class Recording(CocoEvaluator):
        def update(self, results):
            results = list(results)
            seen.extend(r["image_id"] for r in results)
            super().update(results)

    ev = evaluate(make_predict_step(det, mesh=mesh), det.model, loader,
                  Recording(ds.ground_truth_for_eval()), mesh=mesh)
    return {"stats": ev.stats, "seen": seen, "merged": sorted(ev.detections)}
