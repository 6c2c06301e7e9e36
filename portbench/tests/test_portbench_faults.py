"""The comparison fails where it should: a run with the timed path broken
underneath (the harness's look for a chip skipped, the run on the CPU at
a small size), and the lower-precision control put in the program's
place."""

import time

import pytest
import torch

import control
from conftest import shrink
from harness import manifest, program, runner

BENCH = manifest.load_benchmark()
pytestmark = pytest.mark.usefixtures("few_threads")


def half_batch_serve(step):
    """The first half of the batch served twice: the rest left out."""
    def broken(model, images):
        h = images.shape[0] // 2
        return step(model, torch.cat([images[:h], images[:h]]))
    return broken


def answer_altered(step):
    """One detection's score changed where the postprocess makes it."""
    def broken(model, images):
        dets = step(model, images)
        dets["scores"] = dets["scores"].clone()
        dets["scores"][0, 0] += 0.01
        return dets
    return broken


def state_unchanged(step):
    """The step runs, but leaves parameters and BN statistics as they were."""
    def broken(state, batch, on_phase=None):
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, metrics = step(state, batch, on_phase=on_phase)
        with torch.no_grad():
            for k, v in state.model.state_dict().items():
                v.copy_(before[k])
        return state, metrics
    return broken


def half_batch_train(step):
    """The step over the first half of each batch, the mean over it."""
    def broken(state, batch, on_phase=None):
        h = batch["images"].shape[0] // 2
        return step(state, {k: v[:h] for k, v in batch.items()},
                    on_phase=on_phase)
    return broken


def half_loss_train(step):
    """The forward over the whole batch, the loss over its first half and
    its mean over them: the rest's ground truth left out."""
    def broken(state, batch, on_phase=None):
        h = batch["images"].shape[0] // 2
        valid = batch["gt_valid"].clone()
        valid[h:] = False
        return step(state, dict(batch, gt_valid=valid), on_phase=on_phase)
    return broken


def _after_setup(fault):
    """`fault` from the first step of the window on: a path switched
    after warm-up."""
    def wrap(step):
        broken, calls = fault(step), [0]

        def switched(state, batch, on_phase=None):
            calls[0] += 1
            f = broken if calls[0] > SETUP_STEPS else step
            return f(state, batch, on_phase=on_phase)
        return switched
    wrap.__name__ = f"{fault.__name__}_in_window"
    return wrap


def loss_not_finite(step):
    """The step runs, but reports a loss that is not a number."""
    def broken(state, batch, on_phase=None):
        state, metrics = step(state, batch, on_phase=on_phase)
        return state, dict(metrics, loss=metrics["loss"] * float("nan"))
    return broken


SETUP_STEPS = 3   # conftest.shrink's
CASES = [("ssdlite320-serve-b128", half_batch_serve),
         ("ssdlite320-serve-b128", answer_altered),
         ("ssdlite320-train-b128", state_unchanged),
         ("ssdlite320-train-b128", half_batch_train),
         ("ssdlite320-train-b128", half_loss_train),
         ("ssd300-train-b32", half_loss_train),
         ("ssdlite320-train-b128", _after_setup(state_unchanged)),
         ("ssdlite320-train-b128", _after_setup(half_loss_train)),
         ("ssdlite320-train-b128", _after_setup(loss_not_finite))]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_a_broken_timed_path_is_not_correct(name, fault):
    def small(cell):
        shrink(cell)
        cell["traffic"]["batch"] = 4

    out = runner.run(BENCH, name, 2 ** 31 + 21, 0.0, False,
                     time.perf_counter(), device="cpu", wrap_step=fault,
                     tweak=small)
    assert not out["result"]["correct"], out["result"]["checks"]


_READINGS = {}


def _readings(name):
    """control.py's readings of cell `name`, shrunk, on the CPU."""
    if name not in _READINGS:
        cell = manifest.cell(BENCH, name)
        shrink(cell)
        program.set_fp32_exact()
        seed = 2 ** 31 + 31
        _READINGS[name] = (
            cell["limits"],
            {"control": control.serve_control(cell, seed, "cpu")}
            if cell["traffic"]["entry"] == "serve"
            else control.train_control(cell, seed, "cpu"))
    return _READINGS[name]


SIDES = [(w["name"], side) for w in BENCH["workloads"]
         for side in (("control",) if manifest.cell(BENCH, w["name"])[
             "traffic"]["entry"] == "serve" else
             ("control", "half_batch", "half_loss", "state_unchanged"))]


@pytest.mark.parametrize("name,side", SIDES,
                         ids=[f"{n}-{s}" for n, s in SIDES])
def test_the_control_and_each_fault_fail_a_number(name, side):
    limits, readings = _readings(name)
    numbers = readings[side]
    assert any(numbers[k] > limits[k] for k in limits), numbers
