"""The `train` entry: the program's train step, closed loop.

Set-up builds one train state (`engine.state.create_train_state` over
`make_optimizer(make_lr_schedule(...))`, the traffic's recipe) and one
step (`engine.train.make_train_step`), and drives them through their
first steps on pool batches that all differ, each batch copied from
pinned host memory to the card as the window does. The window then goes
on with the same state and step, batches in turn from the pool, and ends
with a synchronise; the loss terms stay on the device until after it.
A window step whose loss is not finite counts in `failed`, and any such
step makes the run not correct.

`correct` holds two stretches of the program's steps against the
reference's float32 steps on the same batches:

  * the first three steps, which set-up ran, against the reference's
    three steps from the same weights;
  * one step of the window, drawn from the seed among its first
    `window_check_span` (the traffic file): the parameters, BN statistics
    and momentum buffers are copied before it and after it, and the
    reference takes the same step from the copy before. Its numbers
    carry the prefix `win_`. The reference follows the program from the
    program's own state here; the first stretch holds where it starts.

The numbers of each stretch:

  * `heads_err`, `heads_rms_err`: the (first) step's train-mode head
    outputs (caught by a forward hook on the program's model) against the
    reference's: max |difference| over max |reference|, and the same as
    whole-tensor 2-norms; the worse of the two heads;
  * `head_grad_err`: the gradient of the loss with respect to those head
    outputs, image by image: the gap between the norms of the program's
    and the reference's row, over the larger of the reference row's norm
    and the median row's; the median image, the worse of the two heads.
    A loss taken over part of the batch leaves rows at 0 and scales the
    rest, which norms of whole leaves see only to second order;
  * `loss_err`: each step's two loss terms, |program - reference| over
    |reference|, the worst;
  * `grad_err`: the gradient as the optimizer got it (from its momentum
    buffers: after - momentum * before - weight decay * parameter), by
    the worst leaf: the gap between the program's norm and the
    reference's over the larger of the reference's norm of that leaf and
    of the median leaf;
  * `change_err`: the change of the parameters and BN statistics over
    the stretch, by the worst leaf as `grad_err`. Parameters whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out;
  * `grad_med_err`, `change_med_err`: the same gaps of the median leaf;
  * `grad_worst`, `change_worst`: the names of the worst leaves (read,
    never compared).

A cell's workload file names in `limits` the numbers it holds.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from harness import frames, program
from harness import trace as trace_lib
from harness.clock import Clock
from reference import loss as ref_loss
from reference import sgd as ref_sgd

KEYS = ("images", "gt_boxes", "gt_labels", "gt_valid")
PHASES = ("forward", "loss", "backward", "optimizer")
CHECKED_STEPS = 3
_TINY_GRAD = 1e-3


def lr_args(traffic: dict) -> dict:
    o = traffic["optimizer"]
    return dict(base_lr=o["lr"], steps_per_epoch=o["steps_per_epoch"],
                milestones=o["milestones"], gamma=o["gamma"])


class Capture:
    """The head outputs of the next forward of `model` and the loss's
    gradient with respect to them, in float32."""

    def __init__(self, model: torch.nn.Module):
        self.heads: Dict[str, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out) -> None:
        if self.heads:
            return
        for k, v in out.items():
            self.heads[k] = v.detach().float().clone()
            if v.requires_grad:
                v.register_hook(lambda g, k=k: self._grad(k, g))

    def _grad(self, k: str, g: torch.Tensor) -> None:
        self.grads[k] = g.detach().float().clone()

    def remove(self) -> None:
        self.handle.remove()


class Train:
    def __init__(self, cell: dict, seed: int, device, trace: bool,
                 wrap_step: Optional[Callable] = None):
        from demonet_tpu_torch.engine.state import (
            create_train_state,
            make_lr_schedule,
            make_optimizer,
        )
        from demonet_tpu_torch.engine.train import make_train_step

        self.cell, self.trace = cell, trace
        self.device = torch.device(device)
        self.clock = Clock(self.device)
        cfg, traffic = cell["config"], cell["traffic"]
        opt = traffic["optimizer"]
        self.momentum, self.wd = opt["momentum"], opt["weight_decay"]
        self.batch, self.pool_size = traffic["batch"], traffic["pool"]
        if self.pool_size < CHECKED_STEPS:
            raise ValueError(f"a train pool holds {CHECKED_STEPS} batches at "
                             "least: the checked steps take different rows")
        self.win_at = int(frames.rng(seed, frames.SAMPLE).integers(
            0, traffic["window_check_span"]))
        self.state = program.reference_state(cell, seed, self.device)
        det = program.program(cell, self.state, self.device)
        a = lr_args(traffic)
        tx = make_optimizer(make_lr_schedule(a["base_lr"], a["steps_per_epoch"],
                                             a["milestones"], a["gamma"]),
                            momentum=opt["momentum"],
                            weight_decay=opt["weight_decay"])
        self.train_state = create_train_state(det, tx)
        step = make_train_step(det)
        self.step = wrap_step(step) if wrap_step else step
        pool = frames.shapes(seed, self.batch * self.pool_size, cfg["size"][0],
                             traffic["max_gt"], self.device)
        self.pool = {k: v.view(self.pool_size, self.batch, *v.shape[1:])
                     for k, v in pool.items()}
        self.model = det.model
        start = self._copy()
        metrics = []
        for i in range(traffic["setup_steps"]):
            if i == 0:
                cap = Capture(self.model)
            metrics.append(self.run_step(i))
            if i == 0:
                cap.remove()
                bufs1 = self._copy()["bufs"]
            if i + 1 == CHECKED_STEPS:
                end = self._copy()
        self.first = dict(start=start, end=end, bufs1=bufs1, capture=cap,
                          metrics=metrics[:CHECKED_STEPS])
        self.done = traffic["setup_steps"]
        self.clock.wait()

    def _copy(self) -> dict:
        """Copies of the parameters, BN statistics and momentum buffers."""
        st = self.train_state.optimizer.state
        return {"state": _snapshot(self.model),
                "bufs": {n: st[p]["momentum_buffer"].clone()
                         for n, p in self.model.named_parameters()
                         if "momentum_buffer" in st.get(p, {})}}

    def run_step(self, i: int, on_phase=None, spans: bool = False):
        """Step i on pool batch i mod pool, copied to the card first."""
        with trace_lib.span("upload", spans):
            batch = {k: self.pool[k][i % self.pool_size].to(
                self.device, non_blocking=True) for k in KEYS}
        with trace_lib.span("step", spans):
            self.train_state, m = self.step(self.train_state, batch,
                                            on_phase=on_phase)
        return m

    def window(self, run, seconds: float) -> None:
        """Steps until `seconds` have passed and the checked step is done;
        the window ends when the device has done them. With tracing on,
        `trace_requests` more steps after it, traced (`trace.traced`)."""
        marks: List[list] = []
        host_s: List[float] = []
        metrics = []
        self.clock.wait()
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds
               or len(metrics) <= self.win_at):
            on_phase = None
            if self.trace:
                row = [self.clock.mark()]
                marks.append(row)
                on_phase = lambda name, row=row: row.append(  # noqa: E731
                    self.clock.mark())
            checked = len(metrics) == self.win_at
            if checked:
                start, cap = self._copy(), Capture(self.model)
            h0 = time.perf_counter()
            metrics.append(self.run_step(self.done + len(metrics), on_phase))
            host_s.append(time.perf_counter() - h0)
            if checked:
                cap.remove()
                end = self._copy()
                self.win = dict(start=start, end=end, bufs1=end["bufs"],
                                capture=cap, metrics=metrics[-1:],
                                step=self.done + self.win_at)
        self.clock.wait()
        run.window_s = time.perf_counter() - t0
        n = len(metrics)
        run.steps, run.images = n, n * self.batch
        losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
        run.attempted, run.failed = n, int((~torch.isfinite(losses)).sum())
        run.step_host_s = host_s
        if not self.trace:
            return
        run.phase_ms = {p: [self.clock.ms(r[j], r[j + 1]) for r in marks]
                        for j, p in enumerate(PHASES)}
        calls = iter(range(self.done + n, 1 << 62))
        run.trace_summary, run.launches = trace_lib.traced(
            lambda spans: self.run_step(next(calls), spans=spans),
            self.cell["traffic"]["trace_requests"], self.device,
            program.Launches())

    def got(self, stretch: dict) -> dict:
        """What the program did over a stretch, in the form `compare`
        takes: the gradient of its first step from the momentum buffers
        before it and after it (`bufs1`)."""
        s, e = stretch["start"], stretch["end"]
        return {"loss": [[float(m[k]) for k in ("bbox_regression",
                                                "classification")]
                         for m in stretch["metrics"]],
                "heads": stretch["capture"].heads,
                "head_grads": stretch["capture"].grads,
                "grad": {n: b.float() - self.momentum * s["bufs"].get(
                    n, torch.zeros_like(b)).float()
                    - self.wd * s["state"][n].float()
                    for n, b in stretch["bufs1"].items()},
                "change": {n: e["state"][n].float() - v.float()
                           for n, v in s["state"].items()}}

    def check(self, run) -> Dict[str, float]:
        """Free the program, run the reference's steps, compare."""
        first, win = self.got(self.first), self.got(self.win)
        win_start, win_step = self.win["start"], self.win["step"]
        self.train_state = self.step = self.model = None
        self.first = self.win = None
        self.clock.free()
        numbers = compare(first, reference_steps(
            self.cell, self.state, self.pool, self.device))
        want = reference_step(self.cell, win_start, self.pool, win_step,
                              self.device)
        numbers.update({f"win_{k}": v for k, v in compare(win, want).items()})
        return numbers


def _snapshot(model) -> Dict[str, torch.Tensor]:
    """Copies of the parameters and BN statistics."""
    return {n: t.detach().clone() for n, t in model.state_dict().items()
            if not n.endswith("num_batches_tracked")}


def _batch(pool, i: int, device, rows: Optional[int],
           loss_rows: Optional[int]) -> Dict[str, torch.Tensor]:
    """Pool batch i mod pool on the device; `rows` keeps only the first
    rows, `loss_rows` takes the ground truth of the rows after the first
    ones out of the loss (planted faults)."""
    b = {k: pool[k][i % pool[k].shape[0]][:rows].to(device) for k in KEYS}
    if loss_rows is not None:
        b["gt_valid"] = b["gt_valid"].clone()
        b["gt_valid"][loss_rows:] = False
    return b


def _steps(cell: dict, start: dict, pool, first: int, count: int, device,
           precision: str, rows: Optional[int], loss_rows: Optional[int]
           ) -> dict:
    """`count` reference steps from `start` ({'state', 'bufs'}), update
    numbers first ... first + count - 1 on their pool batches, in the
    form `compare` takes."""
    from reference import nets

    cfg, traffic = cell["config"], cell["traffic"]
    opt = traffic["optimizer"]
    net, anchors = program.reference(cell, start["state"], device)
    nets.set_precision(net, precision).train()
    named = list(net.named_parameters())
    sgd = ref_sgd.SGD([p for _, p in named], opt["momentum"],
                      opt["weight_decay"],
                      [start["bufs"].get(n) for n, _ in named])
    p0 = _snapshot(net)
    losses, grad, heads, head_grads = [], None, None, {}
    for i in range(first, first + count):
        b = _batch(pool, i, device, rows, loss_rows)
        out = net(program.normalise(b["images"], cfg))
        if i == first:
            heads = {k: v.detach().clone() for k, v in out.items()}
            for v in out.values():
                v.retain_grad()
        terms = ref_loss.multibox(
            out["cls_logits"], out["bbox_regression"], anchors, b["gt_boxes"],
            b["gt_labels"], b["gt_valid"], cfg["iou_thresh"],
            cfg["neg_to_pos_ratio"], cfg["box_coder_weights"])
        net.zero_grad(set_to_none=True)
        (terms["bbox_regression"] + terms["classification"]).backward()
        if i == first:
            grad = {n: p.grad.detach().clone() for n, p in named}
            head_grads = {k: v.grad.detach().clone() for k, v in out.items()}
        sgd.step(ref_sgd.learning_rate(i, **lr_args(traffic)))
        losses.append([float(terms["bbox_regression"].detach()),
                       float(terms["classification"].detach())])
    p1 = _snapshot(net)
    return {"loss": losses, "heads": heads, "head_grads": head_grads,
            "grad": grad, "change": {n: p1[n] - v for n, v in p0.items()}}


def reference_steps(cell: dict, state: Dict[str, torch.Tensor], pool,
                    device, precision: str = "fp32", rows: Optional[int] = None,
                    loss_rows: Optional[int] = None) -> dict:
    """The reference's first CHECKED_STEPS steps from `state` on pool
    batches 0, 1, 2. `precision` "fp8" (or "tf32") is the control;
    `rows` and `loss_rows` plant faults (`_batch`)."""
    return _steps(cell, {"state": state, "bufs": {}}, pool, 0,
                  CHECKED_STEPS, device, precision, rows, loss_rows)


def reference_step(cell: dict, start: dict, pool, step: int, device,
                   precision: str = "fp32", rows: Optional[int] = None,
                   loss_rows: Optional[int] = None) -> dict:
    """The reference's update number `step` from the program's copy
    `start` ({'state', 'bufs'}) on its pool batch."""
    return _steps(cell, start, pool, step, 1, device, precision, rows,
                  loss_rows)


def unchanged(want: dict) -> dict:
    """The reference's stretch with its change taken as nothing: a step
    that returns its state unchanged."""
    return dict(want, change={n: torch.zeros_like(v)
                              for n, v in want["change"].items()})


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               names) -> Dict[str, float]:
    """Per leaf, |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {n: float(want[n].norm()) for n in names}
    median = statistics.median(norms.values())
    return {n: abs((float(got[n].norm()) if n in got else 0.0) - norms[n])
            / max(norms[n], median, 1e-30) for n in names}


def _row_gap(got: Optional[torch.Tensor], want: torch.Tensor) -> float:
    """The median image's gap of norms (see `head_grad_err`); inf where
    the program gave no gradient or another shape."""
    if got is None or got.shape != want.shape:
        return float("inf")
    g = got.to(torch.float32).flatten(1).norm(dim=1)
    w = want.flatten(1).norm(dim=1)
    gaps = (g - w).abs() / torch.maximum(w, w.median()).clamp(min=1e-30)
    return float(gaps.median())


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers of the module doc, for one stretch."""
    from harness.serve import rel_err, rms_err

    loss_err = max(abs(g - w) / max(abs(w), 1e-30)
                   for gs, ws in zip(got["loss"], want["loss"])
                   for g, w in zip(gs, ws))
    if not all(math.isfinite(g) for gs in got["loss"] for g in gs):
        loss_err = float("inf")
    gnorm = {n: float(g.norm()) for n, g in want["grad"].items()}
    median = statistics.median(gnorm.values())
    grad = _leaf_gaps(got["grad"], want["grad"], list(gnorm))
    moving = [n for n in want["change"]
              if n not in gnorm or gnorm[n] >= _TINY_GRAD * median]
    change = _leaf_gaps(got["change"], want["change"], moving)
    heads = want["heads"]
    return {"heads_err": max(rel_err(got["heads"][k], heads[k])
                             for k in heads),
            "heads_rms_err": max(rms_err(got["heads"][k], heads[k])
                                 for k in heads),
            "head_grad_err": max(_row_gap(got["head_grads"].get(k), g)
                                 for k, g in want["head_grads"].items()),
            "loss_err": loss_err,
            "grad_err": max(grad.values()),
            "change_err": max(change.values()),
            "grad_med_err": statistics.median(grad.values()),
            "change_med_err": statistics.median(change.values()),
            "grad_worst": max(grad, key=grad.get),
            "change_worst": max(change, key=change.get)}
