"""The `serve` entry: one closed-loop client of batch requests.

A request copies a batch of uint8 frames from the pinned pool to the
card, calls the program's predict step (`engine.evaluate.
make_predict_step`: preprocess, the SSD forward, the postprocess), and
copies the detections back into pinned host buffers; its latency runs
from the start of the upload to the detections on the host. Requests
take the pool's batches in turn.

`correct` compares requests the window served, one of each pool batch
(which occurrence is drawn from the seed), at the timed batch:

  * `heads_err`: the program's head outputs (caught by a forward hook on
    its model during the request) against the reference's float32
    forward of the same frames: the largest absolute difference over the
    largest reference magnitude, the worse of the class logits and the
    box regression;
  * `dets_mismatch`: the detections the client received against the
    reference postprocess run over those same head outputs: rows that
    differ in any bit. The postprocess after softmax and decode is sorts,
    gathers and comparisons, exact given its inputs; it cannot be held
    to an independent forward, whose rounding moves top-k and NMS
    decisions that sit at a tie or a threshold.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from harness import frames, program, work
from harness import trace as trace_lib
from harness.clock import Clock
from reference import nets
from reference import postprocess as ref_post

KEYS = ("boxes", "scores", "labels", "valid")
_WARMUP_PASSES = 2
# a pool batch's sampled occurrence is drawn from its first this many
_SAMPLE_SPAN = 8


class Serve:
    def __init__(self, cell: dict, seed: int, device, trace: bool,
                 wrap_step: Optional[Callable] = None):
        from demonet_tpu_torch.engine.evaluate import make_predict_step

        self.cell, self.trace = cell, trace
        self.device = torch.device(device)
        self.clock = Clock(self.device)
        cfg, traffic = cell["config"], cell["traffic"]
        self.batch, self.pool_size = traffic["batch"], traffic["pool"]
        self.state = program.reference_state(cell, seed, self.device)
        self.det = program.program(cell, self.state, self.device)
        step = make_predict_step(self.det, impl=traffic["postprocess"])
        self.step = wrap_step(step) if wrap_step else step
        self.anchors = program.reference_anchors(
            nets.build(cfg, "meta"), cfg, self.device)
        size = cfg["size"][0]
        pool = frames.shapes(seed, self.batch * self.pool_size, size,
                             traffic["max_gt"], self.device)["images"]
        self.pool = pool.view(self.pool_size, self.batch, size, size, 3)
        self.occurrence = [int(v) for v in frames.rng(seed, frames.SAMPLE)
                           .integers(0, _SAMPLE_SPAN, self.pool_size)]
        self.outputs = None
        self.marks: List = []
        self.step_host_s: List[float] = []
        self.host: Optional[Dict[str, torch.Tensor]] = None
        self.captured: Dict[int, tuple] = {}
        self.det.model.register_forward_pre_hook(self._pre)
        self.det.model.register_forward_hook(self._post)
        for i in range(_WARMUP_PASSES * self.pool_size):
            self.request(i)
        self.clock.wait()

    # hooks on the program's model: each request's head outputs, and with
    # tracing on, marks at the forward's start and end
    def _pre(self, module, args):
        if self.trace:
            self.marks.append(self.clock.mark())

    def _post(self, module, args, out):
        self.outputs = out
        if self.trace:
            self.marks.append(self.clock.mark())

    def request(self, i: int, spans: bool = False) -> float:
        """Serve request i; returns its latency in seconds."""
        b = i % self.pool_size
        t0 = time.perf_counter()
        with trace_lib.span("upload", spans):
            x = self.pool[b].to(self.device, non_blocking=True)
        with trace_lib.span("step", spans):
            h0 = time.perf_counter()
            dets = self.step(self.det.model, x)
            self.step_host_s.append(time.perf_counter() - h0)
            if self.trace:
                self.marks.append(self.clock.mark())
        with trace_lib.span("download", spans):
            if self.host is None:
                pin = self.device.type == "cuda"
                self.host = {k: torch.empty(dets[k].shape, dtype=dets[k].dtype,
                                            pin_memory=pin) for k in KEYS}
            for k in KEYS:
                self.host[k].copy_(dets[k], non_blocking=True)
            self.clock.wait()
        latency = time.perf_counter() - t0
        if b not in self.captured or i // self.pool_size <= self.occurrence[b]:
            self.captured[b] = (self.outputs,
                                {k: v.clone() for k, v in self.host.items()})
        return latency

    def window(self, run, seconds: float) -> None:
        """Requests until `seconds` have passed, one of each pool batch at
        least. With tracing on, `trace_requests` more after the window
        closes, traced (`trace.traced`)."""
        self.captured.clear()
        self.marks, self.step_host_s = [], []
        lat: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(lat) < self.pool_size:
            lat.append(self.request(len(lat)))
        run.window_s = time.perf_counter() - t0
        run.latencies_s = lat
        run.images = len(lat) * self.batch
        run.attempted, run.failed = len(lat), 0
        run.step_host_s = list(self.step_host_s)
        if not self.trace:
            return
        m = self.marks
        run.phase_ms = {
            "forward": [self.clock.ms(m[j], m[j + 1])
                        for j in range(0, len(m) - 2, 3)],
            "postprocess": [self.clock.ms(m[j + 1], m[j + 2])
                            for j in range(0, len(m) - 2, 3)]}
        calls = iter(range(len(lat), 1 << 62))
        run.trace_summary, run.launches = trace_lib.traced(
            lambda spans: self.request(next(calls), spans),
            self.cell["traffic"]["trace_requests"], self.device,
            program.Launches())
        self.work(run)

    def work(self, run) -> None:
        """K1's bound per launch, averaged over the captured requests: the
        NMS problems of the reference postprocess over their head outputs,
        the problems the program's K1 was given."""
        bounds = []
        with torch.no_grad():
            for outs, _ in self.captured.values():
                s = ref_post.stages(outs["cls_logits"], outs["bbox_regression"],
                                    self.anchors, self.cell["config"])
                k = s["cand_scores"].shape[-1]
                bounds.append(work.bound_ms(*work.nms_work(
                    s["keep"].reshape(-1, k), s["cand_scores"].reshape(-1, k),
                    ref_post.NEG / 2)))
        run.k1_bound_ms = sum(bounds) / len(bounds)

    def check(self, run) -> Dict[str, float]:
        """Free the program, then compare (see the module doc)."""
        captured = [(b, *self.captured[b]) for b in sorted(self.captured)]
        self.captured.clear()
        self.det = self.step = self.outputs = None
        self.clock.free()
        net, anchors = program.reference(self.cell, self.state, self.device)
        return compare(net, anchors, self.cell["config"], self.pool, captured,
                       self.device, self.cell["traffic"]["reference_rows"])


def reference_heads(net, images: torch.Tensor, cfg: dict, device,
                    rows: int) -> Dict[str, torch.Tensor]:
    """The reference forward of uint8 frames, `rows` at a time."""
    parts = []
    with torch.no_grad():
        for j in range(0, images.shape[0], rows):
            parts.append(net(program.normalise(
                images[j:j + rows].to(device), cfg)))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|; inf where the shapes differ."""
    if got.shape != want.shape:
        return float("inf")
    diff = (got.to(torch.float32) - want).abs().amax()
    return float(diff / want.abs().amax().clamp(min=1e-30))


def rms_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| over |want|, both as whole-tensor 2-norms; inf where
    the shapes differ."""
    if got.shape != want.shape:
        return float("inf")
    return float((got.to(torch.float32) - want).norm()
                 / want.norm().clamp(min=1e-30))


def mismatch(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
             ) -> int:
    """Detection rows that differ in any field, bit for bit."""
    if got["boxes"].shape != want["boxes"].shape:
        return got["boxes"].shape[0] * got["boxes"].shape[1]
    rows = ((got["boxes"] != want["boxes"]).any(-1)
            | (got["scores"] != want["scores"])
            | (got["labels"] != want["labels"])
            | (got["valid"] != want["valid"]))
    return int(rows.sum())


def compare(net, anchors, cfg, pool, captured, device, rows
            ) -> Dict[str, float]:
    """heads_err and dets_mismatch over the captured requests."""
    heads, dets = 0.0, 0
    for b, outs, host in captured:
        ref = reference_heads(net, pool[b], cfg, device, rows)
        heads = max(heads, rel_err(outs["cls_logits"], ref["cls_logits"]),
                    rel_err(outs["bbox_regression"], ref["bbox_regression"]))
        with torch.no_grad():
            want = ref_post.detections(outs["cls_logits"],
                                       outs["bbox_regression"], anchors, cfg)
        dets += mismatch({k: v.to(device) for k, v in host.items()}, want)
    return {"heads_err": heads, "dets_mismatch": float(dets)}
