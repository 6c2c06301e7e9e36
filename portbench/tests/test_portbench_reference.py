"""The reference against the program on the CPU, at small sizes, for every
configuration of BENCHMARK.json: anchors, heads, the postprocess, the
loss, and whole runs of every cell."""

import time

import numpy as np
import pytest
import torch

from conftest import shrink
from harness import frames, manifest, program, runner
from reference import loss as ref_loss
from reference import postprocess as ref_post

BENCH = manifest.load_benchmark()


def _first_cell(config: str) -> str:
    """The configuration's first serve cell, or its first cell."""
    cells = [w["name"] for w in BENCH["workloads"] if w["config"] == config]
    return next((c for c in cells if manifest.cell(BENCH, c)["traffic"]
                 ["entry"] == "serve"), cells[0])


# every configuration of BENCHMARK.json, through one of its cells
CONFIGS = {c["name"]: _first_cell(c["name"]) for c in BENCH["configs"]}
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def sides(request):
    """Both sides of a configuration in float32 on the CPU, seeded alike,
    and two frames."""
    cell = manifest.cell(BENCH, CONFIGS[request.param])
    cell.update(dtype="float32", weights="seeded")
    torch.manual_seed(0)
    state = program.reference_state(cell, 2 ** 31 + 5, "cpu")
    det = program.program(cell, state, "cpu")
    net, anchors = program.reference(cell, state, "cpu")
    imgs = frames.shapes(7, 2, cell["config"]["size"][0], 8, "cpu")
    return cell, det, net, anchors, imgs


def test_anchors_equal_the_programs(sides):
    cell, det, net, anchors, _ = sides
    assert np.array_equal(anchors.numpy(), np.asarray(det.anchors))


def test_heads_and_detections_agree(sides):
    from demonet_tpu_torch.models.detection import (
        postprocess_detections,
        preprocess,
    )

    cell, det, net, anchors, imgs = sides
    cfg = cell["config"]
    with torch.no_grad():
        want = net(program.normalise(imgs["images"], cfg))
        got = det.model(preprocess(imgs["images"], det.config, resize=False))
    for k in want:
        err = (got[k] - want[k]).abs().amax() / want[k].abs().amax()
        assert err < 1e-5, (k, float(err))
    with torch.no_grad():
        ours = ref_post.detections(got["cls_logits"], got["bbox_regression"],
                                   anchors, cfg)
        theirs = postprocess_detections(got["cls_logits"],
                                        got["bbox_regression"], anchors,
                                        det.config)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def test_loss_agrees(sides):
    from demonet_tpu_torch.models.losses import multibox_loss

    cell, det, net, anchors, imgs = sides
    cfg = cell["config"]
    out = {k: torch.randn(2, anchors.shape[0], n, generator=torch.Generator()
                          .manual_seed(3)) for k, n in
           (("cls_logits", cfg["num_classes"]), ("bbox_regression", 4))}
    want = ref_loss.multibox(out["cls_logits"], out["bbox_regression"],
                             anchors, imgs["gt_boxes"], imgs["gt_labels"],
                             imgs["gt_valid"], cfg["iou_thresh"],
                             cfg["neg_to_pos_ratio"], cfg["box_coder_weights"])
    got = multibox_loss(out["cls_logits"], out["bbox_regression"], anchors,
                        imgs["gt_boxes"], imgs["gt_labels"], imgs["gt_valid"],
                        iou_thresh=cfg["iou_thresh"],
                        neg_to_pos_ratio=cfg["neg_to_pos_ratio"],
                        box_coder_weights=tuple(cfg["box_coder_weights"]))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_whole_run_is_correct(name):
    def small(cell):
        shrink(cell)
        cell["dtype"] = "float32"

    out = runner.run(BENCH, name, 2 ** 31 + 11, 0.0, True,
                     time.perf_counter(), device="cpu", tweak=small)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    assert any(k.startswith("step_host_ms.") for k in res["metrics"])
