"""End-to-end learning acceptance of the PyTorch port: overfit a tiny
synthetic detection set and require COCO AP50 to reach a threshold.

The twin of tools/overfit_smoke.py, on demonet_tpu_torch: the same data,
recipe, loop and gate, on the GPU by default. It proves that the whole
loop (loader -> train step (matching, MultiBox loss, SGD, BN statistics)
-> predict step (decode, top-k, NMS and gathers on the hand-written
kernels) -> COCO evaluator) learns.

Usage:
    python tools/overfit_smoke_torch.py [--steps 300] [--size 128]
    python tools/overfit_smoke_torch.py --steps 2 --num-images 4 \
        --batch-size 2 --min-ap50 0 --device cpu

Exit code 0 when AP50 >= --min-ap50, else 1. Without a GPU and without
`--device cpu` it raises: there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Any, Callable, Dict, List

import numpy as np

# repo root importability when run as `python tools/overfit_smoke_torch.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ShapesDataset:
    """Colored rectangles on noise; 3 foreground classes. The port's own
    copy of tools/overfit_smoke.py's dataset: the same images and targets
    for the same (n, size, seed)."""

    def __init__(self, n=32, size=128, seed=0):
        rng = np.random.RandomState(seed)
        self.samples = []
        for i in range(n):
            img = (rng.rand(size, size, 3) * 40).astype(np.uint8)
            num = rng.randint(1, 3)
            boxes, labels = [], []
            for _ in range(num):
                w, h = rng.randint(size // 5, size // 2, 2)
                x1 = rng.randint(0, size - w)
                y1 = rng.randint(0, size - h)
                label = rng.randint(1, 4)
                color = {1: [230, 40, 40], 2: [40, 230, 40], 3: [40, 40, 230]}[label]
                img[y1:y1 + h, x1:x1 + w] = color
                boxes.append([x1, y1, x1 + w, y1 + h])
                labels.append(label)
            self.samples.append((img, {
                "boxes": np.asarray(boxes, np.float32),
                "labels": np.asarray(labels, np.int64),
                "image_id": i, "orig_size": (size, size)}))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img, t = self.samples[idx]
        return img.astype(np.float32) / 255.0, t

    def ground_truth_for_eval(self):
        return [{"image_id": t["image_id"], "boxes": t["boxes"],
                 "labels": t["labels"]} for _, t in self.samples]


_BATCH_KEYS = ("images", "gt_boxes", "gt_labels", "gt_valid")


@dataclasses.dataclass
class Recipe:
    """What the loop runs: the detector, the data, the train state (model
    and SGD) and the train step."""

    detector: Any
    dataset: ShapesDataset
    loader: Any
    schedule: Callable[[int], float]
    state: Any
    step: Callable


def build(args) -> Recipe:
    """The tool's setup (tools/overfit_smoke.py:72-86): the flagship at
    --size with 3 classes, seed 0, on --device (`cuda` unless named)."""
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_lr_schedule,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import make_train_step
    from demonet_tpu_torch.models.builders import (
        resolve_device,
        ssdlite320_mobilenet_v3_large,
    )

    device = resolve_device(None if args.device == "cuda" else args.device)
    size = (args.size, args.size)
    det = ssdlite320_mobilenet_v3_large(
        num_classes=4, size=size, score_thresh=0.2,
        detections_per_img=20, topk_candidates=50, device=device, seed=0)
    ds = ShapesDataset(n=args.num_images, size=args.size)
    loader = DetectionLoader(ds, batch_size=args.batch_size, image_size=size,
                             shuffle=True, max_gt=8, prefetch=0)
    schedule = make_lr_schedule(args.lr, steps_per_epoch=len(loader),
                                milestones=[10**9], warmup_iters=50)
    tx = make_optimizer(schedule, momentum=0.9, weight_decay=1e-4)
    return Recipe(det, ds, loader, schedule, create_train_state(det, tx),
                  make_train_step(det))


def run(args) -> Dict[str, Any]:
    """Train --steps steps, then evaluate on the training images.

    Returns {'ap50', 'losses': [(step, loss, ms per step so far)] every
    50 steps, 'ms_per_step' (mean over the run), 'train_seconds',
    'eval_seconds', 'evaluator', 'recipe'}."""
    from demonet_tpu_torch.data.coco_eval import CocoEvaluator
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.engine.evaluate import evaluate, make_predict_step

    recipe = build(args)
    det, ds, loader = recipe.detector, recipe.dataset, recipe.loader
    state, step = recipe.state, recipe.step

    t0 = time.time()
    it = 0
    losses: List[tuple] = []
    metrics = None
    while it < args.steps:
        # the step count as the epoch, as tools/overfit_smoke.py does
        loader.set_epoch(it)
        for batch in loader:
            batch = {k: v for k, v in batch.items() if k in _BATCH_KEYS}
            state, metrics = step(state, batch)
            it += 1
            if it % 50 == 0:
                loss = float(metrics["loss"])
                ms = (time.time() - t0) / it * 1000
                losses.append((it, loss, ms))
                print(f"step {it}: loss {loss:.3f} ({ms:.0f} ms/step)")
            if it >= args.steps:
                break
    if metrics is not None:
        float(metrics["loss"])   # waits for the last step on the device
    train_seconds = time.time() - t0

    predict = make_predict_step(det)
    eval_loader = DetectionLoader(ds, batch_size=args.batch_size,
                                  image_size=det.config.size, prefetch=0)
    t0 = time.time()
    ev = evaluate(predict, state, eval_loader,
                  CocoEvaluator(ds.ground_truth_for_eval()))
    return {"ap50": float(ev.stats[1]), "losses": losses,
            "ms_per_step": train_seconds / max(it, 1) * 1000,
            "train_seconds": train_seconds,
            "eval_seconds": time.time() - t0, "evaluator": ev,
            "recipe": recipe}


def main(args) -> int:
    out = run(args)
    ap50 = out["ap50"]
    print(f"\nAP50 after {args.steps} steps: {ap50:.3f}")
    ok = ap50 >= args.min_ap50
    print("PASS" if ok else "FAIL", f"(threshold {args.min_ap50})")
    return 0 if ok else 1


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="overfit a tiny synthetic set with the PyTorch port")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--num-images", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--min-ap50", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p


if __name__ == "__main__":
    sys.exit(main(get_args_parser().parse_args()))
