"""Single-image and folder inference CLI (counterpart of
demonet_tpu/predict.py; the reference's demo path, util/image_utils.py
and the hub usage in its README).

    python -m demonet_tpu_torch.predict --model ssdlite320_mobilenet_v3_large \
        --checkpoint out/checkpoint_25 --images dog.jpg street.jpg \
        --score-thresh 0.5 --output-dir vis/
    python -m demonet_tpu_torch.predict --torch-weights ssdlite.pth \
        --images dog.jpg --device cpu

Each image is read and resized by cv2, run through `make_predict_step`
(on the card: the NMS and row-gather kernels), and saved with its boxes
and class names drawn at its own size. The flags are the JAX CLI's, plus
`--device` (`cuda` by default; with no GPU it raises unless asked for
`cpu`). `main` returns each image's detections above the threshold.
"""

from __future__ import annotations

import argparse
import os


def get_args_parser(add_help: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="demonet_tpu_torch predict",
                                add_help=add_help)
    p.add_argument("--model", default="ssdlite320_mobilenet_v3_large")
    p.add_argument("--num-classes", default=91, type=int)
    p.add_argument("--dataset-labels", default="coco", choices=["coco", "voc"])
    p.add_argument("--checkpoint", default="",
                   help="a checkpoint_<epoch> directory of the train CLI")
    p.add_argument("--torch-weights", default="",
                   help="a torch .pth in the reference's state_dict layout")
    p.add_argument("--pretrained", action="store_true",
                   help="published checkpoint from the weights cache "
                        "(utils/pretrained.py)")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--postprocess", default="reference",
                   choices=["reference", "fused"],
                   help="'fused' = trained-model fast postprocess "
                        "(chunk-gather select + one NMS/image, exactness-"
                        "guarded fallback)")
    p.add_argument("--score-thresh", default=0.5, type=float)
    p.add_argument("--output-dir", default="predictions")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p


def main(args):
    """Predict, draw and save each image; returns one dict per image
    (`boxes`, `scores`, `labels`, `valid`: numpy, the detections above
    --score-thresh, boxes in the image's own pixels)."""
    import cv2
    import numpy as np
    import torch

    from demonet_tpu_torch.engine.evaluate import make_predict_step
    from demonet_tpu_torch.models.builders import get_model, resolve_device
    from demonet_tpu_torch.utils.viz import (
        load_image,
        overlay_boxes,
        overlay_class_names,
        select_top_predictions,
    )

    if args.dataset_labels == "coco":
        from demonet_tpu_torch.data.coco import COCO_CLASSES as class_names
    else:
        from demonet_tpu_torch.data.voc import VOC_CLASSES as class_names

    device = resolve_device(None if args.device == "cuda" else args.device)
    detector = get_model(args.model, num_classes=args.num_classes,
                         device=device)
    if args.pretrained or args.torch_weights:
        from demonet_tpu_torch.utils.pretrained import load_pretrained

        load_pretrained(detector.model, args.model,
                        path=args.torch_weights or None)
    elif args.checkpoint:
        from demonet_tpu_torch.utils.checkpoints import load_variables

        detector.model.load_state_dict(load_variables(args.checkpoint))

    predict = make_predict_step(detector, impl=args.postprocess)
    size = detector.config.size
    os.makedirs(args.output_dir, exist_ok=True)

    results = []
    for path in args.images:
        orig = (load_image(path) * 255).astype(np.uint8)
        resized = load_image(path, size=size)
        dets = predict(
            detector.model, torch.from_numpy(resized[None]).to(device),
            torch.tensor([[orig.shape[0], orig.shape[1]]], dtype=torch.int32,
                         device=device))
        per_img = {k: v[0].cpu().numpy() for k, v in dets.items()}
        top = select_top_predictions(per_img, args.score_thresh)
        vis = overlay_boxes(orig, top["boxes"], top["labels"])
        vis = overlay_class_names(
            vis, top["boxes"], top["labels"], top["scores"], class_names)
        out_path = os.path.join(args.output_dir, os.path.basename(path))
        cv2.imwrite(out_path, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
        print(f"{path}: {len(top['boxes'])} detections above "
              f"{args.score_thresh} -> {out_path}")
        results.append(top)
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
