"""VOC evaluation CLI (counterpart of demonet_tpu/eval_voc.py; the
reference's demonet/eval_voc.py in working form).

    python -m demonet_tpu_torch.eval_voc --data-path /data/VOCdevkit \
        --arch ssd_lite_mobilenet_v2 --torch-weights ssd_lite_v2.pth
    python -m demonet_tpu_torch.eval_voc --data-path /data/VOCdevkit \
        --checkpoint out/checkpoint_25 --device cpu

Batched inference over VOC2007 test through `make_predict_step` (on the
card: the NMS and row-gather kernels), the VOCdevkit detection files
(det_test_<cls>.txt) under --results-dir if given, and the per-class AP
and mean AP, VOC07 11-point metric by default (reference eval_voc.py:
50-96). Under a launcher (`python -m torch.distributed.run
--nproc_per_node N -m demonet_tpu_torch.eval_voc ...`) the processes
join one group (NCCL on the GPU, gloo with `--device cpu`), each
evaluates its shard of the images, and the detections are merged before
the APs, as the JAX CLI's data mesh does. The flags are the JAX CLI's,
plus `--device` (`cuda` by default; with no GPU it raises unless asked
for `cpu`). `main` returns the evaluator (`aps` holds the per-class APs
and the mAP).
"""

from __future__ import annotations

import argparse


def get_args_parser(add_help: bool = True) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="demonet_tpu_torch VOC evaluation", add_help=add_help)
    parser.add_argument("--data-path", default="/data/VOCdevkit")
    parser.add_argument("--year", default="2007")
    parser.add_argument("--image-set", default="test")
    parser.add_argument("--arch", default="ssd_lite_mobilenet_v2")
    parser.add_argument("--num-classes", default=21, type=int)
    parser.add_argument("--image-size", default=320, type=int)
    parser.add_argument("--batch-size", "-b", default=32, type=int)
    parser.add_argument("--score-thresh", default=0.01, type=float)
    parser.add_argument("--checkpoint", default="",
                        help="a checkpoint_<epoch> directory of the train "
                             "CLI to evaluate")
    parser.add_argument("--torch-weights", default="",
                        help=".pth checkpoint (converted on the fly)")
    parser.add_argument("--pretrained", action="store_true",
                        help="published checkpoint from the weights cache")
    parser.add_argument("--results-dir", default="",
                        help="write det_test_<cls>.txt files here")
    parser.add_argument("--use-07-metric", action="store_true", default=True)
    parser.add_argument("--postprocess", default="reference",
                        choices=["reference", "fused"],
                        help="'fused' = trained-model fast postprocess "
                             "(exactness-guarded fallback)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    return parser


def main(args):
    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.data.presets import DetectionPresetEval
    from demonet_tpu_torch.data.voc import VOCDetection
    from demonet_tpu_torch.data.voc_eval import VocEvaluator
    from demonet_tpu_torch.engine.evaluate import evaluate, make_predict_step
    from demonet_tpu_torch.models.builders import get_model, resolve_device
    from demonet_tpu_torch.parallel import (
        data_mesh,
        initialize,
        process_count,
        process_index,
    )

    device = resolve_device(None if args.device == "cuda" else args.device)
    initialize(backend="gloo" if device.type == "cpu" else None)
    mesh = data_mesh([device])
    device = mesh.device
    dataset = VOCDetection(
        args.data_path, args.year, args.image_set, DetectionPresetEval())
    size = (args.image_size, args.image_size)
    detector = get_model(
        args.arch, num_classes=args.num_classes, size=size,
        score_thresh=args.score_thresh, device=device)

    if args.pretrained or args.torch_weights:
        from demonet_tpu_torch.utils.pretrained import load_pretrained

        load_pretrained(detector.model, args.arch,
                        path=args.torch_weights or None)
        print(f"loaded pretrained weights for {args.arch}")
    elif args.checkpoint:
        from demonet_tpu_torch.utils.checkpoints import load_variables

        detector.model.load_state_dict(load_variables(args.checkpoint))

    loader = DetectionLoader(
        dataset, args.batch_size, image_size=size,
        num_shards=process_count(), shard_index=process_index())
    evaluator = VocEvaluator(
        dataset, use_07_metric=args.use_07_metric,
        output_dir=args.results_dir or None)
    predict_step = make_predict_step(detector, mesh=mesh,
                                     impl=args.postprocess)
    return evaluate(predict_step, detector.model, loader, evaluator,
                    mesh=mesh)


if __name__ == "__main__":
    from demonet_tpu_torch.parallel.dist import leave

    try:
        main(get_args_parser().parse_args())
    finally:
        leave()
