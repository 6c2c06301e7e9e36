"""Training CLI (counterpart of demonet_tpu/train.py; reference
demonet/train.py:51-210).

Usage, on the GPU (the default device) or, with `--device cpu`, on the
CPU:

    python -m demonet_tpu_torch.train --data-path /data/coco --dataset coco \
        --model ssdlite320_mobilenet_v3_large --batch-size 16 --epochs 26
    python -m demonet_tpu_torch.train --dataset synthetic --epochs 1 \
        --output-dir out/ --device cpu
    python -m demonet_tpu_torch.train --dataset synthetic --test-only \
        --resume out/checkpoint_0 --device cpu

`--model` takes each of the five detectors (`models/builders.DETECTORS`),
and the frames take the model's own input size; a classifier's name
raises a ValueError before anything is built, where the JAX CLI fails on
the classifier's missing `config`. The flags and defaults are the JAX
CLI's, plus `--device`. Defaults
mirror the reference recipe: lr 0.02, SGD momentum 0.9, weight decay
1e-4, epochs 26, MultiStepLR [16, 22] gamma 0.1, linear warmup 1000 iters
(train.py:59-75, engine.py:21-25). One process on one device: the JAX
CLI's data mesh and multi-host bootstrap wait for ROADMAP Queue 1 item 10.
`--pretrained` and `--torch-weights` load a checkpoint in the reference's
torch layout (`utils.pretrained`, `utils.torch_weights`) before
`--npz-weights` applies; `--tensorboard` adds TensorBoard scalars where
the `tensorboard` package imports. Flags of what is not ported raise
NotImplementedError naming the ROADMAP item: `--bf16` and `--remat`
(7b); `--lane-pack` and `--stem-s2d` are TPU layout knobs, not ported on
purpose.
"""

from __future__ import annotations

import argparse
import time


def get_args_parser(add_help: bool = True) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="demonet_tpu_torch detection training", add_help=add_help)
    parser.add_argument("--data-path", default="/data/coco", help="dataset root")
    parser.add_argument("--dataset", default="coco",
                        choices=["coco", "voc", "synthetic"],
                        help="'synthetic' needs no data on disk "
                             "(demonet_tpu_torch/data/synthetic.py)")
    parser.add_argument("--synthetic-size", default=64, type=int,
                        help="images per split for --dataset synthetic")
    parser.add_argument("--num-workers", "-j", default=0, type=int,
                        help="loader worker processes (0 = prefetch thread"
                             " only; reference train.py -j)")
    parser.add_argument("--model", default="ssdlite320_mobilenet_v3_large")
    parser.add_argument("--num-classes", default=None, type=int,
                        help="default: 91 for coco, 21 for voc")
    parser.add_argument("--batch-size", "-b", default=16, type=int,
                        help="batch size")
    parser.add_argument("--epochs", default=26, type=int)
    parser.add_argument("--lr", default=0.02, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", "--wd", default=1e-4, type=float,
                        dest="weight_decay")
    parser.add_argument("--lr-steps", default=[16, 22], nargs="+", type=int)
    parser.add_argument("--lr-gamma", default=0.1, type=float)
    parser.add_argument("--warmup-iters", default=1000, type=int)
    parser.add_argument("--print-freq", default=20, type=int)
    parser.add_argument("--output-dir", default=".")
    parser.add_argument("--resume", default="", help="checkpoint path")
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("--data-augmentation", default="hflip",
                        choices=["hflip", "ssd"])
    parser.add_argument("--aspect-ratio-group-factor", default=-1, type=int,
                        help="k for 2^linspace(-1,1,2k+1) aspect bins; -1 off"
                             " (reference train.py:130-135)")
    parser.add_argument("--max-gt", default=100, type=int,
                        help="ground-truth padding per image")
    parser.add_argument("--trainable-backbone-layers", default=None, type=int,
                        help="stages to train from the top (0..6); None = all"
                             " (reference train.py flag semantics)")
    parser.add_argument("--lane-pack", dest="lane_pack", action="store_true",
                        help="the JAX package's lane-packed trunk layout; "
                             "not ported (raises)")
    parser.add_argument("--stem-s2d", dest="stem_s2d", action="store_true",
                        help="the JAX package's space-to-depth stem; not "
                             "ported (raises)")
    parser.add_argument("--postprocess", default="reference",
                        choices=["reference", "fused"],
                        help="eval postprocess: 'fused' = trained-model fast "
                             "path (chunk-gather select + one NMS/image)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute activations in the backward pass; "
                             "not ported yet (raises)")
    parser.add_argument("--steps-per-call", default=1, type=int,
                        help="optimizer steps per train-step call: K batches "
                             "are stacked and run as one call (metrics/"
                             "abort/checkpoint semantics unchanged)")
    parser.add_argument("--u8-transfer", dest="u8_transfer",
                        action="store_true",
                        help="ship images host->device as uint8 (1/4 the "
                             "bytes) and rescale to [0,1] on device; "
                             "quantizes augmented pixels to 8-bit")
    parser.add_argument("--score-thresh", default=None, type=float,
                        help="override the builder's postprocess score "
                             "threshold (a builder kwarg in the reference, "
                             "generalized_ssd.py:158)")
    parser.add_argument("--test-only", dest="test_only", action="store_true")
    parser.add_argument("--pretrained", action="store_true",
                        help="start from the published reference checkpoint "
                             "in the weights cache (utils/pretrained.py)")
    parser.add_argument("--torch-weights", default="",
                        help="a torch .pth checkpoint in the reference "
                             "state_dict layout")
    parser.add_argument("--npz-weights", default="",
                        help="flat .npz variables (the committed bench-asset "
                             "layout) to load as model weights — e.g. for "
                             "--test-only evaluation of a bench asset")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute; not ported yet (raises)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also write TensorBoard scalars (where the "
                             "tensorboard package imports)")
    parser.add_argument("--device", default="cuda",
                        help="the device to train and evaluate on: 'cuda' "
                             "(the default) or 'cpu'")
    return parser


_UNPORTED_FLAGS = (
    ("bf16", "--bf16", "ROADMAP Queue 1, item 7b"),
    ("remat", "--remat", "ROADMAP Queue 1, item 7b"),
    ("lane_pack", "--lane-pack", "a TPU layout knob, not ported on purpose"),
    ("stem_s2d", "--stem-s2d", "a TPU layout knob, not ported on purpose"),
)


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature is not ported."""
    for attr, flag, where in _UNPORTED_FLAGS:
        if getattr(args, attr, False):
            raise NotImplementedError(f"{flag} is not ported ({where})")


def build_datasets(args):
    from demonet_tpu_torch.data.presets import (
        DetectionPresetEval,
        DetectionPresetTrain,
    )

    train_tf = DetectionPresetTrain(args.data_augmentation)
    eval_tf = DetectionPresetEval()
    if args.dataset == "coco":
        from demonet_tpu_torch.data.coco import get_coco

        ds_train = get_coco(args.data_path, "train", train_tf)
        ds_val = get_coco(args.data_path, "val", eval_tf)
        num_classes = 91
    elif args.dataset == "synthetic":
        from demonet_tpu_torch.data.synthetic import SyntheticDetection

        num_classes = 7
        ds_train = SyntheticDetection(
            n=args.synthetic_size, num_classes=num_classes,
            seed=args.seed, transforms=train_tf)
        ds_val = SyntheticDetection(
            n=args.synthetic_size, num_classes=num_classes,
            seed=args.seed + 1, transforms=eval_tf)
    else:
        from demonet_tpu_torch.data.voc import VOCDetection

        ds_train = VOCDetection(args.data_path, "2007", "trainval", train_tf)
        ds_val = VOCDetection(args.data_path, "2007", "test", eval_tf)
        num_classes = 21
    return ds_train, ds_val, num_classes


def make_evaluator(args, ds_val):
    if args.dataset in ("coco", "synthetic"):
        from demonet_tpu_torch.data.coco_eval import CocoEvaluator

        return CocoEvaluator(ds_val.ground_truth_for_eval())
    from demonet_tpu_torch.data.voc_eval import VocEvaluator

    return VocEvaluator(ds_val)


def main(args):
    """Train (or, with --test-only, evaluate) as the flags say. Returns
    the evaluator of the last evaluation (its `stats` hold the summary),
    or None when no epoch ran."""
    check_ported(args)

    from demonet_tpu_torch.data.loader import DetectionLoader
    from demonet_tpu_torch.engine.evaluate import evaluate, make_predict_step
    from demonet_tpu_torch.engine.state import (
        create_train_state,
        make_lr_schedule,
        make_optimizer,
    )
    from demonet_tpu_torch.engine.train import (
        make_train_step,
        train_one_epoch,
    )
    from demonet_tpu_torch.models.builders import (
        DETECTORS,
        get_model,
        resolve_device,
    )
    from demonet_tpu_torch.parallel.dist import (
        is_main_process,
        process_count,
        process_index,
    )
    from demonet_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )

    if args.model not in DETECTORS:
        raise ValueError(f"--model {args.model!r} is not a detector; the "
                         f"train CLI trains {', '.join(DETECTORS)}")
    print(args)
    # `cuda` with no GPU raises, rather than falling back to the CPU
    device = resolve_device(None if args.device == "cuda" else args.device)

    ds_train, ds_val, default_classes = build_datasets(args)
    num_classes = args.num_classes or default_classes

    model_kw = dict(num_classes=num_classes, device=device, seed=args.seed)
    if getattr(args, "score_thresh", None) is not None:
        model_kw["score_thresh"] = args.score_thresh
    detector = get_model(args.model, **model_kw)
    size = detector.config.size

    loader_kw = dict(
        image_size=size, max_gt=args.max_gt, seed=args.seed,
        num_workers=args.num_workers,
        num_shards=process_count(), shard_index=process_index(),
        image_dtype="uint8" if getattr(args, "u8_transfer", False)
        else "float32")
    batch_sampler = None
    if args.aspect_ratio_group_factor >= 0:
        from demonet_tpu_torch.data.group_by_aspect_ratio import (
            GroupedBatchSampler, create_aspect_ratio_groups)

        group_ids = create_aspect_ratio_groups(
            ds_train, k=args.aspect_ratio_group_factor)
        batch_sampler = GroupedBatchSampler(
            group_ids, args.batch_size, seed=args.seed)
    train_loader = DetectionLoader(
        ds_train, args.batch_size, shuffle=True, drop_last=True,
        batch_sampler=batch_sampler, **loader_kw)
    val_loader = DetectionLoader(ds_val, args.batch_size, **loader_kw)

    steps_per_epoch = len(train_loader)
    schedule = make_lr_schedule(
        args.lr, steps_per_epoch, args.lr_steps, args.lr_gamma,
        args.warmup_iters)
    tx = make_optimizer(schedule, args.momentum, args.weight_decay)
    if args.trainable_backbone_layers is not None:
        from demonet_tpu_torch.utils.freeze import (
            masked_optimizer, mobilenet_trainable_mask)

        mask = mobilenet_trainable_mask(
            detector.model, args.trainable_backbone_layers)
        tx = masked_optimizer(tx, mask)
    if args.pretrained or args.torch_weights:
        from demonet_tpu_torch.utils.pretrained import load_pretrained

        load_pretrained(detector.model, args.model,
                        path=args.torch_weights or None)
        print(f"loaded pretrained weights for {args.model}")
    if getattr(args, "npz_weights", ""):
        from demonet_tpu_torch.utils.checkpoints import load_npz_variables
        from demonet_tpu_torch.utils.weights import load_jax_variables

        load_jax_variables(detector.model,
                           load_npz_variables(args.npz_weights))
        print(f"loaded npz weights from {args.npz_weights}")
    state = create_train_state(detector, tx)

    start_epoch = args.start_epoch
    if args.resume:
        state, epoch, _ = load_checkpoint(args.resume, state)
        start_epoch = epoch + 1
        print(f"resumed from {args.resume} at epoch {start_epoch}")

    train_step = make_train_step(detector)
    spc = max(1, getattr(args, "steps_per_call", 1))
    multi_step = make_train_step(
        detector, steps_per_call=spc) if spc > 1 else None
    predict_step = make_predict_step(
        detector, impl=getattr(args, "postprocess", "reference"))

    if args.test_only:
        return evaluate(predict_step, state, val_loader,
                        make_evaluator(args, ds_val))

    from demonet_tpu_torch.utils.metrics_writer import MetricsWriter

    writer = MetricsWriter(args.output_dir or ".",
                           tensorboard=args.tensorboard)
    if args.tensorboard:
        print("tensorboard scalars: " + (
            "on" if writer.tensorboard else
            "off (the tensorboard package does not import); metrics.jsonl "
            "only"))
    print("Start training")
    start = time.time()
    evaluator = None
    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        state = train_one_epoch(
            train_step, state, train_loader, epoch,
            print_freq=args.print_freq, lr_schedule=schedule,
            metrics_writer=writer, multi_step=multi_step,
            steps_per_call=spc)
        if args.output_dir:
            save_checkpoint(args.output_dir, state, epoch,
                            metadata={"args": vars(args)})
        evaluator = evaluate(predict_step, state, val_loader,
                             make_evaluator(args, ds_val))

    total = time.time() - start
    if is_main_process():
        print(f"Training time {total / 3600:.2f}h")
    return evaluator


if __name__ == "__main__":
    main(get_args_parser().parse_args())
