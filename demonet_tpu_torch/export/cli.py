"""Export CLI (counterpart of demonet_tpu/export/cli.py).

    python -m demonet_tpu_torch.export.cli \
        --model ssdlite320_mobilenet_v3_large --batch-size 1 \
        --checkpoint out/checkpoint_25 --output model.pt2
    python -m demonet_tpu_torch.export.cli --num-classes 91 --npz-weights \
        bench_assets/ssdlite320_shapes_trained.npz --output m.pt2 --device cpu

Writes the `torch.export` program of preprocess -> model -> postprocess
(`export/program.py`), the weights in it; reload it with
`demonet_tpu_torch.export.load_exported(path)` (which registers the
kernels' custom ops first) and run `.module()(images)`.

The flags are the JAX CLI's, plus `--device` (`cuda` by default; with no
GPU it raises unless asked for `cpu`): the program runs on the device it
was exported on, the hand-written kernels inside it on the card. Not
ported: `--format caffe`, `--generic` and `--verify` (the Caffe export,
ROADMAP item 11b) and `--mlir` (StableHLO text for the C++ PJRT runner,
item 11c); `--platforms` is `--device` here. Each raises, saying so.
"""

from __future__ import annotations

import argparse

_NOT_PORTED = "not ported yet: ROADMAP item {}"


def get_args_parser(add_help: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="demonet_tpu_torch export",
                                add_help=add_help)
    p.add_argument("--model", default="ssdlite320_mobilenet_v3_large")
    p.add_argument("--num-classes", default=91, type=int)
    p.add_argument("--batch-size", default=1, type=int,
                   help="the program's static batch size")
    p.add_argument("--checkpoint", default="",
                   help="a checkpoint_<epoch> directory of the train CLI")
    p.add_argument("--torch-weights", default="",
                   help="a torch .pth in the reference's state_dict layout")
    p.add_argument("--npz-weights", default="",
                   help="flat .npz variables (the committed bench-asset "
                        "format: keys 'params/...', 'batch_stats/...')")
    p.add_argument("--format", default="pt2", choices=["pt2", "caffe"],
                   help="pt2 = a torch.export program; caffe raises ("
                        + _NOT_PORTED.format("11b") + ")")
    p.add_argument("--generic", action="store_true",
                   help="raises: a flag of the Caffe export ("
                        + _NOT_PORTED.format("11b") + ")")
    p.add_argument("--verify", action="store_true",
                   help="raises: a flag of the Caffe export ("
                        + _NOT_PORTED.format("11b") + ")")
    p.add_argument("--output", default="model.pt2")
    p.add_argument("--mlir", default="",
                   help="raises: StableHLO text for the C++ PJRT runner ("
                        + _NOT_PORTED.format("11c") + ")")
    p.add_argument("--platforms", default="",
                   help="raises: the program runs where it was exported; "
                        "use --device")
    p.add_argument("--postprocess", default="reference",
                   choices=["reference", "fused"],
                   help="'fused' puts the trained-model fast postprocess in "
                        "the program, its branch (a tier or the exact "
                        "fallback) chosen on the device by torch.cond")
    p.add_argument("--raw-outputs", action="store_true",
                   help="export the trunk and heads only (no decode/NMS)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the exported program")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu': where the program "
                        "is traced and runs")
    return p


def _refuse_unported(args) -> None:
    if args.format == "caffe" or args.generic or args.verify:
        raise NotImplementedError(
            "--format caffe, --generic and --verify: the Caffe export is "
            + _NOT_PORTED.format("11b"))
    if args.mlir:
        raise NotImplementedError(
            "--mlir: StableHLO text for the C++ PJRT runner is "
            + _NOT_PORTED.format("11c"))
    if args.platforms:
        raise ValueError("--platforms: a torch.export program runs on the "
                         "device it was exported on; pass --device cuda or "
                         "--device cpu")


def main(args):
    """Build the model, load its weights, export and save the program;
    returns the `torch.export.ExportedProgram`."""
    _refuse_unported(args)

    import torch

    from demonet_tpu_torch.export.program import (
        export_detector,
        save_exported,
    )
    from demonet_tpu_torch.models.builders import get_model, resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    detector = get_model(
        args.model, num_classes=args.num_classes, device=device,
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    module = getattr(detector, "model", detector)
    if args.torch_weights:
        from demonet_tpu_torch.utils.pretrained import load_pretrained

        load_pretrained(module, args.model, path=args.torch_weights)
        print(f"loaded torch weights from {args.torch_weights}")
    elif args.checkpoint:
        from demonet_tpu_torch.utils.checkpoints import load_variables

        module.load_state_dict(load_variables(args.checkpoint))
        print(f"loaded checkpoint {args.checkpoint}")
    elif args.npz_weights:
        from demonet_tpu_torch.utils.checkpoints import load_npz_variables
        from demonet_tpu_torch.utils.weights import load_jax_variables

        load_jax_variables(module, load_npz_variables(args.npz_weights))
        print(f"loaded npz weights from {args.npz_weights}")

    exported = export_detector(
        detector, batch_size=args.batch_size,
        with_postprocess=not args.raw_outputs,
        postprocess_impl=args.postprocess)
    save_exported(exported, args.output)
    print(f"wrote {args.output}")
    return exported


if __name__ == "__main__":
    main(get_args_parser().parse_args())
