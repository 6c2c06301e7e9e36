"""Export CLI (counterpart of demonet_tpu/export/cli.py).

    python -m demonet_tpu_torch.export.cli \
        --model ssdlite320_mobilenet_v3_large --batch-size 1 \
        --checkpoint out/checkpoint_25 --output model.pt2
    python -m demonet_tpu_torch.export.cli --num-classes 91 --npz-weights \
        bench_assets/ssdlite320_shapes_trained.npz --output m.pt2 --device cpu
    python -m demonet_tpu_torch.export.cli --model pelee304 --format caffe \
        --output deploy   # writes deploy.prototxt + deploy.caffemodel
    python -m demonet_tpu_torch.export.cli --num-classes 91 --npz-weights \
        bench_assets/ssdlite320_shapes_trained.npz --output m.pt2 \
        --aoti m_aoti.pt2   # also the C++ runner's package

The default format writes the `torch.export` program of preprocess ->
model -> postprocess (`export/program.py`), the weights in it; reload it
with `demonet_tpu_torch.export.load_exported(path)` (which registers the
kernels' custom ops first) and run `.module()(images)`.

`--format caffe` writes `<prefix>.prototxt` and `<prefix>.caffemodel`
(the output less a `.pt2`, `.stablehlo.bin` or `.bin` suffix): the
family's hand-built graph (`export/caffe.py`), or with `--generic` the
graph `export/tracing.py` reads off the model's `torch.export` program,
for any model; `--verify` then runs that graph with
`export/caffe_eval.py` on the device and holds it to the model's forward
there (rtol 5e-3, atol 1e-4) before writing. The Caffe graph holds the
raw heads (decode and NMS belong to the SSD fork's DetectionOutput).
With `--bf16` the model computes in bf16; the hand-built graph writes its
float32 parameters, as the JAX CLI writes its float32 variables.

`--aoti PATH` also writes the C++ runner's artifact (the JAX CLI's
`--mlir`): an AOTInductor package of the same program, compiled for the
device (`export/aoti.py::package_detector`), which `csrc/aoti_runner.cc`
runs with no Python; with `--raw-outputs` it holds the heads only.

The flags are the JAX CLI's, plus `--device` (`cuda` by default; with no
GPU it raises unless asked for `cpu`): the program runs on the device it
was exported on, the hand-written kernels inside it on the card.
`--mlir` (StableHLO text for the PJRT runner) is `--aoti` here and
`--platforms` is `--device`: both raise, naming their replacement.
"""

from __future__ import annotations

import argparse


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
                   help="pt2 = a torch.export program; caffe = prototxt + "
                        "caffemodel (export/caffe.py)")
    p.add_argument("--generic", action="store_true",
                   help="with --format caffe: convert by walking the "
                        "model's torch.export graph (export/tracing.py) "
                        "instead of the hand-built family graph; any model "
                        "built from supported operations")
    p.add_argument("--verify", action="store_true",
                   help="with --format caffe --generic: run the emitted "
                        "graph (export/caffe_eval.py) on a seeded input on "
                        "--device and assert it matches the model's "
                        "forward before writing the files")
    p.add_argument("--output", default="model.pt2")
    p.add_argument("--aoti", default="",
                   help="also write the C++ runner's artifact here: an "
                        "AOTInductor package of the program for --device "
                        "(export/aoti.py; run by csrc/aoti_runner.cc)")
    p.add_argument("--mlir", default="",
                   help="raises: the PJRT runner's StableHLO text is the "
                        "C++ runner's package here; use --aoti")
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
    if args.mlir:
        raise ValueError("--mlir: the C++ runner takes an AOTInductor "
                         "package, not StableHLO text; pass --aoti PATH")
    if args.aoti and args.format == "caffe":
        raise ValueError("--aoti packages the torch.export program; it "
                         "does not go with --format caffe")
    if args.platforms:
        raise ValueError("--platforms: a torch.export program runs on the "
                         "device it was exported on; pass --device cuda or "
                         "--device cpu")


def main(args):
    """Build the model, load its weights, export and save the program;
    returns the `torch.export.ExportedProgram`, or with --format caffe
    the `CaffeNet` written."""
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

    if args.format == "caffe":
        return _export_caffe(args, detector, module, device)
    exported = export_detector(
        detector, batch_size=args.batch_size,
        with_postprocess=not args.raw_outputs,
        postprocess_impl=args.postprocess)
    save_exported(exported, args.output)
    print(f"wrote {args.output}")
    if args.aoti:
        from demonet_tpu_torch.export.aoti import package_exported

        package_exported(exported, args.aoti)
        print(f"wrote {args.aoti}")
    return exported


def _export_caffe(args, detector, module, device):
    import numpy as np
    import torch

    from demonet_tpu_torch.export.caffe import export_caffe, write_caffe

    prefix = args.output
    for suffix in (".pt2", ".stablehlo.bin", ".bin"):
        if prefix.endswith(suffix):
            prefix = prefix[: -len(suffix)]
    files = (f"{prefix}.prototxt", f"{prefix}.caffemodel")
    if not args.generic:
        net = export_caffe(args.model, module, *files,
                           num_classes=args.num_classes)
        print(f"wrote {files[0]} + {files[1]}")
        return net

    from demonet_tpu_torch.export.caffe_eval import no_tf32, run_caffenet
    from demonet_tpu_torch.export.tracing import output_list, trace_to_caffe

    h, w = detector.config.size if hasattr(detector, "config") else (224, 224)
    net = trace_to_caffe(module, torch.zeros((1, h, w, 3), device=device),
                         name=args.model)
    if args.verify:
        x = (np.random.default_rng(0).random((1, h, w, 3), np.float32)
             * 2.0 - 0.5)
        with torch.no_grad(), no_tf32():
            want = output_list(module.eval()(torch.from_numpy(x).to(device)))
        blobs = run_caffenet(net, {"data": np.transpose(x, (0, 3, 1, 2))},
                             device=device)
        for top, ref in zip(net.output_tops, want):
            np.testing.assert_allclose(
                blobs[top].float().cpu().numpy(),
                ref.float().cpu().numpy(), rtol=5e-3, atol=1e-4,
                err_msg=top)
        print("generic conversion verified numerically against the "
              f"model's forward on {device} ({len(net.output_tops)} "
              "outputs)")
    write_caffe(net, *files)
    print(f"wrote {files[0]} + {files[1]}")
    return net


if __name__ == "__main__":
    main(get_args_parser().parse_args())
