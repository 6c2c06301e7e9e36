"""Readings for the limits of `correct`: the program's sound runs, the
lower-precision control and the planted faults, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out FILE]

For each of `--seeds` it runs the cell as the benchmark does (set-up,
the shortest window that holds one request of each pool batch, or the
checked train step, then the comparison) and prints the numbers;
`--program-dtype float32` runs the program's side in float32 instead
of the cell's dtype (and checks the window's first train step). For each of `--control-seeds` it puts the reference,
computed in the next precision below the cell's (`control` in the
workload file: "tf32" below float32, "fp8" below bfloat16), in the
program's place and prints the numbers it reads; for a train cell also
the program's own numbers, and in its place the planted faults (half of
each batch left out; the loss over half of the rows; a state left
unchanged) and the reference with its convs in bf16 (operands, and
operands and outputs), witnesses beside the program's readings. One JSON line each, to standard output and to
`--out`. Needs a CUDA device, as the benchmark.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def serve_control(cell: dict, seed: int, device) -> dict:
    """The reference in the control's precision in the program's place:
    its heads and detections against the float32 reference's."""
    import torch

    from harness import frames, program, serve
    from reference import nets
    from reference import postprocess as ref_post

    cfg, traffic = cell["config"], cell["traffic"]
    state = program.reference_state(cell, seed, device)
    size, b = cfg["size"][0], traffic["batch"]
    pool = frames.shapes(seed, b * traffic["pool"], size, traffic["max_gt"],
                         device)["images"].view(traffic["pool"], b, size,
                                                size, 3)
    net, anchors = program.reference(cell, state, device)
    captured = []
    for i in range(traffic["pool"]):
        heads = serve.reference_heads(nets.set_precision(net, cell["control"]),
                                      pool[i], cfg, device,
                                      traffic["reference_rows"])
        with torch.no_grad():
            dets = ref_post.detections(heads["cls_logits"],
                                       heads["bbox_regression"], anchors, cfg)
        captured.append((i, heads, dets))
    nets.set_precision(net, "fp32")
    return serve.compare(net, anchors, cfg, pool, captured, device,
                         traffic["reference_rows"])


def train_control(cell: dict, seed: int, device) -> dict:
    """The program's sound run, then in its place the reference in the
    control's precision and the planted faults, each against the float32
    reference, over both checked stretches (`harness/train.py`):
    {'program', 'control', 'half_batch' (the step over the first half of
    each batch), 'half_loss' (a full forward, the loss over the first half
    of the rows, its mean over them), 'state_unchanged', 'bf16_reference'
    (the convs' operands rounded to bfloat16: a witness of what that
    precision alone moves), 'bf16_out_reference' (their outputs too, so
    that the loss ranks bfloat16 head outputs)}: numbers each."""
    import torch

    from harness import runner, train

    t = train.Train(cell, seed, device, trace=False)
    t.window(runner.Run(cell, False), 0.0)
    got = {"": t.got(t.first), "win_": t.got(t.win)}
    start, step, state, pool = t.win["start"], t.win["step"], t.state, t.pool
    del t
    torch.cuda.empty_cache()
    h = cell["traffic"]["batch"] // 2

    def stretches(**kw):
        return {"": train.reference_steps(cell, state, pool, device, **kw),
                "win_": train.reference_step(cell, start, pool, step, device,
                                             **kw)}

    def numbers(side):
        return {p + k: v for p in want
                for k, v in train.compare(side[p], want[p]).items()}

    want = stretches()
    out = {"program": numbers(got)}
    for name, kw in (("control", dict(precision=cell["control"])),
                     ("half_batch", dict(rows=h)),
                     ("half_loss", dict(loss_rows=h)),
                     ("bf16_reference", dict(precision="bf16")),
                     ("bf16_out_reference", dict(precision="bf16_out"))):
        out[name] = numbers(stretches(**kw))
    out["state_unchanged"] = numbers({p: train.unchanged(w)
                                      for p, w in want.items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--program-dtype", help="run the program's side in this "
                   "compute dtype in place of the cell's, with the window's "
                   "first step checked (a look at what the cell's own "
                   "precision moves)")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from harness import manifest, program, runner

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    bench = manifest.load_benchmark(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(obj):
        line = json.dumps(dict(obj, t_s=time.perf_counter() - T0))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def tweak(cell):
        if args.program_dtype:
            cell["dtype"] = args.program_dtype
            if "window_check_span" in cell["traffic"]:
                cell["traffic"]["window_check_span"] = 1

    for seed in seeds:
        out = runner.run(bench, args.workload, seed, 0.0, False,
                         time.perf_counter(), tweak=tweak)
        emit({"side": "program", "seed": seed, "dtype": out["info"]["dtype"],
              "numbers": out["info"]["numbers"],
              "card": out["info"]["card"]})
        del out
        gc.collect()
        torch.cuda.empty_cache()
    cell = manifest.cell(bench, args.workload)
    program.set_fp32_exact()
    for seed in controls:
        if cell["traffic"]["entry"] == "serve":
            emit({"side": "control", "precision": cell["control"],
                  "seed": seed, "numbers": serve_control(cell, seed, "cuda")})
        else:
            for name, numbers in train_control(cell, seed, "cuda").items():
                emit({"side": name, "seed": seed, "numbers": numbers})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
