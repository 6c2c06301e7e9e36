"""The benchmark of demonet_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. A cell of BENCHMARK.json names a model
configuration and a traffic mix; the run makes its weights and frames
from the seed, warms up on the cell's own shapes (set-up), measures for
`--seconds`, then compares what the timed path produced with the plain
reference in `portbench/reference/`. The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and last `checks`, each compared number
beside its limit; the same numbers end standard error.

Exits 3 without a result when no CUDA device (or fewer than the cell
asks for) is there, and 4 when the process has loaded JAX or the JAX
package. Build and kernel caches stay under the checkout: the program's
kernels in demonet_tpu_torch/_build/, Triton's and torch's under
.portbench_cache/.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(_CACHE, sub)
sys.path[:0] = [HERE, ROOT]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import isolation, manifest, runner

    bench = manifest.load_benchmark(ROOT)
    chips = manifest.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = runner.run(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), T0)
    print(json.dumps(out["info"]), flush=True)
    found = isolation.forbidden_modules()
    if found:
        print(f"portbench: the run loaded forbidden modules: {found}",
              file=sys.stderr)
        return 4
    for k, (value, limit) in out["checks"].items():
        print(f"check {k} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
