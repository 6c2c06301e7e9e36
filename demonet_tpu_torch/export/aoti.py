"""Deploy without Python: an AOTInductor package of the detector, run by a
C++ program (counterpart of cpp/pjrt_runner.cc and
tools/check_pjrt_parity.py).

  * `package_detector` compiles `export_detector`'s program ahead of time
    with `torch._inductor.aoti_compile_and_package` into one `.pt2` file:
    preprocess, trunk, heads and postprocess, the weights inside. Inductor
    compiles the graph for the detector's device (C++ on the CPU, Triton
    kernels and cuDNN calls on the card); K1 and K2 stay calls of the ops
    `demonet_tpu_torch::nms_keep_batch` and `::gather_rows_batch`, which
    the package looks up by name when it runs.
  * `build_runner` builds, with g++ against the libtorch inside the torch
    wheel, `csrc/aoti_runner.cc` (the C++ runner) and `csrc/aoti_ops.cc`
    (K1 and K2 registered from C++, linked on the card to the libraries
    `ops/_build.py` builds from csrc/nms.cu and csrc/gather.cu). A process
    with no Python cannot call the Python ops of `ops/library.py`; the
    runner loads this library first. Never load the ops library into a
    Python process that has imported `demonet_tpu_torch.ops`: the two
    definitions of the namespace clash.
  * `run_runner` runs the runner on a package and reads what it prints;
    `check_parity` calls the same package in Python on the same input and
    holds the runner's dumped outputs to it, bit for bit.

From the command line, as tools/check_pjrt_parity.py runs the JAX one:

    python -m demonet_tpu_torch.export.cli --num-classes 91 --npz-weights \\
        bench_assets/ssdlite320_shapes_trained.npz --output m.pt2 \\
        --aoti m_aoti.pt2
    python -m demonet_tpu_torch.export.aoti m_aoti.pt2 out --make-input
    <runner> m_aoti.pt2 1x320x320x3 50 ops=<ops library> \\
        input_file=out.input.bin dump_out=out
    python -m demonet_tpu_torch.export.aoti m_aoti.pt2 out

(`python -c "from demonet_tpu_torch.export.aoti import build_runner;
print(build_runner())"` builds and prints the runner and the ops library;
`--real-frames` takes the input from bench_assets/val_images_320.npz.)

Libraries and the runner go to `demonet_tpu_torch/_build/` under a hash of
the sources and the flags, built at first use, each written to a temporary
name and renamed, so concurrent builders never see half a file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import hashlib
import io
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from demonet_tpu_torch.export.program import export_detector
from demonet_tpu_torch.models.detection import Detector
from demonet_tpu_torch.ops import _build

CSRC_DIR = _build.CSRC_DIR
BUILD_DIR = _build.BUILD_DIR
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")
# the input shape, NxHxWxC, in the package's metadata
SHAPE_KEY = "demonet_input_shape"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VAL_FRAMES = os.path.join(_REPO, "bench_assets", "val_images_320.npz")


def package_detector(detector: Detector, path: str, batch_size: int = 1,
                     with_postprocess: bool = True,
                     postprocess_impl: str = "reference") -> str:
    """Compile the detector's inference program into an AOTInductor
    package at `path`, for the detector's device (the card by default, as
    the builders put it there). Arguments as `export_detector`; the package
    takes float32 (batch_size, H, W, 3) images in [0, 1] and returns what
    the program returns, flattened: boxes, scores, labels, valid (or
    cls_logits, bbox_regression). Returns `path`."""
    return package_exported(
        export_detector(detector, batch_size=batch_size,
                        with_postprocess=with_postprocess,
                        postprocess_impl=postprocess_impl), path)


def package_exported(exported: torch.export.ExportedProgram,
                     path: str) -> str:
    """`package_detector` from `export_detector`'s program."""
    image = next(n for n in exported.graph.nodes if n.op == "placeholder"
                 and n.name in exported.graph_signature.user_inputs
                 ).meta["val"]
    # export_detector drops its example input (its size); AOTInductor
    # needs one, of the program's input shape
    exported.example_inputs = ((torch.zeros(image.shape,
                                            device=image.device),), {})
    return torch._inductor.aoti_compile_and_package(
        exported, package_path=path, inductor_configs={
            "aot_inductor.metadata": {
                SHAPE_KEY: "x".join(str(d) for d in image.shape)}})


def compiler() -> str:
    """The C++ compiler of the runner's build: $CXX, else the g++ on
    PATH, as Inductor picks the compiler of a package. A package links with
    -fopenmp, so a $CXX that names a g++ without OpenMP's link spec
    (libgomp.spec) fails to package: name another in CXX."""
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("no $CXX and no g++ on PATH: the C++ runner is "
                           "compiled with g++")
    return found


def load_package(path: str):
    """The package loaded in this process (`aoti_load_package`); its K1
    and K2 calls go to the Python ops of `ops/library.py`."""
    return torch._inductor.aoti_load_package(path)


def input_shape(package) -> Tuple[int, ...]:
    """A loaded package's input shape (N, H, W, C)."""
    return tuple(int(d) for d in package.get_metadata()[SHAPE_KEY].split("x"))


def package_device(package) -> str:
    """"cpu" or "cuda": where a loaded package runs."""
    return package.get_metadata()["AOTI_DEVICE_KEY"]


@contextlib.contextmanager
def runner_numerics() -> Iterator[None]:
    """The runner's cuDNN settings in this process: TF32 off, the
    deterministic algorithms, no benchmark search. The runner and a Python
    call of the same package then run the same convolutions."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         cudnn.deterministic, cudnn.benchmark) = saved


# -- building the runner and the ops library ----------------------------------

@dataclasses.dataclass(frozen=True)
class Runner:
    """The built runner and ops library for one device."""
    runner: str
    ops: str
    device: str


def _nvidia_lib_dirs() -> List[str]:
    """The torch wheel's CUDA libraries (`nvidia/*/lib` beside torch)."""
    site = os.path.dirname(os.path.dirname(torch.__file__))
    return sorted(glob.glob(os.path.join(site, "nvidia", "*", "lib")))


def _cuda_home() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return CUDA_HOME or os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _commands(device: str, out: Dict[str, str]) -> Dict[str, List[str]]:
    """g++ command lines of the ops library and the runner, less their
    output paths."""
    from torch.utils import cpp_extension

    cxx = compiler()
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"
    inc = [f"-I{d}" for d in cpp_extension.include_paths()]
    lib_dirs = list(cpp_extension.library_paths())
    # every library stays a dependency, named or not: libtorch_cuda holds
    # the runtime's CUDA registrations, and a package's own library asks
    # for libtorch.so by name without a path to it
    libs = ["-lc10", "-ltorch_cpu", "-ltorch"]
    defines = []
    if device == "cuda":
        inc.append(f"-I{os.path.join(_cuda_home(), 'include')}")
        lib_dirs += _nvidia_lib_dirs()
        libs += ["-ltorch_cuda", "-lc10_cuda"]
        defines.append("-DDEMONET_WITH_CUDA")
    libs = ["-Wl,--no-as-needed", *libs, "-Wl,--as-needed"]
    link = ([f"-L{d}" for d in lib_dirs]
            + [f"-Wl,-rpath,{d}" for d in lib_dirs]
            + [f"-Wl,-rpath-link,{d}" for d in lib_dirs])
    ops_libs = []
    if device == "cuda":
        # K1 and K2: the libraries of csrc/nms.cu and csrc/gather.cu
        ops_libs = [f"-L{BUILD_DIR}", f"-Wl,-rpath,{BUILD_DIR}"] + [
            f"-l:{os.path.basename(out[name])}" for name in ("nms", "gather")]
    return {
        "aoti_ops": [cxx, *CXX_FLAGS, abi, *defines, *inc, "-shared",
                     os.path.join(CSRC_DIR, "aoti_ops.cc"), *ops_libs,
                     *link, *libs],
        "aoti_runner": [cxx, *CXX_FLAGS, abi, *inc,
                        os.path.join(CSRC_DIR, "aoti_runner.cc"), *link,
                        *libs, "-ldl"],
    }


def _output(name: str, device: str, cmd: List[str]) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cc"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(cmd).encode()
                                + torch.__version__.encode())
    suffix = ".so" if name == "aoti_ops" else ""
    return os.path.join(BUILD_DIR,
                        f"{name}-{device}-{digest.hexdigest()[:16]}{suffix}")


def build_runner(device: str = "cuda") -> Runner:
    """Build (or find) the runner and the ops library for `device`
    ("cuda", or "cpu" for a host with no GPU). On "cuda" the K1 and K2
    libraries are built first (nvcc) and linked. The two g++ runs go
    together. Raises RuntimeError with the compiler's output if one
    fails."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"build_runner: device 'cpu' or 'cuda', got "
                         f"{device!r}")
    kernels = ({name: _build.build(name) for name in ("nms", "gather")}
               if device == "cuda" else {})
    cmds = _commands(device, kernels)
    outs = {name: _output(name, device, cmd) for name, cmd in cmds.items()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, cmd in cmds.items():
        if os.path.exists(outs[name]):
            continue
        tmp = f"{outs[name]}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [*cmd, "-o", tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp)
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {name} for {device} "
                               f"(rc={proc.returncode}):\n{log}")
        os.replace(tmp, outs[name])   # atomic, as ops/_build.py's
    return Runner(outs["aoti_runner"], outs["aoti_ops"], device)


# -- running it ---------------------------------------------------------------

@dataclasses.dataclass
class RunnerResult:
    """What the runner printed, read."""
    returncode: int
    stdout: str
    stderr: str
    device: Optional[str]
    outputs: List[Tuple[Tuple[int, ...], str]]   # (shape, dtype name)
    ms: Dict[str, float]                          # best, p50, mean
    iters: int
    launches: Dict[str, int]                      # per call, by counter
    calls: int                                    # warm-up included


def _parse(proc: subprocess.CompletedProcess) -> RunnerResult:
    out = proc.stdout
    dev = re.search(r"^device: (\S+)$", out, re.M)
    outputs = [(tuple(int(d) for d in shape.split("x")) if shape != "scalar"
                else (), dtype)
               for shape, dtype in re.findall(
                   r"^output\[\d+\]: shape (\S+) dtype (\S+)", out, re.M)]
    ran = re.search(r"^ran (\d+) iters: best ([\d.]+) ms, p50 ([\d.]+) ms, "
                    r"mean ([\d.]+) ms$", out, re.M)
    lines = re.search(r"^launches per call \(\w+\):(.*)$", out, re.M)
    launches = ({k: int(v) for k, v in re.findall(r"(\S+)=(\d+)",
                                                   lines.group(1))}
                if lines else {})
    calls = re.search(r"^calls: (\d+)$", out, re.M)
    return RunnerResult(
        proc.returncode, out, proc.stderr, dev.group(1) if dev else None,
        outputs, {k: float(ran.group(i)) for i, k in enumerate(
            ("best", "p50", "mean"), 2)} if ran else {},
        int(ran.group(1)) if ran else 0, launches,
        int(calls.group(1)) if calls else 0)


def run_runner(runner: Runner, package: str, shape, iters: int = 10,
               ops: bool = True, input_file: Optional[str] = None,
               dump_out: Optional[str] = None, check: bool = True,
               threads: Optional[int] = None) -> RunnerResult:
    """Run the built runner on `package` at input shape (N, H, W, C), in a
    process of its own, and read what it printed. `ops=False` leaves the
    ops library out (a package holding K1 or K2 then cannot run).
    `check` raises RuntimeError with the runner's output on a nonzero exit.
    On the CPU the runner runs `threads` threads (default: this process's
    count): its convolutions round as a call here with as many threads
    does, and differently with another count."""
    cmd = [runner.runner, package, "x".join(str(d) for d in shape),
           str(iters)]
    if ops:
        cmd.append(f"ops={runner.ops}")
    if input_file is not None:
        cmd.append(f"input_file={input_file}")
    if dump_out is not None:
        cmd.append(f"dump_out={dump_out}")
    env = dict(os.environ,
               OMP_NUM_THREADS=str(threads or torch.get_num_threads()))
    result = _parse(subprocess.run(cmd, capture_output=True, text=True,
                                   env=env, timeout=600))
    if check and result.returncode != 0:
        raise RuntimeError(
            f"aoti_runner exited {result.returncode}:\n{result.stdout}\n"
            f"{result.stderr}")
    return result


def read_dumps(dump_prefix: str, like: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    """The runner's dumped outputs, read with the dtypes and shapes of
    `like` (the Python call's flattened outputs)."""
    out = []
    for i, ref in enumerate(like):
        raw = np.fromfile(f"{dump_prefix}.{i}.bin", dtype=np.uint8)
        want = ref.numel() * ref.element_size()
        if raw.size != want:
            raise AssertionError(f"{dump_prefix}.{i}.bin has {raw.size} "
                                 f"bytes, output {i} has {want}")
        out.append(torch.from_numpy(raw.copy()).view(ref.dtype)
                   .reshape(ref.shape))
    return out


def check_parity(package: str, dump_prefix: str, x) -> List[float]:
    """Hold the runner's dumps of `package` to the Python call of the same
    package on the same input `x` ((N, H, W, 3) float32, numpy or tensor),
    under `runner_numerics()`. Prints and returns each output's max |diff|;
    raises AssertionError unless every output is bit-equal."""
    from torch.utils._pytree import tree_leaves

    compiled = load_package(package)
    x = (x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))).to(package_device(compiled), torch.float32)
    with runner_numerics(), torch.no_grad():
        leaves = [t.cpu().contiguous() for t in tree_leaves(compiled(x))]
    dumps = read_dumps(dump_prefix, leaves)
    diffs, bad = [], []
    for i, (got, want) in enumerate(zip(dumps, leaves)):
        diff = (float((got.double() - want.double()).abs().max())
                if want.numel() else 0.0)
        same = torch.equal(got, want)
        print(f"output[{i}] {dump_prefix}.{i}.bin: shape="
              f"{tuple(want.shape)} dtype={want.dtype} max|diff|={diff:.3e} "
              f"-> {'OK' if same else 'MISMATCH'}")
        diffs.append(diff)
        if not same:
            bad.append(i)
    if bad:
        raise AssertionError(f"runner outputs {bad} differ from the Python "
                             f"call of {package}")
    print("PARITY OK: the C++ runner's outputs equal the Python call's")
    return diffs


def load_val_frames(n: int) -> np.ndarray:
    """The first `n` real 320x320 frames of the bench asset (JPEG bytes),
    (n, 320, 320, 3) float32 in [0, 1], repeated if n is larger, as
    tools/export_bench_images.py decodes them."""
    from PIL import Image

    with np.load(VAL_FRAMES, allow_pickle=False) as z:
        blobs = [z[k] for k in sorted(z.files)]
    frames = np.stack([
        np.asarray(Image.open(io.BytesIO(b.tobytes())).convert("RGB"),
                   np.float32) / 255.0 for b in blobs[:n]])
    return np.tile(frames, (-(-n // len(frames)), 1, 1, 1))[:n]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="write the C++ runner's input, or check its dumped "
                    "outputs against the Python call of the same package")
    p.add_argument("package", help="an AOTInductor package (--aoti)")
    p.add_argument("dump_prefix", help="the runner's dump_out=")
    p.add_argument("input", nargs="?", default=None,
                   help="raw float32 input (default <dump_prefix>.input.bin)")
    p.add_argument("--make-input", action="store_true",
                   help="write the input and stop")
    p.add_argument("--real-frames", action="store_true",
                   help="real frames of bench_assets/val_images_320.npz "
                        "(sparse scores under trained weights, so a fused "
                        "package takes a tier); default uniform noise from "
                        "numpy default_rng(0)")
    args = p.parse_args(argv)
    input_path = args.input or f"{args.dump_prefix}.input.bin"
    shape = input_shape(load_package(args.package))
    if args.real_frames:
        x = np.ascontiguousarray(load_val_frames(shape[0]))
        assert x.shape == shape, (x.shape, shape)
    else:
        # zeros would tie every score and leave the box order to the sort
        x = np.random.default_rng(0).random(shape).astype(np.float32)
    x.tofile(input_path)
    if args.make_input:
        print(f"wrote {input_path} ({x.nbytes} bytes, {x.shape})")
        return
    try:
        check_parity(args.package, args.dump_prefix, x)
    except AssertionError as e:
        print(e)
        sys.exit(1)


if __name__ == "__main__":
    main()
