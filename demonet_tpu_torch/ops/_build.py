"""Build and load the hand-written CUDA kernels in `demonet_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, compiled by `nvcc` for Hopper (`sm_90a`) at the first call on a
CUDA tensor and loaded with `ctypes`. Nothing here runs on import, so the
package imports on a host with no GPU and no nvcc.

Libraries go to `demonet_tpu_torch/_build/<name>-<hash>.so`, the hash
covering the source and the flags, so an edited kernel is rebuilt and an
unchanged one is reused. `build_all()` starts one nvcc per source, all at
once, and waits for them.

Flags: `-fmad=false` keeps nvcc from contracting a*b+c into an FMA, which
would round differently from the plain PyTorch version and can flip an
NMS decision that sits right at the IoU threshold. No fast-math flag.

`seconds` counts, for this process, what each library cost:
{name: {'build_s': nvcc's wall time (0.0 where the library was already
built), 'load_s': the `ctypes` load}}; a library built again shows
there with its nvcc time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
seconds: Dict[str, Dict[str, float]] = {}


def _count(name: str, key: str, secs: float) -> None:
    seconds.setdefault(name, {"build_s": 0.0, "load_s": 0.0})[key] += secs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def sources() -> List[str]:
    """Kernel names, one per `csrc/*.cu`."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[Tuple[subprocess.Popen, str]]:
    """Start nvcc for one source unless its library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"cannot build CUDA kernel {name!r}: nvcc not found ({e})") from e
    return proc, tmp


def _finish(name: str, started: Tuple[subprocess.Popen, str]) -> None:
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build CUDA kernel {name!r} "
                           f"(rc={proc.returncode}):\n{log}")
    out = library_path(name)
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> Dict[str, float]:
    """Build every kernel library, one nvcc each, all started together.

    Returns the seconds until each was built (0.0 if it already was).
    """
    t0 = time.perf_counter()
    started = {name: _start(name) for name in sources()}
    secs = {}
    for name, s in started.items():
        if s is not None:
            _finish(name, s)
        secs[name] = time.perf_counter() - t0 if s is not None else 0.0
        _count(name, "build_s", secs[name])
    return secs


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for a built kernel (registers, smem)."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


def build(name: str) -> str:
    """The path of the library of `csrc/<name>.cu`, built first if needed.
    A program linked against it finds it through the rpath `BUILD_DIR`
    (the C++ runner's ops library, `export/aoti.py`)."""
    t0 = time.perf_counter()
    started = _start(name)
    if started is not None:
        _finish(name, started)
    _count(name, "build_s",
           time.perf_counter() - t0 if started is not None else 0.0)
    return library_path(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _loaded:
        path = build(name)
        t0 = time.perf_counter()
        _loaded[name] = ctypes.CDLL(path)
        _count(name, "load_s", time.perf_counter() - t0)
    return _loaded[name]


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel} failed to launch: cudaError_t {code}")
