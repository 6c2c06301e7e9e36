"""ctypes bindings to the native data-loader core, `csrc/imageio.cc`
(counterpart of demonet_tpu/data/native.py): JPEG decode (libjpeg),
bilinear resize and float conversion on a C++ thread pool, one ctypes
call per batch. Host code: it launches no kernel.

The port builds its own library from its own copy of the source, never
the JAX package's: g++ (-O3 -shared -fPIC -pthread, -ljpeg) at the first
call that needs it, into `demonet_tpu_torch/_build/imageio-<hash>.so`,
the hash covering the source and the flags, as `ops/_build.py` does for
the CUDA kernels. Nothing builds on import. `available()` builds the
library or reports why it cannot (no g++, or no libjpeg headers:
`build_error()`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "imageio.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_state: Dict[str, object] = {}   # "lib" (ctypes.CDLL or None), "error"


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"imageio-{digest.hexdigest()[:16]}.so")


def toolchain() -> Dict[str, object]:
    """What the build needs: the g++ it would run (or None) and whether
    that compiler finds <jpeglib.h>."""
    cxx = shutil.which("g++")
    header = False
    if cxx:
        probe = subprocess.run(
            [cxx, "-E", "-x", "c++", "-"], capture_output=True, text=True,
            input="#include <cstdio>\n#include <jpeglib.h>\n")
        header = probe.returncode == 0
    return {"g++": cxx, "jpeglib.h": header}


def _build() -> str:
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (rc={proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def _library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (with the reason
    in `build_error()`) where it cannot be built."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        try:
            lib = ctypes.CDLL(_build())
        except (RuntimeError, OSError) as e:
            _state.update(lib=None, error=str(e))
            return None
        lib.demonet_decode_jpeg_resize.restype = ctypes.c_int
        lib.demonet_decode_jpeg_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        lib.demonet_decode_jpeg_batch.restype = ctypes.c_int
        lib.demonet_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _state.update(lib=lib, error=None)
        return lib


def available() -> bool:
    """Build (or find) the library; False where it cannot be built."""
    return _library() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built (after `available()`), or None."""
    return _state.get("error")


def _require() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError(f"the native image library cannot be built: "
                           f"{build_error()}")
    return lib


def decode_jpeg_resize(data: bytes, out_h: int, out_w: int
                       ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """One JPEG -> (float32 (out_h, out_w, 3) in [0, 1], (orig_h, orig_w))."""
    lib = _require()
    out = np.empty((out_h, out_w, 3), np.float32)
    hw = (ctypes.c_int * 2)()
    rc = lib.demonet_decode_jpeg_resize(
        data, len(data), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), hw)
    if rc != 0:
        raise ValueError("JPEG decode failed")
    return out, (hw[0], hw[1])


def decode_jpeg_batch(blobs: List[bytes], out_h: int, out_w: int,
                      num_threads: int = 4
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and resize a batch on `num_threads` threads: (images
    (N, out_h, out_w, 3) float32, original sizes (N, 2) int32). Raises on
    any failed decode."""
    lib = _require()
    n = len(blobs)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    hw = np.empty((n, 2), np.int32)
    data = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_int64 * n)(*[len(b) for b in blobs])
    rc = lib.demonet_decode_jpeg_batch(
        data, sizes, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    if rc != 0:
        raise ValueError(f"{rc} JPEG decodes failed")
    return out, hw
