"""Build the CUDA sources in ``csrc/`` into a shared library and load it.

nvcc compiles every ``csrc/*.cu`` into one ``.so`` with a plain C
interface at first use; the library lands in ``jeicyboodsp_tpu_torch/build/``
under a name keyed on a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  There is no fallback: a
missing nvcc or a failed compile raises with the compiler's stderr.

Flags: ``-fmad=false`` keeps every f32 ``a*b + c`` of the epilogues as two
roundings, in the JAX package's operand order (the kernels' exactness
notes rely on it).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run that built the loaded library


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(BUILD, f"libjeicyboo_cuda-{h.hexdigest()[:16]}.so")


def _compile(so: str) -> float:
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sorted(glob.glob(os.path.join(CSRC, "*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                build_seconds = _compile(so)
            lib = ctypes.CDLL(so)
            lib.jb_enhance_full8.restype = ctypes.c_int
            lib.jb_enhance_full8.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p]
                + [ctypes.c_int] * 5
                + [ctypes.c_void_p] * 19
            )
            _lib = lib
        return _lib
