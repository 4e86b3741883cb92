"""Build the CUDA sources in ``csrc/`` into a shared library and load it.

nvcc compiles each ``csrc/*.cu`` into an object, all sources at once in
parallel processes, and links the objects into one ``.so`` with a plain C
interface at first use; the library lands in ``jeicyboodsp_tpu_torch/build/``
under a name keyed on a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  There is no fallback: a
missing nvcc or a failed compile raises with the compiler's stderr.

Flags: ``-fmad=false`` keeps every ``a*b + c`` as two roundings, in f32 (the
enhancement epilogues, in the JAX package's operand order; the MFCC's |X|,
mel and DCT; the FFT's twiddle products; the GEQ cascade's f32 instance and
its linear engine; the f32 instances of the NLMS and BNLMS recursions) and
in f64 (the GEQ, NLMS and BNLMS recursions, in the reference's order): the kernels' exactness notes
rely on it.  No fast math:
``sqrtf``, ``logf`` and divisions stay IEEE.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of each C entry: every pointer (and the stream) as c_void_p
ENTRIES = {
    # x, rowpack, T, L, wiener, hq, emit_all, 9 constants, 10 buffers, stream
    "jb_enhance_full8": [_P, _P] + [_I] * 5 + [_P] * 20,
    # mag, magn, rowpack, T, L, pfx, A0, ns, nsn, stream
    "jb_noise_latch": [_P, _P, _P, _I, _I] + [_P] * 5,
    # x, T, fwd8, fscales, fcrows, nyq, w2, re, im, ren, mag, magn, sp, nz, stream
    "jb_enhance_fwd_int8": [_P, _I] + [_P] * 13,
    # re, im, ren, ns, nsn, nz, T, wiener, hq, emit_all, 5 constants, q8, rowsc, uv, out,
    # stream
    "jb_enhance_back_ola8": [_P] * 6 + [_I] * 4 + [_P] * 10,
    # x, T, rfft, nyq, w2, re, im, ren, mag, magn, sp, nz, stream
    "jb_enhance_fwd": [_P, _I] + [_P] * 11,
    # re, im, ren, ns, nsn, nz, T, wiener, emit_all, 3 constants, hw, y512, out, stream
    "jb_enhance_back_ola3": [_P] * 6 + [_I] * 3 + [_P] * 7,
    # x, coef, state in, y, state out, B, T, stream (f64, and the f32 instance)
    "jb_geq_cascade_quant": [_P] * 5 + [_I] * 2 + [_P],
    "jb_geq_cascade_quant_f32": [_P] * 5 + [_I] * 2 + [_P],
    # x, coef, y, B, T, stream
    "jb_geq_cascade": [_P] * 3 + [_I] * 2 + [_P],
    # x, ref, coef in, hist in, est, err, coef out, hist out, B, T, compat, stream
    "jb_nlms": [_P] * 8 + [_I] * 3 + [_P],
    "jb_nlms_f32": [_P] * 8 + [_I] * 3 + [_P],  # the same with f32 coefficients
    # K8's and K9's quotient alone, for the tests: a, d, q, want, n, stream
    "jb_test_quotient": [_P] * 4 + [_I, _P],
    # x, ref, gates, coef in, keep in, est, err, coef out, keep out, B, nb, stream
    "jb_bnlms": [_P] * 9 + [_I] * 2 + [_P],
    "jb_bnlms_f32": [_P] * 9 + [_I] * 2 + [_P],  # the same with f32 coefficients
    # K9's resident blocks per SM (f64, f32 instance): out int, stream (unused)
    "jb_bnlms_occupancy": [_P, _P],
    "jb_bnlms_f32_occupancy": [_P, _P],
    # prev, cur, N, rfft, mel runs, mel weights, n weights, dct, out, stream
    "jb_mfcc_fused": [_P, _P, _I] + [_P] * 3 + [_I] + [_P] * 3,
    # frames, T, lo, out, stream
    "jb_amdf": [_P, _I, _I, _P, _P],
    # re, im, ren, ns, nsn, nz, T, wiener, 3 constants, head/w2, y512, stream
    "jb_enhance_back": [_P] * 6 + [_I] * 2 + [_P] * 6,
    # x, w2, T, flags, stream
    "jb_vad_flags": [_P, _P, _I, _P, _P],
    # re, im (or null), T, n, forward, twiddle tables, out re, out im, stream
    "jb_fft4": [_P, _P, _I, _I, _I] + [_P] * 4,
    # blocks, Tc, window, twiddles, 6 state in, wiener, out, mask, 6 state out, stream
    "jb_enhance_chunk64": [_P, _I] + [_P] * 8 + [_I] + [_P] * 9,
}

_lock = threading.Lock()
_lib = None
_fns = {}  # entry name -> its ctypes function, once the library is loaded
build_seconds = None  # wall time of the nvcc runs that built the loaded library


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(BUILD, f"libjeicyboo_cuda-{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands side by side; raise with the stderr of the failures."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            err = f"timed out after 600 s\n{err}"
        if p.returncode != 0:
            errors.append(f"{os.path.basename(p.args[-1])}: {err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _compile(so: str) -> float:
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = {src: f"{tmp}.{os.path.basename(src)}.o" for src in _sources()}
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in objs.items()])
        _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs.values()]])
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        for p in [tmp, *objs.values()]:
            if os.path.exists(p):
                os.remove(p)
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
            for name, argtypes in ENTRIES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                _fns[name] = fn
            _lib = lib
        return _lib


def launch(entry: str, device, *args) -> None:
    """Call the C entry ``entry`` on ``device``'s current stream (appended as
    the last argument); raise if it reports a CUDA error.

    The host path is kept short, since the short kernels' calls are bound by
    it: the entry's ctypes function is resolved once, when the library
    loads; the card is switched only when ``device`` is not the current
    one; the stream is read as a raw pointer."""
    import torch

    fn = _fns.get(entry)
    if fn is None:
        load_library()
        fn = _fns[entry]
    index = device.index
    current = torch._C._cuda_getDevice()  # CUDA is initialised: the tensors are on a card
    if index is None or index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):  # launch on the tensors' card
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
