"""Overlap-save fast convolution of the 3-D audio renderer (counterpart of
``jeicyboodsp_tpu/ops/fastconv.py``).

Reference: ``Fast_Convolution_Based_3DAudio_Impl.cpp``.  16 kHz mono,
1024-sample blocks, 8192-point segments, a 7169-tap RIR.  The first 7
blocks never reach the convolution (the reference queues uninitialised
buffers, which are zeros), and from block 7 on each segment is the 7 queued
blocks and the current one; the emitted samples [7168, 8192) of each
segment are the linear convolution of the zero-prefixed signal.  There is
no sequential state: all segments go through one batched op.

Engines of :func:`run_stream` (the JAX package's names):

- ``xla``: the FFT route through ``torch.fft`` (full complex, or ``real_fft``),
  in f64 (the compat default) or f32;
- ``gemm``: one banded-Toeplitz GEMM per hop, ``torch.matmul`` in full f32
  (TF32 off) or f64, as the JAX package leaves it to XLA;
- ``gemm8`` / ``gemm8hq``: the same GEMM on int8 splits, ``torch._int_mm``
  (s8 x s8 -> s32, exact) with the f32 rescale after the dots; the f32
  default;
- ``mxu`` / ``mxu3``: both transforms through the four-step FFT, on a CUDA
  tensor the kernel K12
  (:func:`~jeicyboodsp_tpu_torch.kernels.fft_four_step.fft_pallas`).  The
  JAX package's ``mxu3`` runs its matmuls as bf16x3, a TPU workaround; here
  both are the same f32 kernel.

:func:`fastconv_blocks_sparse` (the RIR's 70 nonzero taps as scaled
slices) is reached directly, as in the JAX package.  The constants
(``BLOCK_SIZE`` ... ``load_rir``, ``oracle/fastconv.py:29-42``) and the
numpy builders are copies of the JAX package's; a CPU test holds them
byte-identical.  ``load_rir`` reads ``jeicyboodsp_tpu/data/
rir_coefficients.npz`` in place.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels.fft_four_step import fft_four_step, fft_pallas
from jeicyboodsp_tpu_torch.ops.dft import int8_col_split
from jeicyboodsp_tpu_torch.utils.cnum import c_short
from jeicyboodsp_tpu_torch.utils.device import entry_device

BLOCK_SIZE = 1024
FFT_SIZE = 8192
FILTER_LENGTH = 7169
WARMUP_BLOCKS = 7  # MAX_QUEUE_SIZE
ENGINES = ("xla", "gemm", "gemm8", "gemm8hq", "mxu", "mxu3")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DATA = os.path.join(_ROOT, "jeicyboodsp_tpu", "data", "rir_coefficients.npz")


def load_rir() -> np.ndarray:
    """Dense 7169-tap RIR from the packaged sparse table."""
    d = np.load(_DATA)
    h = np.zeros(int(d["length"]), dtype=np.float64)
    h[d["indices"]] = d["values"]
    return h


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls in full f32 (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _warm(blocks, dtype):
    """The blocks as one flat signal of ``dtype``, the warm-up blocks zero."""
    x = blocks.to(dtype, copy=True)
    x[:WARMUP_BLOCKS] = 0
    return x.reshape(-1)


def _segments(flat, T):
    """(T*1024,) -> (T-7, 8192) overlapping segments, hop 1024: segment t
    is blocks t..t+7."""
    nseg = T - WARMUP_BLOCKS
    blocks = flat.reshape(T, BLOCK_SIZE)
    return torch.cat([blocks[i: i + nseg] for i in range(WARMUP_BLOCKS + 1)], dim=1)


def _plane(a, like, dtype):
    return torch.as_tensor(np.asarray(a), device=like.device).to(dtype)


def fastconv_blocks(blocks, Hr, Hi, dtype=torch.float64, real_fft=False, fft_tile: int = 256):
    """(T, 1024) int16 blocks -> (T-7, 1024) int16 written output blocks.

    Hr/Hi: real/imag planes of the filter spectrum ((8192,) for the full
    FFT, (4097,) with ``real_fft``), from :func:`filter_spectrum`.  The
    batched FFT runs ``fft_tile`` segments at a time (each segment's
    result is the same either way).
    """
    T = blocks.shape[0]
    segs = _segments(_warm(blocks, dtype), T)
    ptype = torch.float32 if dtype == torch.float32 else torch.float64
    H = torch.complex(_plane(Hr, blocks, ptype), _plane(Hi, blocks, ptype))
    if real_fft:
        def fft_one(s):
            return torch.fft.irfft(torch.fft.rfft(s) * H, FFT_SIZE)
    else:
        ctype = torch.complex128 if dtype == torch.float64 else torch.complex64

        def fft_one(s):
            return torch.fft.ifft(torch.fft.fft(s.to(ctype)) * H.to(ctype)).real
    y = torch.cat([fft_one(segs[i: i + fft_tile]) for i in range(0, segs.shape[0], fft_tile)])
    return c_short(y[:, FILTER_LENGTH - 1:])


@functools.lru_cache(maxsize=None)
def _sparse_taps():
    """The RIR's 70 nonzero (delay, coefficient) pairs (FilterCoefficient.h:4)."""
    h = np.asarray(load_rir(), np.float64)
    (idx,) = np.nonzero(h)
    return tuple(int(i) for i in idx), tuple(float(h[i]) for i in idx)


def fastconv_blocks_sparse(blocks, dtype=torch.float32):
    """Direct sparse convolution: 70 scaled slices of the flat signal, each
    coefficient rounded to ``dtype``.  Linear equals overlap-save here,
    since the largest delay (7155) is below the 7168-sample history a
    segment carries.  Same framing and warm-up as :func:`fastconv_blocks`.
    """
    T = blocks.shape[0]
    delays, coeffs = _sparse_taps()
    flat = _warm(blocks, dtype)
    out_len = (T - WARMUP_BLOCKS) * BLOCK_SIZE
    start = FILTER_LENGTH - 1  # 7168: the first emitted sample's index
    cs = torch.tensor(coeffs, dtype=dtype, device=blocks.device)
    y = torch.zeros(out_len, dtype=dtype, device=blocks.device)
    for i, d in enumerate(delays):
        y = y + cs[i] * flat[start - d: start - d + out_len]
    return c_short(y.reshape(T - WARMUP_BLOCKS, BLOCK_SIZE))


@functools.lru_cache(maxsize=None)
def _toeplitz_matrix(dtype_name: str):
    """(8192, 1024) banded-Toeplitz operator: M[i, t] = h[t + 7168 - i]
    where that index is in range, else 0, so ``segment @ M`` is exactly the
    overlap-save output samples [7168:8192] of the segment."""
    h = np.asarray(load_rir(), np.float64)
    i = np.arange(FFT_SIZE)[:, None]
    t = np.arange(BLOCK_SIZE)[None, :]
    k = t + (FILTER_LENGTH - 1) - i
    valid = (k >= 0) & (k < FILTER_LENGTH)
    M = np.where(valid, h[np.clip(k, 0, FILTER_LENGTH - 1)], 0.0)
    return M.astype(np.dtype(dtype_name))


@functools.lru_cache(maxsize=4)
def _toeplitz_on(dtype: torch.dtype, device: torch.device):
    return torch.from_numpy(_toeplitz_matrix(str(dtype).split(".")[1])).to(device)


def fastconv_blocks_gemm(blocks, dtype=torch.float32):
    """Fast convolution as ONE banded-Toeplitz GEMM per hop: (T-7, 8192)
    segments @ the (8192, 1024) operator, in full f32 (TF32 off) or f64.
    Same framing and warm-up as :func:`fastconv_blocks`."""
    segs = _segments(_warm(blocks, dtype), blocks.shape[0])
    with _full_f32_matmul():
        y = segs @ _toeplitz_on(dtype, blocks.device)
    return c_short(y)


@functools.lru_cache(maxsize=None)
def _toeplitz_int8():
    """Per-column int8 splits of the Toeplitz operator, the folded +128
    data-shift rows, and the third residual term (s3, Mm)."""
    M = _toeplitz_matrix("float64")
    Mh, Ml, s1, s2 = int8_col_split(M)
    R = M - (s1 * Mh.astype(np.float64) + s2 * Ml.astype(np.float64))
    s3 = np.maximum(np.abs(R).max(0), 1e-30) / 127.0
    Mm = np.rint(R / s3).astype(np.int8)
    crow = 128.0 * (s1 * Mh.astype(np.int64).sum(0) + s2 * Ml.astype(np.int64).sum(0))
    crow3 = 128.0 * s3 * Mm.astype(np.int64).sum(0)  # 3rd term's +128 fold
    return (Mh, Ml, Mm, s1.astype(np.float32), s2.astype(np.float32),
            s3.astype(np.float32), crow.astype(np.float32), crow3.astype(np.float32))


@functools.lru_cache(maxsize=4)
def _toeplitz_int8_on(device: torch.device):
    """:func:`_toeplitz_int8` on ``device``, the int8 operators column-major
    (the layout cuBLAS's int8 GEMM takes without a copy)."""
    Mh, Ml, Mm, *rest = _toeplitz_int8()
    ops = [torch.from_numpy(m).to(device).t().contiguous().t() for m in (Mh, Ml, Mm)]
    return (*ops, *(torch.from_numpy(v).to(device) for v in rest))


def int8_dots(blocks, terms: int = 3):
    """The int32 dot planes of the int8 Toeplitz GEMM: (zh, zl, rh, rl[, mh])
    = (sh @ Mh, sl @ Mh, sh @ Ml, sl @ Ml[, sh @ Mm]), each (T-7, 1024),
    with x = 256*h + l + 128 split exactly into the int8 segment planes sh,
    sl.  ``torch._int_mm`` on a card takes more than 16 rows, so the
    segments are padded to a multiple of 8, at least 24, and cut after."""
    T = blocks.shape[0]
    Mh, Ml, Mm = _toeplitz_int8_on(blocks.device)[:3]
    xi = _warm(blocks, torch.int32)
    hh = xi >> 8  # floor(x / 256), arithmetic shift
    ll = xi - 256 * hh - 128
    nseg = T - WARMUP_BLOCKS
    pad = max(24, -(-nseg // 8) * 8) - nseg
    sh, sl = (torch.nn.functional.pad(_segments(v.to(torch.int8), T), (0, 0, 0, pad))
              for v in (hh, ll))
    pairs = [(sh, Mh), (sl, Mh), (sh, Ml), (sl, Ml)] + ([(sh, Mm)] if terms >= 3 else [])
    return [torch._int_mm(a, b)[:nseg] for a, b in pairs]


def fastconv_blocks_gemm_int8(blocks, terms: int = 3):
    """The Toeplitz GEMM on int8 splits: four s8 x s8 -> s32 dots (``terms
    = 2``, gemm8) or five (``terms = 3``, gemm8hq: the fifth, 256 * sh @ Mm
    * s3, recaptures the 2-term split's residual).  The 256x rescale is in
    f32 after the dots (256 * |sh @ Mh| can pass int32 at K = 8192), in the
    JAX package's order.  Same framing and warm-up as
    :func:`fastconv_blocks_gemm`."""
    s1, s2, s3, crow, crow3 = _toeplitz_int8_on(blocks.device)[3:]
    f = [d.to(torch.float32) for d in int8_dots(blocks, terms)]
    y = s1 * (256.0 * f[0] + f[1]) + s2 * (256.0 * f[2] + f[3]) + crow
    if terms >= 3:
        y = y + s3 * (256.0 * f[4]) + crow3
    return c_short(y)


def filter_spectrum(h=None, dtype=torch.float64, real_fft=False):
    """Host-side (numpy) filter spectrum as (real, imag) float planes."""
    if h is None:
        h = load_rir()
    h = np.asarray(h, dtype=np.float64)
    ctype = np.complex64 if dtype == torch.float32 else np.complex128
    H = np.fft.rfft(h, FFT_SIZE) if real_fft else np.fft.fft(h, FFT_SIZE)
    H = H.astype(ctype)
    return H.real.copy(), H.imag.copy()


def fastconv_blocks_mxu(blocks, Hr, Hi, dtype=torch.float32):
    """Fast convolution on the four-step FFT: the forward transform of the
    real segments, the product with the full 8192-bin filter spectrum
    Hr/Hi, the inverse, /8192.  On a CUDA tensor in f32 both transforms are
    the kernel K12; otherwise :func:`fft_four_step`."""
    T = blocks.shape[0]
    segs = _segments(_warm(blocks, dtype), T)
    Hr, Hi = _plane(Hr, blocks, dtype), _plane(Hi, blocks, dtype)
    if segs.is_cuda and dtype == torch.float32:
        fft = fft_pallas
    else:
        fft = functools.partial(fft_four_step, dtype=dtype)
    Xr, Xi = fft(segs, None, FFT_SIZE, True)
    Yr = Xr * Hr - Xi * Hi
    Yi = Xr * Hi + Xi * Hr
    yr, _ = fft(Yr, Yi, FFT_SIZE, False)
    y = yr * (1.0 / FFT_SIZE)
    return c_short(y[:, FILTER_LENGTH - 1:])


def run_stream(x, dtype=torch.float64, real_fft=False, fft_engine: str = "auto",
               device="cuda"):
    """Host convenience matching ``oracle.fastconv.run`` framing, on
    ``device`` (a CUDA card unless the caller asks for the CPU; raises if
    that card is missing).

    ``fft_engine="auto"`` picks ``gemm8hq`` for f32 and ``xla`` for f64;
    ``real_fft`` applies to ``xla``.  Returns the written samples, int16.
    """
    dev = entry_device(device)
    if fft_engine == "auto":
        fft_engine = "gemm8hq" if dtype == torch.float32 else "xla"
    if fft_engine not in ENGINES:
        raise ValueError(f"fft_engine must be 'auto' or one of {ENGINES}, got {fft_engine!r}")
    x = np.asarray(x, np.int16)
    if -(-len(x) // BLOCK_SIZE) <= WARMUP_BLOCKS:
        return np.zeros(0, np.int16)
    blocks = torch.from_numpy(np.ascontiguousarray(stale_blocks(x, BLOCK_SIZE))).to(dev)
    if fft_engine in ("gemm8", "gemm8hq"):
        out = fastconv_blocks_gemm_int8(blocks, terms=3 if fft_engine == "gemm8hq" else 2)
    elif fft_engine == "gemm":
        out = fastconv_blocks_gemm(blocks, dtype=dtype)
    elif fft_engine.startswith("mxu"):
        out = fastconv_blocks_mxu(blocks, *filter_spectrum(dtype=torch.float32))
    else:
        out = fastconv_blocks(blocks, *filter_spectrum(dtype=dtype, real_fft=real_fft),
                              dtype=dtype, real_fft=real_fft)
    return out.reshape(-1).cpu().numpy()
