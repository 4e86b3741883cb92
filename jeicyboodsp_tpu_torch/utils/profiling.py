"""Profiling and rooflines on an H100 (counterpart of
``jeicyboodsp_tpu/utils/profiling.py``).

- :func:`trace` records a Chrome trace of what runs inside it with
  ``torch.profiler`` (host activity, and the card's when CUDA is there),
  and the port's spans beside it on the same clock.
- :class:`Roofline` places a measured samples/s against the card's roofs,
  with the JAX class's fields, ``bound()`` keys and ``pct_of_roof``; its
  22 models keep the JAX module's names, so that a benchmark annotates one
  for one.  Each counts the work of its op's *function*, whatever engine or
  kernel computes it, so that a share of the roof reads the same work
  whatever implements it; the engine's name selects only ``unit``, the
  arithmetic type its work runs in, and so the peak it is held to.  The
  parameters are the function's shapes (the JAX models' pass counts
  describe TPU GEMMs and are gone).
- :data:`KERNELS` gives each hand-written kernel's work at its shapes:
  bytes (each input of its function read once, each output written once:
  a stream that frames overlap counts once, and a table that only one
  implementation reads, such as a dense DFT basis, not at all), operations,
  their type, the basis of the count and, for the recursions, the
  dependency chain's estimate; :func:`bound` turns bytes and operations into the least
  time on the card.

The card's peaks live here and nowhere else in the port: NVIDIA's H100 SXM
data sheet, dense, with an FMA counted as two operations.  ``instr`` is the
dispatch rate of one warp instruction per clock on each of an SM's 4
partitions (128 lanes a clock per SM; NVIDIA's Hopper white paper) over
132 SMs at the card's highest SM clock, 1980 MHz.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY, clock_offset_ns

HBM_BPS = 3.35e12  # bytes/s of HBM3
SMS, SM_CLOCK_HZ, SM_LANES_PER_CLOCK = 132, 1.98e9, 128
PEAKS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12, "f64": 34e12,
         "instr": SMS * SM_LANES_PER_CLOCK * SM_CLOCK_HZ}


@contextmanager
def trace(logdir: str):
    """Record what runs inside the block with ``torch.profiler`` and write
    it as a Chrome trace (``trace_<pid>_<ms>.json``) under ``logdir``, and
    the port's spans recorded inside it (``utils.metrics``) beside it
    (``spans_<pid>_<ms>.json``: ``{"clock": "unix_ns", "spans": [...]}``,
    each span's ``start_ns`` and ``end_ns`` on the profiler's clock, so that
    a Chrome trace's ``ts`` is ``(ns - baseTimeNanoseconds) / 1000``).
    Host ops are always recorded, the card's kernels when CUDA is
    available.  Yields the profiler (``key_averages()`` and the like)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = len(REGISTRY.spans())
    with REGISTRY.recording(), profile(activities=activities) as prof:
        yield prof
    spans = REGISTRY.take_spans(first)
    offset = clock_offset_ns()
    stem = f"{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(os.path.join(logdir, "trace_" + stem))
    with open(os.path.join(logdir, "spans_" + stem), "w") as f:
        json.dump({"clock": "unix_ns", "spans": [s.as_dict(offset) for s in spans]}, f)


def bound(nbytes, ops, unit):
    """The least time (ms) of work on this card: its bytes over the memory
    rate, or its operations over the peak rate of ``unit``, whichever is
    longer.  Returns (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAKS[unit] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@dataclass
class Roofline:
    flops_per_block: float
    hbm_bytes_per_block: float
    samples_per_block: int
    unit: str = "f32"  # the arithmetic type of the work: a key of PEAKS

    PEAKS = PEAKS

    def bound(self, peak_flops: float | None = None, peak_bw: float = HBM_BPS) -> dict:
        """Samples/s ceilings on one H100 (HBM 3.35 TB/s)."""
        if peak_flops is None:
            peak_flops = self.PEAKS[self.unit]
        t_compute = self.flops_per_block / peak_flops
        t_mem = self.hbm_bytes_per_block / peak_bw
        t = max(t_compute, t_mem)
        return {
            "compute_bound_samples_per_s": self.samples_per_block / t_compute,
            "memory_bound_samples_per_s": self.samples_per_block / t_mem,
            "speed_of_light_samples_per_s": self.samples_per_block / t,
            "bottleneck": "compute" if t_compute > t_mem else "memory",
        }

    def pct_of_roof(self, measured_sps: float) -> float:
        """Measured samples/s as a % of this model's speed of light."""
        return 100.0 * measured_sps / self.bound()["speed_of_light_samples_per_s"]


def _rfft_flops(n):
    """A real n-point FFT (or its inverse to real output): 2.5 n log2 n."""
    return 2.5 * n * np.log2(n)


def _enhance_block_flops(block=512, fft=1024):
    """The enhancement chain's function per block: the window (fft), a
    forward and an inverse real FFT, |X| (4 per bin), the latch (3 per bin),
    the gain with its phase kept (8 per bin), the VAD (6 per sample) and the
    OLA with the store into a short (2 per sample)."""
    bins = fft // 2 + 1
    return fft + 2 * _rfft_flops(fft) + (4 + 3 + 8) * bins + (6 + 2) * block


def _enhance(block, fft, unit):
    return Roofline(_enhance_block_flops(block, fft), 2 * block * 2, block, unit=unit)


def enhance_chain_roofline(block=512, fft=1024, dtype_bytes=4) -> Roofline:
    """The Wiener / spectral-subtraction chain per 512-sample block, the
    yardstick every ``enhance_*`` model shares: the window, a forward and an
    inverse 1024-point real FFT at 2.5 N log2 N each, |X|, the latch and the
    gain per bin, the VAD and the OLA per sample (:func:`_enhance_block_flops`,
    ~63 k operations); int16 in and out once (2 KB).  In f32, or f64 for
    ``dtype_bytes=8`` (the compat path)."""
    return _enhance(block, fft, "f32" if dtype_bytes == 4 else "f64")


def enhance_mxu3_roofline(block=512, fft=1024) -> Roofline:
    """Engine mxu3 (K4's f32 real FFT, K5): the chain's work in f32."""
    return _enhance(block, fft, "f32")


def enhance_mxu8_roofline(block=512, fft=1024) -> Roofline:
    """Engine mxu8 (K2, K3): the chain's work at the int8 rate of its dots."""
    return _enhance(block, fft, "int8")


def enhance_mxu8t_roofline(block=512, fft=1024) -> Roofline:
    """Engine mxu8t (K14, K1 turbo): the chain's work at the int8 rate."""
    return _enhance(block, fft, "int8")


def enhance_mxu8f_roofline(block=512, fft=1024) -> Roofline:
    """Engine mxu8f (K14, K1 hq): the chain's work at the int8 rate."""
    return _enhance(block, fft, "int8")


RIR_NONZERO_TAPS = 69  # the nonzero taps of the 7169-tap RIR (data/rir_coefficients.npz)


def _fastconv(block, taps, unit):
    return Roofline(2 * taps * block, 2 * block * 2, block, unit=unit)


def fastconv_roofline(block=1024, taps=RIR_NONZERO_TAPS, dtype_bytes=4) -> Roofline:
    """The RIR convolution per 1024-sample block, the yardstick every
    ``fastconv_*`` model shares: its least work, a multiply and an add per
    nonzero tap and sample (the sparse RIR's 69 taps; the 8192-point FFT
    form costs ~4x that); int16 in and out once.  f32, or f64 for
    ``dtype_bytes=8``."""
    return _fastconv(block, taps, "f32" if dtype_bytes == 4 else "f64")


def fastconv_gemm8_roofline(block=1024, taps=RIR_NONZERO_TAPS) -> Roofline:
    """Engine gemm8: the convolution's work at the int8 rate of its dots."""
    return _fastconv(block, taps, "int8")


def fastconv_gemm8hq_roofline(block=1024, taps=RIR_NONZERO_TAPS) -> Roofline:
    """Engine gemm8hq (the --fast default): the same at the int8 rate."""
    return _fastconv(block, taps, "int8")


def fastconv_gemm_roofline(block=1024, taps=RIR_NONZERO_TAPS) -> Roofline:
    """Engine gemm (the f32 Toeplitz GEMM): the convolution's work in f32."""
    return _fastconv(block, taps, "f32")


def fastconv_sparse_roofline(block=1024, taps=RIR_NONZERO_TAPS) -> Roofline:
    """The sparse direct path: the convolution's work in f32."""
    return _fastconv(block, taps, "f32")


def geq_roofline(block=512, bands=7, dtype_bytes=4) -> Roofline:
    """The linear GEQ cascade (``geq_apply_fast``) per block: 9 operations
    per band and sample, the direct form's 5 products and 4 sums, whatever
    scan computes them; the samples in and out once in ``dtype_bytes``."""
    return Roofline(9 * bands * block, 2 * block * dtype_bytes, block,
                    unit="f32" if dtype_bytes == 4 else "f64")


def geq_seq_roofline(block=512, bands=7) -> Roofline:
    """The reference GEQ (K6) per block: the 9 f64 operations per band and
    sample that its bit-exact contract fixes (the sum in the reference's
    order, each band's output stored into a short); int16 in and out once.
    Its dependency chain, which this does not see, is K6's row of
    :data:`KERNELS`."""
    return Roofline(9 * bands * block, 2 * block * 2, block, unit="f64")


def nlms_roofline(taps=256) -> Roofline:
    """NLMS (K8) per sample of a stream, in f64 as its bit-exact contract
    fixes: the estimate's taps products and taps - 1 sums, the window energy
    and divisor (5), the update 2.0 * u * MU * e / d + c per tap (5); x and
    ref in, est and err out as int16."""
    return Roofline((2 * taps - 1) + 5 + 5 * taps, 4 * 2, 1, unit="f64")


def bnlms_roofline(taps=128, block=1024) -> Roofline:
    """BNLMS (K9) per sample of a stream, in f64 as its bit-exact contract
    fixes, with every double-talk gate open (a shut gate skips the update;
    ``KERNELS["K9"]`` counts the gates a run's data opens): the estimate (2
    per tap), the window energy as a running difference (3, + eps), the
    gradient (3 per tap), u * 2MU over the 1151-sample buffer and the update
    (2 per tap) once a block; int16 in and out."""
    per_open = 3 * taps + 4 + (block + taps - 1 + 2 * taps) / block
    return Roofline(2 * taps + per_open, 4 * 2, 1, unit="f64")


def amdf_roofline(lags=(101, 512), window=1024) -> Roofline:
    """Pitch method 2 per 512-sample hop: |x[i] - x[i + k]| summed over the
    window for each lag k in ``lags``, one instruction a pair (K11's packed
    int16 minimum and dot each take two pairs), at the SMs' dispatch rate; the
    hop in as int16 and lag, value and f0 out."""
    pairs = sum(window - k for k in range(*lags))
    return Roofline(pairs, 512 * 2 + 3 * 8, 512, unit="instr")


def mvdr_collapsed_roofline(block=512) -> Roofline:
    """The MVDR beamformer at theta = 0 per block and channel pair, where R
    is diagonal (Parseval): the left channel's VAD (window, store, square,
    sum: 4 per sample), the two channels' energies over their 1024-sample
    pairs (8 per sample), the mix w0 * l + w1 * r (3); two int16 in, one
    out."""
    return Roofline((4 + 8 + 3) * block, 3 * block * 2, block, unit="f32")


def mvdr_spectral_roofline(block=512, fft=1024) -> Roofline:
    """The spectral MVDR per block: four 1024-point real FFTs (the two
    channels' pairs and frames), one complex inverse (the merged spectrum is
    not Hermitian, 5 N log2 N), the covariance terms (8 per bin) and the
    weights and mix (20 per bin); two int16 in, one out."""
    flops = 4 * _rfft_flops(fft) + 5 * fft * np.log2(fft) + 28 * fft
    return Roofline(flops, 3 * block * 2, block, unit="f32")


def lpc_roofline(block=256, window=512, order=12) -> Roofline:
    """LPC per 256-sample hop: the window (512), the 13 autocorrelation
    lags as dot products over window - k samples, Levinson (~2 order^2 +
    order); int16 in, order f32 coefficients out."""
    flops = window + sum(2 * (window - k) for k in range(order + 1)) + 2 * order ** 2 + order
    return Roofline(flops, block * 2 + order * 4, block, unit="f32")


# a real 1024-point FFT (2.5 n log2 n flops), then per frame pre-emphasis and window (3 per
# sample), |X| (4 per bin), the mel runs (<= 2 weights per bin, 4 flops), the DCT (38 x 12)
MFCC_FRAME_FLOPS = _rfft_flops(1024) + 3 * 1024 + 4 * 512 + 4 * 512 + 2 * 38 * 12


def mfcc_roofline(block=1024) -> Roofline:
    """MFCC per 1024-sample block, two frames of :data:`MFCC_FRAME_FLOPS`
    each (a real FFT, not the dense DFT); int16 in, 2 x 12 f32 out."""
    return Roofline(2 * MFCC_FRAME_FLOPS, block * 2 + 2 * 12 * 4, block, unit="f32")


def wk_pitch_roofline(block=512, proc=1024, pad=1) -> Roofline:
    """Pitch method 1 per hop (``pad=2``: method 3's linear
    autocorrelation): the autocorrelation by Wiener-Khinchin, a real FFT of
    proc * pad points, the power (3 per bin) and the inverse real FFT, then
    the search over lags 101..511 (1 each); the hop in as int16, lag, value
    and f0 out."""
    n = proc * pad
    flops = 2 * _rfft_flops(n) + 3 * (n // 2 + 1) + (block - 101)
    return Roofline(flops, block * 2 + 3 * 8, block, unit="f32")


def wk_pitch3_roofline(block=512, proc=1024) -> Roofline:
    """Pitch method 3: the linear autocorrelation through the zero-padded
    2048-point transforms (:func:`wk_pitch_roofline` with ``pad=2``)."""
    return wk_pitch_roofline(block, proc, pad=2)


def fft_roundtrip_roofline(block=512) -> Roofline:
    """The FFT program per block: a forward FFT of real input and an
    inverse to real output (2.5 n log2 n each), the scale (1 per sample);
    int16 in and out once."""
    return Roofline(2 * _rfft_flops(block) + block, 2 * block * 2, block, unit="f32")


def bnlms_xla_roofline(taps=128) -> Roofline:
    """The batched BNLMS op (``ops.nlms.bnlms_apply``): the same function as
    :func:`bnlms_roofline`, so the same yardstick."""
    return bnlms_roofline(taps)


# ---------------------------------------------------------------- the kernels' work


@dataclass(frozen=True)
class Work:
    """A kernel's work at its shapes; ``chain_cycles`` dependent cycles a
    step over ``chain_steps`` steps for a recursion, else None."""

    nbytes: float
    ops: float
    unit: str
    basis: str
    chain_cycles: float | None = None
    chain_steps: int | None = None

    def bound(self):
        """(ms, "bytes" or "operations"): see :func:`bound`."""
        return bound(self.nbytes, self.ops, self.unit)

    def chain_ms(self, clock_hz=SM_CLOCK_HZ):
        """The dependency chain's least time (ms) at ``clock_hz``."""
        return self.chain_steps * self.chain_cycles / clock_hz * 1e3


# bytes of the constants each enhancement kernel's function reads (ops.enhance.
# enhance_constants): K1-K3's int8 bases fwd8 (8, 512, 512) and back8 (4, 512, 512), their
# f32 scales (8 and 4 rows of 512) and correction rows (2 x 512 each), which define their
# outputs bit for bit; nyq (1024), w2 and u_nyq (512), y512col (513); for K4, K5 and K13 a
# real FFT's table (twiddles and window: K4's rfft, 2560), not the dense TF32 bases back32
# that K5's and K13's GEMMs read
_F = 4
_RFFT = 2560 * _F
_CONSTS = {
    "K1": 8 * 512 * 512 + 8 * 512 * _F + 2 * 512 * _F + 1024 * _F + 4 * 512 * 512
    + 4 * 512 * _F + 2 * 512 * _F + 512 * _F + 513 * _F,
    "K2": 8 * 512 * 512 + 8 * 512 * _F + 2 * 512 * _F + 1024 * _F + 512 * _F,
    "K3": 4 * 512 * 512 + 4 * 512 * _F + 2 * 512 * _F + 512 * _F + 513 * _F,
    "K4": _RFFT + 1024 * _F + 512 * _F,
    "K5": _RFFT + 512 * _F + 513 * _F,
}
_CONSTS["K13"] = _CONSTS["K5"]
# a forward kernel's planes a row: re, im, |X|, re_n, |X_n|, the speech and the frame flag
_PLANES_FWD = (3 * 512 + 4) * _F
_PLANES_BACK = (3 * 512 + 3) * _F  # a back kernel's inputs a row: re, im, ns, re_n, ns_n, nz
# K4's function a frame through a real FFT: the window (1024), the FFT, |X| (4 per bin), the
# Nyquist dot (2 per sample), the VAD (6 per sample of a block)
K4_FRAME_FLOPS = 1024 + _rfft_flops(1024) + 4 * 512 + 2 * 1024 + 6 * 512
# K5's and K13's function a frame: the gain (8 per bin) and the inverse real FFT; K5 adds the
# OLA with its store into a short (2 per sample)
BACK_FRAME_FLOPS = 8 * 513 + _rfft_flops(1024)
DOTS = 512 * 512  # MACs of one row through a (512, 512) int8 basis
# dependent cycles a step of each recursion's longest chain, an estimate from the kernels'
# instruction chains at ~8 cycles an f64 op, ~4 an f32 op, ~27 a shuffle, ~19 an f64 <->
# int conversion, ~5 an integer op (not measured):
# - K6 a step: one band's y1 -> a1*y1 -> the subtraction -> + b0*x0 -> the truncating
#   conversion and the sign extension -> the conversion back to f64: 3 x 8 + 19 + 5 + 19
#   ~ 67; the lane layout hands band k-1's output over a step ahead (skew 2), lane 0's load
#   is made a step ahead and c_short's range compares are left out where the coefficients
#   bound every acc, so none of them is on it; T + 12 steps (fill, drain);
# - K7 a step: one band's s0 -> y (the add) -> c3*y -> the subtraction -> + s1: 4 x 4 = 16
#   in f32, K6's lane layout (skew 2, T + 12 steps);
# - K8 a sample: the estimate (a product and 7 adds: 64), the tree (5 shuffle-adds: 175),
#   c_short (two compares, the conversion, the sign extension: ~50), the error and its
#   conversion (~24), then one tap's numerator, q0, four FMAs, its sign and its add (~61):
#   ~375; d and 1/d come from the input alone, off the chain;
# - K9 a block: the estimate's 128 sequential adds (~1024), the energy scan's five
#   shuffle-adds and the warp totals behind a barrier (~300), four parts' staging of 1/d
#   behind barriers (~400) and the gradient's 1024 sequential adds (~8192): ~10,000; the
#   quotients hang off that add chain, each independent of the others;
# - K15 a row (one block on one SM walks the chunk's rows in order): ~4,000 cycles of that
#   SM's f64 pipes (64 lanes a clock) for the 1,024 bins' hypot, sqrt, division, atan2, cos
#   and sin, ~250 f64 instructions a bin, and ten Stockham passes behind barriers, ~130
#   each: ~5,300.
CHAIN_CYCLES = {"K6": 67, "K7": 16, "K8": 375, "K9": 10000, "K15": 5300}


def _k1(T, hq=True):
    inverse = 10 if hq else 6
    return Work(T * 512 * 2 + T * 8 * _F + _CONSTS["K1"] + T * 512 * 2,
                2 * (16 + inverse) * T * DOTS, "int8",
                f"int8 dots, defined bit for bit: 16 forward, {inverse} inverse "
                f"({'hq' if hq else 'turbo'})")


def _k2(T):
    return Work(T * 512 * 2 + _CONSTS["K2"] + T * _PLANES_FWD, 2 * 16 * T * DOTS, "int8",
                "int8 dots, defined bit for bit: 16 forward")


def _k3(T, hq=True):
    inverse = 10 if hq else 6
    return Work(T * _PLANES_BACK + _CONSTS["K3"] + T * 512 * 2, 2 * inverse * T * DOTS, "int8",
                f"int8 dots, defined bit for bit: {inverse} inverse")


def _k4(T):
    return Work(T * 512 * 2 + _CONSTS["K4"] + T * _PLANES_FWD, K4_FRAME_FLOPS * T, "f32",
                "the function through a real FFT: window, 1024-point real FFT, |X|, "
                "Nyquist, VAD")


def _k5(T):
    return Work(T * _PLANES_BACK + _CONSTS["K5"] + T * 512 * 2,
                (BACK_FRAME_FLOPS + 2 * 512) * T, "f32",
                "bytes: the function (gain, inverse real FFT, OLA) is < 0.01 ms of f32 work")


def _k13(T):
    return Work(T * _PLANES_BACK + _CONSTS["K13"] + T * (2 * 512 + 1) * _F,
                BACK_FRAME_FLOPS * T, "f32",
                "bytes: the function (gain, inverse real FFT) is < 0.01 ms of f32 work")


def _k6(B, T, dtype="f64"):
    size = 8 if dtype == "f64" else 4
    return Work(B * T * 2 * 2 + 7 * 5 * size + 2 * B * 7 * 4 * 2, 9 * 7 * B * T, dtype,
                f"the {dtype} operations the bit-exact cascade fixes: 9 a band and sample",
                *((CHAIN_CYCLES["K6"], T + 12) if dtype == "f64" else (None, None)))


def _k7(B, T):
    return Work(B * T * 4 * 2 + 7 * 5 * 4, 9 * 7 * B * T, "f32",
                "the linear cascade's f32 operations: 9 a band and sample",
                CHAIN_CYCLES["K7"], T + 12)


def _k8(B, T, dtype="f64"):
    size = 8 if dtype == "f64" else 4
    per_tap = 5 if dtype == "f64" else 2  # f32: one product of u and the precomputed g, the add
    return Work(B * T * 2 * 4 + 2 * B * (256 * size + 255 * 2),
                (511 + 5 + per_tap * 256) * B * T, dtype,
                f"the {dtype} operations the recursion fixes: the dot, d and the update",
                *((CHAIN_CYCLES["K8"], T) if dtype == "f64" else (None, None)))


def _k9(B, T, n_open, dtype="f64"):
    size = 8 if dtype == "f64" else 4
    if dtype == "f64":  # window energies (3 a sample, + eps), um (1151), gradient, update
        per_open = 1024 * (3 * 128 + 4) + 1151 + 2 * 128
    else:  # d and g (4 a sample), the gradient (2 a tap and sample), the update
        per_open = 1024 * (2 * 128 + 4) + 2 * 128
    return Work(B * T * 2 * 4 + B * (T // 1024) + 2 * B * (128 * size + 127 * 2),
                2 * 128 * B * T + n_open * per_open, dtype,
                f"the {dtype} operations the recursion fixes, per open gate as counted",
                *((CHAIN_CYCLES["K9"], T // 1024) if dtype == "f64" else (None, None)))


def _k10(N):  # the stream once: a frame's first half is the previous frame's second
    return Work(N * 512 * 2 + N * 12 * _F, MFCC_FRAME_FLOPS * N, "f32",
                "the function through a real FFT: pre-emphasis, window, real FFT, |X|, "
                "mel, log, DCT")


def _k11(T, lo=96):  # the stream once, as K10's
    pairs = T * sum(1024 - k for k in range(lo, 512))
    return Work(T * 512 * 2 + T * (512 - lo) * 8, pairs, "instr",
                "pairs |a - b| summed, one instruction a pair")


def _k12(rows, n, real_input=False):
    planes_in = 1 if real_input else 2
    return Work(rows * n * _F * (planes_in + 2),
                (2.5 if real_input else 5) * n * np.log2(n) * rows, "f32",
                f"the {'real' if real_input else 'complex'} FFT's function: "
                f"{'2.5' if real_input else '5'} n log2 n a row")


def _k14(N):
    return Work(N * 512 * 2 + 512 * _F + N, 6 * 512 * N, "f32",
                "bytes: the VAD's 6 operations a sample")


# K15's carried state (cnt, avg, latched, prev_block, prev_tail, t), in or out
_CHUNK_STATE = 4 + 2 * 1024 * 8 + 512 * 2 + 512 * 8 + 4
# K15's function a row: two 1024-point complex FFTs, the window, the VAD (6 a sample of the
# block), 16 a bin (|X|, the noise step, the gain, atan2, cos, sin and Y, each function one
# operation) and the OLA (2 a sample)
CHUNK_ROW_FLOPS = 2 * 5 * 1024 * 10 + 1024 + 6 * 512 + 16 * 1024 + 2 * 512


def _k15(Tc):
    return Work(Tc * 512 * 2 + 2 * _CHUNK_STATE + 1024 * 8 + 1024 * 2 * 8 + Tc * 512 * 2 + Tc,
                CHUNK_ROW_FLOPS * Tc, "f64",
                "the chunk's f64 function, rows in order on one SM: its chain is the bound",
                CHAIN_CYCLES["K15"], Tc)


KERNELS = {
    "K1": _k1, "K2": _k2, "K3": _k3, "K4": _k4, "K5": _k5,
    "K6": _k6, "K6f32": lambda B, T: _k6(B, T, "f32"),
    "K7": _k7,
    "K8": _k8, "K8f32": lambda B, T: _k8(B, T, "f32"),
    "K9": _k9, "K9f32": lambda B, T, n_open: _k9(B, T, n_open, "f32"),
    "K10": _k10, "K11": _k11, "K12": _k12, "K13": _k13, "K14": _k14, "K15": _k15,
}
