"""2-mic MVDR beamformer in torch (counterpart of ``jeicyboodsp_tpu/ops/mvdr.py``,
with its own copy of the constants of ``jeicyboodsp_tpu/oracle/mvdr.py``).

Reference: ``BeamForming_MVDR_ver1.cpp``.  Every per-block stage is a pure
function of (x[t-1], x[t]) -- the VAD is stateless, the spatial-correlation
pair is always the previous and current block, and the analysis frame's keep
buffer is the previous block's first 511 samples -- so the only sequential
element, the cumulative 2x2 correlation matrix, is an inclusive prefix sum.
The chain:

  batched VAD -> per-block R contributions (batched unwindowed FFTs)
  -> masked cumsum of 2x2 matrices -> per-(block, bin) closed-form 2x2
  MVDR weights -> batched frame FFT, weight application (reproducing the
  reference's overwrite-sequencing quirk), batched IFFT -> int16.

Engine ``xla`` runs the transforms as ``torch.fft`` (complex128 / complex64),
an ``mxu*`` engine as matmul DFTs (``ops.dft``) in the data's dtype; the JAX
package computes both as plain XLA outside any Pallas kernel, so torch ops on
the card are their port.  No kernel runs here.  Entry points run on a CUDA
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.ops import dft as D
from jeicyboodsp_tpu_torch.ops.enhance import _run_counts
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI, c_short, hamming_ref
from jeicyboodsp_tpu_torch.utils.device import entry_device

BLOCK_LEN = 512  # oracle/mvdr.py:36-42
KEEP_LEN = 511
FFT_LEN = 1024
THRESHOLD_OF_ENERGY = 700.0
SAMPLING_RATE = 16000.0
SPEED_OF_SOUND = 34000.0
DISTANCE_OF_MIC = 800.0


def vad_energy_flags(blocks, dtype=torch.float64):
    """(T, 512) -> (T,) bool speech flags (energy-only MVDR VAD, :207-242):
    the block sits at samples 511..1022 of a zero frame, so it meets the
    window's samples 511..1022; int16 in-place truncation as the other VADs."""
    wseg = hamming_ref(FFT_LEN, dtype, blocks.device)[KEEP_LEN: KEEP_LEN + BLOCK_LEN]
    s = c_short(blocks.to(dtype) * wseg).to(dtype)
    energy = torch.sum(s * s, dim=-1) / FFT_LEN
    return energy > THRESHOLD_OF_ENERGY


def previous_blocks(blocks):
    """x[t-1] for each block t, zeros before the first."""
    return torch.cat([torch.zeros_like(blocks[:1]), blocks[:-1]])


def _pairs(blocks, dtype):
    """(T, 1024) [x[t-1], x[t]] in ``dtype``, zeros before the first block."""
    return torch.cat([previous_blocks(blocks), blocks], 1).to(dtype)


def analysis_frames(prev, blocks, dtype):
    """(T, 1024) analysis frames in ``dtype``: [the previous block's first
    511 samples (the keep buffer), the current block, 0]."""
    return torch.nn.functional.pad(torch.cat([prev[:, :KEEP_LEN], blocks], 1).to(dtype), (0, 1))


def covariance_terms(Lr, Li, Rr, Ri):
    """(T, 4) [r00, r01, r10, r11]: each block pair's spatial-correlation
    terms from the two channels' spectra over the bins given, divided by
    FFT_LEN.  The division is exact (a power of two), so partial terms over
    slices of the bins sum to the whole."""
    return torch.stack([torch.sum(Lr ** 2 + Li ** 2, 1), torch.sum(-Lr * Ri + Li * Rr, 1),
                        torch.sum(-Rr * Li + Ri * Lr, 1), torch.sum(Rr ** 2 + Ri ** 2, 1)],
                       1) / FFT_LEN


def mvdr_weights(R, bins, d_time, dtype):
    """Complex (T, len(bins)) weights w0, w1 = R^-1 c / (c^H R^-1 c) at the
    given bin indices, from each block's accumulated (T, 4) R through its
    closed-form 2x2 inverse (singular -> inf/nan, as an unchecked LU); the
    steering vector is c = [1, e^{j 2 pi f d_time}]."""
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    a, b, c_, d = R.unbind(1)
    inv = torch.stack([d, -b, -c_, a], 1) / (a * d - b * c_)[:, None]
    ang = 2.0 * REF_PI * bins.to(dtype) * (SAMPLING_RATE / FFT_LEN) * d_time
    c0 = torch.ones(bins.shape[0], dtype=ctype, device=R.device)
    c1 = torch.complex(torch.cos(ang), torch.sin(ang))
    w0 = inv[:, 0, None] * c0 + inv[:, 1, None] * c1
    w1 = inv[:, 2, None] * c0 + inv[:, 3, None] * c1
    denom = c0.conj() * w0 + c1.conj() * w1
    return w0 / denom, w1 / denom


def beamform(Lr, Li, Rr, Ri, w0, w1):
    """(re, im) of the merged spectrum: each channel's frame spectrum times
    its conjugated weight (:175-178), reproducing the reference's
    overwrite-sequencing quirk (:180-183), where the updated real part feeds
    the imaginary one."""
    wl_r, wl_i = w0.real, -w0.imag
    wr_r, wr_i = w1.real, -w1.imag
    L0 = Lr * wl_r - Li * wl_i
    L1 = L0 * wl_i + Li * wl_r
    R0 = Rr * wr_r - Ri * wr_i
    R1 = R0 * wr_i + Ri * wr_r
    return L0 + R0, L1 + R1


def _spectrum(x, ctype, fft_engine):
    """(re, im) of the full 1024-bin DFT of real rows x: for an ``mxu*``
    engine the matmul DFT at its tier, else ``torch.fft``."""
    if fft_engine.startswith("mxu"):
        return D.cdft_of_real_full(x, fft_engine)
    X = torch.fft.fft(x.to(ctype))
    return X.real, X.imag


def mvdr_blocks(blocks_l, blocks_r, d_time: float = 0.0, dtype=torch.float64,
                fft_engine: str = "xla", collapse: bool = True):
    """(T, 512) int16 per channel -> ((T, 512) int16, write_mask (T,)), on
    the blocks' device.

    For the reference's steering (theta = 0, ``:57-60`` -> d_time = 0, c = [1,
    1] at every bin) an ``mxu*`` engine takes the structural collapse of the
    JAX op: for real inputs the broadband off-diagonal correlation is exactly
    zero (Parseval), so R is diagonal, the weights are real per-block scalars
    w0 = d/(a+d), w1 = a/(a+d) with a, d the accumulated channel energies,
    the sequencing quirk is a no-op for real weights, and y = w0*l + w1*r --
    no transforms.  ``collapse=False`` forces the spectral path at theta = 0.
    """
    if fft_engine != "xla" and not fft_engine.startswith("mxu"):
        raise ValueError(f"fft_engine must be 'xla' or an mxu engine, got {fft_engine!r}")
    T = blocks_l.shape[0]
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    use_mxu = fft_engine.startswith("mxu")
    write_mask = torch.arange(T, device=blocks_l.device) >= 1

    # consecutive-noise run length; noise blocks after the first of a run accumulate
    _, accumulate = _run_counts(vad_energy_flags(blocks_l, dtype))
    acc_f = accumulate.to(dtype)
    pairs_l, pairs_r = _pairs(blocks_l, dtype), _pairs(blocks_r, dtype)

    if use_mxu and float(d_time) == 0.0 and collapse:
        a = torch.cumsum(torch.sum(pairs_l * pairs_l, 1) * acc_f, 0)  # Parseval
        d = torch.cumsum(torch.sum(pairs_r * pairs_r, 1) * acc_f, 0)
        denom = a + d
        w0, w1 = d / denom, a / denom  # 0/0 -> NaN before any accumulation
        # the emitted slice frame[511:1023] is the current block: no keep buffer
        y = w0[:, None] * blocks_l.to(dtype) + w1[:, None] * blocks_r.to(dtype)
        return c_short(y), write_mask

    Lfr, Lfi = _spectrum(pairs_l, ctype, fft_engine)
    Rfr, Rfi = _spectrum(pairs_r, ctype, fft_engine)
    R = torch.cumsum(covariance_terms(Lfr, Lfi, Rfr, Rfi) * acc_f[:, None], 0)  # (T, 4)
    w0, w1 = mvdr_weights(R, torch.arange(FFT_LEN, device=blocks_l.device), d_time, dtype)

    frames_l = analysis_frames(previous_blocks(blocks_l), blocks_l, dtype)
    frames_r = analysis_frames(previous_blocks(blocks_r), blocks_r, dtype)
    Lr, Li = _spectrum(frames_l, ctype, fft_engine)
    Rr, Ri = _spectrum(frames_r, ctype, fft_engine)
    re, im = beamform(Lr, Li, Rr, Ri, w0, w1)
    if use_mxu:  # the merged spectrum is not Hermitian: the full-bin real-part inverse
        y = D.icdft_real(re, im, fft_engine)
    else:
        y = torch.fft.ifft(torch.complex(re, im)).real
    return c_short(y[:, KEEP_LEN: KEEP_LEN + BLOCK_LEN]), write_mask


def steering_delay(angle_rad: float = 0.0) -> float:
    """dTime = (d/c) * sin(theta) (BeamForming_MVDR_ver1.cpp:60)."""
    return (DISTANCE_OF_MIC / SPEED_OF_SOUND) * float(np.sin(angle_rad))


def run_stream(xl, xr, d_time=0.0, dtype=torch.float64, fft_engine: str = "xla",
               collapse: bool = True, device="cuda"):
    """Host convenience: both channels in, the reference's byte stream out.
    Both are cut to the shorter length and blocked with the stale tail (a
    partial last block keeps the previous block's samples); the first block's
    output is not written.  Runs on ``device``, a CUDA card unless the caller
    asks for the CPU."""
    dev = entry_device(device)
    xl, xr = np.asarray(xl, np.int16), np.asarray(xr, np.int16)
    n = min(len(xl), len(xr))
    if n == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)
    bl, br = (torch.from_numpy(stale_blocks(x[:n], BLOCK_LEN)).to(dev) for x in (xl, xr))
    out, mask = mvdr_blocks(bl, br, d_time, dtype=dtype, fft_engine=fft_engine,
                            collapse=collapse)
    return out[mask].reshape(-1).cpu().numpy()
