"""The RIR fast convolution's float64 reference
(Fast_Convolution_Based_3DAudio_Impl.cpp; counterpart of
``jeicyboodsp_tpu/oracle/fastconv.py``).  The RIR is read in place from the
repository's sparse table, ``jeicyboodsp_tpu/data/rir_coefficients.npz``."""

from __future__ import annotations

import os

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import c_short, stale_blocks

FC_BLOCK, FC_FFT, FC_TAPS, FC_WARMUP = 1024, 8192, 7169, 7  # Fast_Convolution...cpp
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DATA = os.path.join(_ROOT, "jeicyboodsp_tpu", "data", "rir_coefficients.npz")


def load_rir():
    """The 7169-tap RIR, from the repository's sparse table (FilterCoefficient.h)."""
    d = np.load(_DATA)
    h = np.zeros(int(d["length"]))
    h[d["indices"]] = d["values"]
    return h


def reference_fastconv(x, h=None):
    """float64 numpy reference of Fast_Convolution_Based_3DAudio_Impl.cpp:
    1024-sample blocks (stale tails), the first 7 never stored (the queue
    holds zeros), then per block the 8192-point segment of the 7 queued
    blocks and the block: FFT times FFT(h) (``h`` the RIR unless given),
    IFFT, samples [7168, 8192) to short."""
    blocks = stale_blocks(x, FC_BLOCK).astype(np.float64)
    if len(blocks) <= FC_WARMUP:
        return np.zeros(0, np.int16)
    H = np.fft.fft(load_rir() if h is None else h, FC_FFT)
    flat = blocks.reshape(-1)
    flat[:FC_WARMUP * FC_BLOCK] = 0.0
    out = [c_short(np.fft.ifft(np.fft.fft(flat[s: s + FC_FFT]) * H).real[FC_TAPS - 1:])
           for s in range(0, len(flat) - FC_FFT + 1, FC_BLOCK)]
    return np.concatenate(out)


run = reference_fastconv
