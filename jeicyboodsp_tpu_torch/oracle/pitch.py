"""The pitch programs' float64 reference (PitchEstimation_method{1,2,3}.cpp;
counterpart of ``jeicyboodsp_tpu/oracle/pitch.py``)."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import stale_blocks


FS = 16000.0


def reference_pitch_frames(frames, method):
    """PitchEstimation_method{1,2,3}.cpp on (T, 1024) int16 frames [previous
    block, block]: the autocorrelation by FFT (1), the AMDF (2) or the
    direct autocorrelation (3) over lags 0..511, each lag's integer sum as
    a double divided by 1024 - k (2, 3); the descending scan from 511 to 101
    keeps the smallest lag at the extremum.  Returns lag, value, f0."""
    u = frames.astype(np.int64)
    if method == 1:
        X = np.fft.fft(u.astype(np.float64), axis=1)
        ac = np.fft.ifft(X.real ** 2 + X.imag ** 2, axis=1).real[:, :512]
    else:
        ac = np.stack([(np.abs(u[:, :1024 - k] - u[:, k:]) if method == 2
                        else u[:, :1024 - k] * u[:, k:]).sum(1) / (1024 - k)
                       for k in range(512)], 1)
    sl = ac[:, 101:]
    ext = sl.min(1) if method == 2 else sl.max(1)
    lag = 101 + np.argmax(sl == ext[:, None], 1)
    return lag, ext, FS / lag


def reference_pitch(x, method):
    """The pitch program on one signal: 512-sample blocks with stale tails,
    frames [previous block, block]; nothing for an empty payload."""
    blocks = stale_blocks(x, 512)
    if not len(blocks):
        return np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
    prev = np.concatenate([np.zeros((1, 512), np.int16), blocks[:-1]])
    return reference_pitch_frames(np.concatenate([prev, blocks], 1), method)


def run(x, method):
    """The program on one int16 signal: (lag, value, f0) per block, as the
    JAX oracle's list."""
    lag, val, f0 = reference_pitch(x, method)
    return [(int(k), float(v), float(f)) for k, v, f in zip(lag, val, f0)]
