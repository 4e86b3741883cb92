"""The enhancement chain's float64 reference (WienerFilter_final.cpp /
SpectralSubtraction_final.cpp; counterpart of ``jeicyboodsp_tpu/oracle/
enhance.py``)."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import c_short


def reference_enhance(x, mode="wiener"):
    """float64 numpy reference of WienerFilter_final.cpp /
    SpectralSubtraction_final.cpp: 512-sample blocks (a partial last block
    keeps the previous block's stale tail), VAD on [zeros, x], the
    10-frame noise latch, the gain with saved phase, 512-shift OLA, output
    from the third block on, double -> short truncation."""
    x = np.asarray(x, np.int16)
    if len(x) == 0:
        return np.zeros(0, np.int16)
    T = -(-len(x) // 512)
    xb = np.zeros(T * 512, np.int16)
    xb[: len(x)] = x
    blocks = xb.reshape(T, 512)
    if len(x) % 512 and T > 1:
        blocks[-1, len(x) % 512:] = blocks[-2, len(x) % 512:]
    w = 0.54 - 0.46 * np.cos(2.0 * 3.141592 * np.arange(1024) / 1023)
    raw = blocks.astype(np.int64)
    s = c_short(raw * w[512:]).astype(np.int64)
    energy = np.sum(s.astype(np.float64) ** 2, axis=1) / 1024
    zcr = np.sum(s[:, :-1] * raw[:, 1:] < 0, axis=1)
    speech = (energy > 700.0) | (zcr < 200.0)
    prev = np.concatenate([np.zeros((1, 512), np.int16), blocks[:-1]])
    X = np.fft.fft(np.concatenate([prev, blocks], axis=1).astype(np.float64) * w, axis=1)
    mags = np.abs(X)
    latched = np.zeros((T, 1024))
    cnt, avg, lat = 0, np.zeros(1024), np.zeros(1024)
    for t in range(T):
        cnt = 0 if speech[t] else cnt + 1
        if cnt >= 2:
            avg = avg + mags[t]
            if cnt >= 3:
                avg = avg / 2.0
            if cnt == 10:
                lat = avg.copy()
        latched[t] = lat
    with np.errstate(divide="ignore", invalid="ignore"):
        if mode == "wiener":
            P = X.real ** 2 + X.imag ** 2
            v = latched ** 2 / P
            amp = np.abs(np.sqrt(P)) * (1.0 - np.where(v >= 1.0, 1.0, v))
        else:
            amp = mags - latched
    phase = np.arctan2(X.imag, X.real)
    y = np.fft.ifft(amp * np.cos(phase) + 1j * amp * np.sin(phase), axis=1).real
    out = c_short(y[1:-1, 512:] + y[2:, :512])  # written from t = 2 on
    return out.reshape(-1)


run = reference_enhance
