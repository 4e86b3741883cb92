"""The Wiener / spectral-subtraction chain's float64 reference
(WienerFilter_final.cpp / SpectralSubtraction_final.cpp), a frozen copy of
the reference's semantics in plain PyTorch, quirks included.

:func:`reference_enhance_rows` runs on any device, in blocks of rows, so
that an hour at 16 kHz (112,500 blocks) fits: on the host its FFT is
PyTorch's CPU FFT, on a card cuFFT, so it agrees with a NumPy float64 copy
to rounding.  The noise latch, the one sequential stage, runs row by row in
NumPy float64 over the rows that move it.

``precision`` (see :mod:`portbench.reference.precision`) makes the control:
``"float32"`` computes the FFTs in complex64 and rounds every stage's values
to float32; ``"bfloat16"`` does the same with the stages' values rounded to
bfloat16 (no FFT runs in bfloat16, so its sums are float32's).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.cnum import c_short_torch, hamming
from portbench.reference.precision import rounder, rounder_torch

NOISE_FRAMES = 10


def _speech_rows(blocks, w2, q):
    """The VAD of (n, 512) int16 blocks: True for speech."""
    import torch

    raw = blocks.to(torch.int64)
    s = c_short_torch(q(raw.to(torch.float64) * w2)).to(torch.int64)
    energy = q((s.to(torch.float64) ** 2).sum(1) / 1024)  # exact integers in float64
    zcr = ((s[:, :-1] * raw[:, 1:]) < 0).sum(1)
    return (energy > 700.0) | (zcr < 200.0)


def _spectrum(blocks, prev, w, q, ctype):
    """X of the frames [prev, cur] of (n, 512) blocks, prev the block before,
    the FFT computed in ``ctype``."""
    import torch

    frames = torch.cat([torch.cat([prev[None], blocks[:-1]]), blocks], 1).to(torch.float64)
    return q(torch.fft.fft(q(frames * w).to(ctype)).to(torch.complex128))


def reference_enhance_rows(blocks, mode="wiener", precision=None, rows=8192):
    """The chain over one recording's (T, 512) int16 blocks, on their
    device, ``rows`` blocks at a time: the VAD on [zeros, x] (E > 700 or
    ZCR < 200), the 10-frame noise latch, the gain with saved phase, the
    512-shift OLA, double -> short truncation.  Returns the (T - 2, 512)
    int16 rows written (t >= 2)."""
    import torch

    q, qn = rounder_torch(precision), rounder(precision)
    ctype = torch.complex128 if precision in (None, "float64") else torch.complex64
    dev = blocks.device
    T = blocks.shape[0]
    w_np = hamming()
    w = torch.from_numpy(w_np).to(dev)
    w2 = w[512:]
    zero = torch.zeros(512, dtype=blocks.dtype, device=dev)
    speech = torch.cat([_speech_rows(blocks[a:a + rows], w2, q) for a in range(0, T, rows)])
    # the run counts: cnt[t] = rows since the last speech row (0 on speech)
    idx = torch.arange(T, device=dev)
    last = torch.cummax(torch.where(speech, idx, torch.full_like(idx, -1)), 0).values
    cnt = torch.where(speech, 0, idx - last)
    noise = cnt >= 2
    # the running average, row by row on the host over the rows that move it
    avg = np.zeros(1024)
    snaps = []
    cnt_h = cnt.cpu().numpy()
    for a in range(0, T, rows):
        nrows = torch.nonzero(noise[a:a + rows]).flatten()
        if not len(nrows):
            continue
        prev = blocks[a - 1] if a else zero
        X = _spectrum(blocks[a:a + rows], prev, w, q, ctype)
        mags = q(X[nrows].abs()).cpu().numpy()
        for r, t in enumerate((nrows + a).tolist()):
            avg = qn(avg + mags[r])
            if cnt_h[t] >= 3:
                avg = qn(avg / 2.0)
            if cnt_h[t] == NOISE_FRAMES:
                snaps.append(avg.copy())
    latch = (cnt == NOISE_FRAMES)
    k = torch.cumsum(latch.to(torch.int64), 0) - 1  # the latest latch row <= t
    table = torch.from_numpy(np.array([np.zeros(1024)] + snaps)).to(dev)
    out = torch.empty((max(T - 2, 0), 512), dtype=torch.int16, device=dev)
    tail = None
    for a in range(0, T, rows):
        b = min(a + rows, T)
        prev = blocks[a - 1] if a else zero
        X = _spectrum(blocks[a:b], prev, w, q, ctype)
        ns = table[k[a:b] + 1]
        if mode == "wiener":
            P = q(X.real ** 2 + X.imag ** 2)
            v = q(ns ** 2 / P)
            amp = q(torch.sqrt(P).abs() * (1.0 - torch.where(v >= 1.0, 1.0, v)))
        else:
            amp = q(q(X.abs()) - ns)
        phase = q(torch.atan2(X.imag, X.real))
        Y = torch.complex(q(amp * torch.cos(phase)), q(amp * torch.sin(phase)))
        y = q(torch.fft.ifft(Y.to(ctype)).real.to(torch.float64))
        tails = torch.cat([y[:1, 512:] if tail is None else tail[None], y[:-1, 512:]])
        ola = c_short_torch(q(tails + y[:, :512]))
        t = torch.arange(a, b, device=dev)
        keep = t >= 2
        out[t[keep] - 2] = ola[keep]
        tail = y[-1, 512:]
    return out
