"""The FFT program's float64 reference (FFTAlgorithm_ver2.cpp; counterpart
of ``jeicyboodsp_tpu/oracle/fftprog.py``): its radix-2 transform with the
program's own pi, each element in the C expression order."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import FFT_PI, c_short, stale_blocks


def _bitrev(n):
    """The bit-reversal permutation of 0..n-1 (n a power of two)."""
    bits = n.bit_length() - 1
    k = np.arange(n)
    return sum(((k >> b) & 1) << (bits - 1 - b) for b in range(bits))


def _radix2(re, im, sign):
    """FFTAlgorithm_ver2.cpp:94-149 over the rows of (B, n) float64 planes:
    bit reversal, then per stage the butterflies and the inter-stage
    twiddles with FFT_PI, each element in the C expression order."""
    n = re.shape[1]
    re, im = re[:, _bitrev(n)], im[:, _bitrev(n)]
    npoint = n // 2
    while True:
        n2 = n // npoint
        n1 = n2 // 2
        idx = (n2 * np.arange(npoint)[:, None] + np.arange(n1)[None, :]).ravel()
        ar, ai, br, bi = re[:, idx], im[:, idx], re[:, idx + n1], im[:, idx + n1]
        re[:, idx], im[:, idx] = ar + br, ai + bi
        re[:, idx + n1], im[:, idx + n1] = ar - br, ai - bi
        if npoint == 1:
            return re, im
        nn = np.tile(np.arange(n2), npoint // 2)
        idx2 = (np.arange(npoint // 2)[:, None] * 2 * n2 + n2 + np.arange(n2)[None, :]).ravel()
        ang = sign * 2.0 * FFT_PI * nn / float(2 * n2)
        c, s = np.cos(ang), np.sin(ang)
        tr, ti = re[:, idx2], im[:, idx2]
        re[:, idx2], im[:, idx2] = c * tr - s * ti, c * ti + s * tr
        npoint //= 2


def reference_fft_roundtrip(x):
    """float64 numpy reference of FFTAlgorithm_ver2.cpp: 512-sample blocks
    (a partial last block keeps the previous block's stale tail), its
    radix-2 FFT forward and backward, / 512, double -> short."""
    blocks = stale_blocks(x, 512).astype(np.float64)
    if not len(blocks):
        return np.zeros(0, np.int16)
    Xr, Xi = _radix2(blocks, np.zeros_like(blocks), -1.0)
    yr, _ = _radix2(Xr, Xi, 1.0)
    return c_short(yr / 512.0).reshape(-1)


run = reference_fft_roundtrip
