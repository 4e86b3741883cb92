"""The MFCC program's float64 reference
(MFCCFeatureExtraction_auto_version1.cpp; counterpart of
``jeicyboodsp_tpu/oracle/mfcc.py``)."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI, stale_blocks

MFCC_MEL, MFCC_CEP = 38, 12


def mfcc_tables():
    """float64 (512, 38) mel weights and (38, 12) DCT-II + lifter matrix of
    MFCCFeatureExtraction_auto_version1.cpp: the mel filterbank built from
    equal splits of the 0..22050 Hz mel axis (:118-152), a triangular weight
    per bin towards the next channel edge (:154-174), DCT over channels 1..38
    with sqrt(2/38), sinusoidal lifter L = 22 (:176-192)."""
    unit = 1127.0 * np.log(1 + 22050.0 / 700.0) / (MFCC_MEL + 1)
    edges = 700.0 * (np.exp(unit * np.arange(1, MFCC_MEL + 2) / 1127.0) - 1.0)
    f = np.arange(512) / 511 * 22050.0
    bins, k = np.zeros(512, np.int64), 0
    for i in range(512):
        if f[i] > edges[k] and k < MFCC_MEL:
            k += 1
        bins[i] = k
    lower = np.where(bins == 0, 0.0, edges[np.maximum(bins - 1, 0)])
    fb = np.maximum((edges[bins] - f) / (edges[bins] - lower), 0.0)
    M = np.zeros((512, MFCC_MEL))
    for i in range(512):
        if bins[i] == 0:
            M[i, 0] += 1 - fb[i]
        else:
            M[i, bins[i] - 1] += fb[i]
            if bins[i] != MFCC_MEL:
                M[i, bins[i]] += 1 - fb[i]
    i, k = np.arange(1, MFCC_CEP + 1)[None, :], np.arange(1, MFCC_MEL + 1)[:, None]
    lift = 1 + 0.5 * 22 * np.sin(REF_PI * np.arange(1, MFCC_CEP + 1) / 22)
    D = np.sqrt(2.0 / MFCC_MEL) * np.cos(REF_PI * i * (k - 0.5) / MFCC_MEL) * lift[None, :]
    return M, D


def reference_mfcc_frames(frames):
    """float64 MFCC of (F, 1024) int16 frames: pre-emphasis 0.96 from i = 1
    (frame[0] stays 0), the Hamming window with REF_PI, |FFT| of bins
    0..511, mel, log (log 0 = -inf), DCT + lifter."""
    M, D = mfcc_tables()
    f = frames.astype(np.float64)
    pre = np.zeros_like(f)
    pre[:, 1:] = f[:, 1:] - 0.96 * f[:, :-1]
    w = 0.54 - 0.46 * np.cos(2.0 * REF_PI * np.arange(1024) / 1023)
    X = np.fft.fft(pre * w, axis=1)[:, :512]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(np.sqrt(X.real ** 2 + X.imag ** 2) @ M) @ D


def reference_mfcc(x, skip_first=True):
    """MFCCFeatureExtraction_auto_version1.cpp on one signal: 1024-sample
    blocks (a partial last block keeps the previous block's stale tail), two
    frames per block at hop 512 over [keep, block], the run's first frame
    skipped (:95-97)."""
    flat = np.concatenate([np.zeros(512, np.int16), stale_blocks(x, 1024).reshape(-1)])
    n = len(flat) // 512 - 1
    frames = flat[np.arange(n)[:, None] * 512 + np.arange(1024)[None, :]]
    feats = reference_mfcc_frames(frames)
    return feats[1:] if skip_first else feats


run = reference_mfcc
