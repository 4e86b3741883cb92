"""Speech features: MFCC, LPC and pitch (counterpart of
``jeicyboodsp_tpu/ops/features.py``, with its own copies of the constants and
the mel filterbank of ``jeicyboodsp_tpu/oracle/mfcc.py`` and the constants of
``jeicyboodsp_tpu/oracle/lpc.py`` and ``oracle/pitch.py``).

References: ``MFCCFeatureExtraction_auto_version1.cpp``,
``LPCEstimation.cpp``, ``PitchEstimation_method{1,2,3}.cpp``.  No extractor
carries state across blocks beyond a keep buffer equal to the previous
block, so every frame goes through one batched pass:

- MFCC: pre-emphasis, Hamming window, 1024-point DFT magnitude, 38-channel
  mel, log, DCT-II with liftering.  :func:`mfcc_frames` runs it as torch ops
  (``torch.fft`` for engine ``xla``, the matmul DFT of :mod:`.dft` for the
  ``mxu*`` engines); :func:`mfcc_blocks` with ``mxu3``/``mxu8`` in f32 goes
  through K10 (:mod:`~jeicyboodsp_tpu_torch.kernels.mfcc_fused`).
- Pitch: a lag search over [101, 511] on the autocorrelation (methods 1, 3)
  or the AMDF (method 2); method 2 on an ``mxu*`` engine goes through K11
  (:mod:`~jeicyboodsp_tpu_torch.kernels.amdf`).

- LPC: Hamming window over [previous block, block], the biased
  autocorrelation lags 0..12, and the 12x12 Toeplitz Yule-Walker system,
  solved by ``torch.linalg.solve`` or by the Levinson-Durbin recursion
  (:func:`lpc_frames`), torch ops throughout as in JAX (no kernel).

The whole-signal entry points (:func:`mfcc_run`, :func:`lpc_run`,
:func:`pitch_run`) run on a CUDA card unless the caller passes
``device="cpu"``, which runs the kernels' plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels.amdf import amdf
from jeicyboodsp_tpu_torch.kernels.mfcc_fused import mfcc_fused
from jeicyboodsp_tpu_torch.ops import dft
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI, hamming_ref
from jeicyboodsp_tpu_torch.utils.device import entry_device

LPC_LEN = 12  # LPCEstimation.cpp (oracle/lpc.py:27-28)
LPC_BLOCK = 256


def hamming(n, dtype=torch.float64, device=None):
    """The reference's Hamming window 0.54 - 0.46 cos(2 REF_PI i / (n - 1)),
    computed in float64 with numpy (whose cos is the oracle's and, on the
    CPU, JAX's; torch's differs by an ulp, which the LPC systems' condition
    would amplify) and rounded to ``dtype``."""
    i = np.arange(n, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * REF_PI * i / (n - 1))
    return torch.from_numpy(w).to(dtype=dtype, device=device)


# MFCCFeatureExtraction_auto_version1.cpp (oracle/mfcc.py:28-36)
MFCC_LEN = 12
BLOCK_LEN = 1024
WINDOW_LEN = 1024
KEEP_LEN = 512
CHANNEL = 38
LIFTER_LEN = 22
HALF_SAMPLING_RATE = 22050.0
PRE_EMPHASIS = 0.96

# PitchEstimation_method*.cpp (oracle/pitch.py:20-22)
BLOCK = 512
PROC = 1024
FS = 16000.0

AMDF_LO = 96  # K11's first lag on the pitch path: the multiple of 8 below 101


def mel_filterbank_init():
    """MelFilterBankInit (:118-152): returns (filterbank (512,), bins (512,))."""
    unit = 1127.0 * np.log(1 + HALF_SAMPLING_RATE / 700.0) / (CHANNEL + 1)
    mel_freqs = np.zeros(CHANNEL + 1)
    for i in range(1, CHANNEL + 2):
        mel_freqs[i - 1] = 700.0 * (np.exp(unit * i / 1127.0) - 1.0)

    bins = np.zeros(KEEP_LEN, dtype=np.int64)
    k = 0
    for i in range(KEEP_LEN):
        if (i / (KEEP_LEN - 1)) * HALF_SAMPLING_RATE > mel_freqs[k]:
            if k < CHANNEL:
                k += 1
        bins[i] = k

    fb = np.zeros(KEEP_LEN)
    for i in range(KEEP_LEN):
        b = bins[i]
        f = (i / (KEEP_LEN - 1)) * HALF_SAMPLING_RATE
        if b == 0:
            fb[i] = (mel_freqs[0] - f) / (mel_freqs[0] - 0.0)
        else:
            fb[i] = (mel_freqs[b] - f) / (mel_freqs[b] - mel_freqs[b - 1])
        if fb[i] < 0:
            fb[i] = 0.0
    return fb, bins


# ---------------------------------------------------------------------------
# MFCC
# ---------------------------------------------------------------------------


def mel_matrix(dtype=np.float64):
    """(512, 38) sparse-triangular mel weights as a dense matmul operand.

    Row i contributes fb[i] to channel bins[i]-1 and (1-fb[i]) to channel
    bins[i] (oracle.mfcc.mel_apply).
    """
    fb, bins = mel_filterbank_init()
    M = np.zeros((KEEP_LEN, CHANNEL), dtype=dtype)
    for i in range(KEEP_LEN):
        k = bins[i]
        if k == 0:
            M[i, 0] += 1 - fb[i]
        else:
            M[i, k - 1] += fb[i]
            if k != CHANNEL:
                M[i, k] += 1 - fb[i]
    return M


def dct_lifter_matrix(dtype=np.float64):
    """(38, 12) combined DCT-II + liftering matrix."""
    i = np.arange(1, MFCC_LEN + 1)[None, :]
    k = np.arange(1, CHANNEL + 1)[:, None]
    basis = np.sqrt(2.0 / CHANNEL) * np.cos(REF_PI * i * (k - 0.5) / CHANNEL)
    lift = 1 + 0.5 * LIFTER_LEN * np.sin(REF_PI * np.arange(1, MFCC_LEN + 1) / LIFTER_LEN)
    return (basis * lift[None, :]).astype(dtype)


@functools.lru_cache(maxsize=8)
def mel_dct(dtype, device):
    """The mel and DCT+lifter matrices as tensors of ``dtype`` on ``device``,
    built once per (dtype, device): callers must not modify them."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    return (torch.from_numpy(mel_matrix(npd)).to(device),
            torch.from_numpy(dct_lifter_matrix(npd)).to(device))


def mfcc_frames(frames, mel_m, dct_m, dtype=torch.float64, fft_engine: str = "xla"):
    """(F, 1024) int16 analysis frames -> (F, 12) MFCC features in ``dtype``.

    Each frame is [x[i-1] history ... current] as framed by the caller; the
    pre-emphasis + window + DFT + mel + DCT pipeline matches the oracle.
    ``mxu*`` engines run the DFT as matmuls (:func:`.dft.rdft`); ``xla``
    runs ``torch.fft`` (complex128 in f64, ``rfft`` in f32).
    """
    f = frames.to(dtype)
    pre = torch.cat([torch.zeros_like(f[:, :1]), f[:, 1:] - PRE_EMPHASIS * f[:, :-1]], 1)
    windowed = pre * hamming_ref(WINDOW_LEN, dtype).to(f.device)  # built on the host: exact division
    if fft_engine.startswith("mxu"):
        re, im = dft.rdft(windowed)
        xr, xi = re[:, :KEEP_LEN], im[:, :KEEP_LEN]
    else:
        X = (torch.fft.fft(windowed.to(torch.complex128)) if dtype == torch.float64
             else torch.fft.rfft(windowed))[:, :KEEP_LEN]
        xr, xi = X.real, X.imag
    mag = torch.sqrt(xr ** 2 + xi ** 2)
    return torch.log(mag @ mel_m) @ dct_m


def mfcc_blocks(blocks, mel_m, dct_m, dtype=torch.float32, fft_engine: str = "xla"):
    """MFCC over (..., T, 1024) int16 blocks -> (..., 2T, 12).

    Two 512-hop frames per block from the in-signal keep buffer (zeros
    before t = 0).  ``mxu3`` and ``mxu8`` in f32 go through K10 (``mxu8``
    aliases ``mxu3``, as in the JAX package: the int8 variant measured
    54.8 dB there), which uses its own constants and not ``mel_m``/``dct_m``;
    anything else goes through :func:`mfcc_frames`.
    """
    *lead, T, B = blocks.shape
    flat = blocks.reshape(*lead, T * B)
    flat = torch.cat([torch.zeros(*lead, KEEP_LEN, dtype=blocks.dtype, device=blocks.device),
                      flat], -1)
    rows = flat.reshape(*lead, 2 * T + 1, KEEP_LEN)  # frame f = rows[f] ++ rows[f+1]
    if fft_engine in ("mxu3", "mxu8") and dtype == torch.float32:
        prev = rows[..., :-1, :].reshape(-1, KEEP_LEN)  # views for one stream
        cur = rows[..., 1:, :].reshape(-1, KEEP_LEN)
        return mfcc_fused(prev, cur).reshape(*lead, 2 * T, MFCC_LEN)
    frames = torch.cat([rows[..., :-1, :], rows[..., 1:, :]], -1)
    feats = mfcc_frames(frames.reshape(-1, WINDOW_LEN), mel_m, dct_m, dtype=dtype,
                        fft_engine=fft_engine)
    return feats.reshape(*frames.shape[:-1], MFCC_LEN)


def mfcc_run(x, dtype=torch.float64, skip_first: bool = True, fft_engine: str = "xla",
             device="cuda"):
    """Whole-signal MFCC matching ``oracle.mfcc.run`` framing -> (F, 12)
    numpy features of ``dtype``."""
    dev = entry_device(device)
    blocks = stale_blocks(x, BLOCK_LEN)
    if not len(blocks):  # an empty payload: no frames (torch.fft refuses empty batches)
        return torch.zeros(0, MFCC_LEN, dtype=dtype).numpy()
    flat = np.concatenate([np.zeros(KEEP_LEN, np.int16), blocks.reshape(-1)])
    starts = np.arange(2 * len(blocks)) * KEEP_LEN  # two frames per block at hop 512
    frames = flat[starts[:, None] + np.arange(WINDOW_LEN)[None, :]]
    feats = mfcc_frames(torch.from_numpy(frames).to(dev), *mel_dct(dtype, dev), dtype=dtype,
                        fft_engine=fft_engine).cpu().numpy()
    return feats[1:] if skip_first else feats


# ---------------------------------------------------------------------------
# Pitch
# ---------------------------------------------------------------------------


def lpc_frames(frames, dtype=torch.float64, solver: str = "solve"):
    """(F, 512) int16 analysis windows -> (F, 12) LPC coefficients, on the
    frames' device.

    solver="solve" solves the 12x12 Toeplitz system of the reference's
    explicit inverse (LPCEstimation.cpp:115-126) with ``torch.linalg.solve``
    (LU); solver="levinson" runs the Levinson-Durbin recursion in 12 steps
    of elementwise ops over all frames (the same solution up to rounding)."""
    if solver not in ("solve", "levinson"):
        raise ValueError(f"solver must be 'solve' or 'levinson', got {solver!r}")
    F, n = frames.shape
    win = frames.to(dtype) * hamming(n, dtype, frames.device)
    r = torch.stack([(win[:, :n - lag] * win[:, lag:]).sum(1) / (n - lag)
                     for lag in range(LPC_LEN + 1)], 1)  # (F, 13)
    if solver == "levinson":
        a = torch.zeros(F, LPC_LEN, dtype=dtype, device=frames.device)
        e = r[:, 0]
        for m in range(1, LPC_LEN + 1):
            acc = r[:, m]
            for j in range(1, m):
                acc = acc + a[:, j - 1] * r[:, m - j]
            k = -acc / e
            new_a = a.clone()
            new_a[:, m - 1] = k
            if m > 1:
                new_a[:, : m - 1] = a[:, : m - 1] + k[:, None] * a[:, : m - 1].flip(1)
            a = new_a
            e = e * (1.0 - k * k)
        return a
    idx = torch.arange(LPC_LEN, device=frames.device)
    toeplitz = r[:, (idx[:, None] - idx[None, :]).abs()]  # (F, 12, 12)
    return torch.linalg.solve(toeplitz, -r[:, 1:, None])[..., 0]


def lpc_run(x, dtype=torch.float64, solver: str = "solve", device="cuda"):
    """Whole-signal LPC matching ``oracle.lpc.run`` -> (blocks - 1, 12) numpy:
    256-sample blocks (a partial last one keeping the previous block's stale
    tail), each analysed with the block before it, the first not written."""
    dev = entry_device(device)
    blocks = stale_blocks(np.asarray(x, np.int16), LPC_BLOCK)
    prev = np.concatenate([np.zeros((1, LPC_BLOCK), np.int16), blocks])[: len(blocks)]
    frames = torch.from_numpy(np.concatenate([prev, blocks], axis=1)).to(dev)
    return lpc_frames(frames, dtype=dtype, solver=solver)[1:].cpu().numpy()


def _pick(ac, pick_max: bool):
    """Reference search: descending scan from 511 to 101 with >= (or <=),
    i.e. the smallest lag in [101, 511] attaining the extremum."""
    sl = ac[:, 101:512]
    ext = sl.amax(1) if pick_max else sl.amin(1)
    return 101 + (sl == ext[:, None]).to(torch.uint8).argmax(1), ext


def _masked_lag_sums(u, method: int):
    """(T, 1024) -> (T, 512): sum over i < 1024-k of |u_i - u_{i+k}| (method
    2) or u_i * u_{i+k} (method 3), one (T, 1024-k) product per lag."""
    cols = [((u[:, :PROC - k] - u[:, k:]).abs() if method == 2 else u[:, :PROC - k] * u[:, k:])
            .sum(1) for k in range(BLOCK)]
    return torch.stack(cols, 1)


def _per_lag(sums, lags):
    """sums / (1024 - k), an IEEE division by a tensor (on a card, a division
    by a Python scalar is a multiplication by its reciprocal)."""
    return sums / (PROC - lags).to(device=sums.device, dtype=sums.dtype)


def pitch_frames(frames, method: int = 1, dtype=torch.float64, fft_engine: str = "xla"):
    """(T, 1024) int16 frames [prev, cur] -> (lag (T,), value (T,), f0 (T,))."""
    lags = torch.arange(BLOCK)
    if method == 2 and fft_engine != "xla":
        # K11 over lags [96, 512): exact integer sums, correctly rounded f64
        ac = amdf(frames.to(torch.int16).contiguous(), lo=AMDF_LO).to(dtype)
        sl = ac[:, 101 - AMDF_LO:]
        val = sl.amin(1)
        arg = 101 + (sl == val[:, None]).to(torch.uint8).argmax(1)
    elif method == 1:
        u = frames.to(dtype)
        if fft_engine.startswith("mxu"):
            re, im = dft.rdft(u)  # Wiener-Khinchin: half-bin power -> one cosine matmul
            ac = dft.autocorr_from_half_power(re ** 2 + im ** 2, PROC, BLOCK)
        else:
            ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
            X = torch.fft.fft(u.to(ctype))
            P = X.real ** 2 + X.imag ** 2
            ac = torch.fft.ifft(P.to(ctype)).real[:, :BLOCK]
        arg, val = _pick(ac, True)
    elif method == 3 and fft_engine.startswith("mxu"):
        # linear autocorrelation as Wiener-Khinchin on the zero-padded frame:
        # the 2048-point rdft contracts over the 1024 real samples only, the
        # Nyquist bin (1024) split out as rank-1 terms
        u, n = frames.to(dtype), PROC
        C, S = dft._rdft_mats(2 * n)
        re, im = u @ dft.const(C[:n, :n], u), u @ dft.const(S[:n, :n], u)
        re_n, im_n = u @ dft.const(C[:n, n], u), u @ dft.const(S[:n, n], u)
        A = dft._autocorr_mats(2 * n, BLOCK)
        ac = (re ** 2 + im ** 2) @ dft.const(A[:n], u)
        ac = ac + (re_n ** 2 + im_n ** 2)[:, None] * dft.const(A[n], u)
        arg, val = _pick(_per_lag(ac, lags), True)
    else:
        arg, val = _pick(_per_lag(_masked_lag_sums(frames.to(dtype), method), lags), method == 3)
    argf = arg.to(dtype)
    return arg, val, torch.full_like(argf, FS) / argf


def pitch_run(x, method: int = 1, dtype=torch.float64, fft_engine: str = "xla",
              device="cuda"):
    """Whole-signal pitch matching ``oracle.pitch.run`` -> numpy (lag, value,
    f0) per 512-sample block; an empty payload gives empty arrays (the
    reference prints nothing)."""
    dev = entry_device(device)
    if len(x) == 0:
        z = np.zeros(0)
        return z.astype(np.int64), z, z
    blocks = stale_blocks(x, BLOCK)
    prev = np.concatenate([np.zeros((1, BLOCK), np.int16), blocks[:-1]])
    frames = torch.from_numpy(np.concatenate([prev, blocks], axis=1)).to(dev)
    arg, val, f0 = pitch_frames(frames, method=method, dtype=dtype, fft_engine=fft_engine)
    return arg.cpu().numpy(), val.cpu().numpy(), f0.cpu().numpy()
