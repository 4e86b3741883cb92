"""The fused MFCC chain ("K10"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/mfcc_pallas.py:
mfcc_fused_pallas`` (``_kernel``, constants ``_mfcc_consts``): (N, 512)
int16 frame halves prev, cur -> (N, 12) f32 MFCC features: pre-emphasis,
the Hamming window and the real DFT of each 1024-sample frame, |X|, the
38-channel mel, log and DCT-II with liftering.  The TPU kernel folds
pre-emphasis and window into the 1024 x 512 rDFT bases Cf, Sf and runs
GEMMs (bf16x3); the kernel here applies them to the samples and runs a
real FFT in shared memory (``csrc/rfft1024.cuh``, shared with K4), with
|X|, mel, log and DCT in the same block.  The TPU kernel's ones-padded mel
columns and zero-padded DCT rows were a 128-lane layout and have no
counterpart here.

- :func:`mfcc_fused` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/mfcc.cu`` (counted in
  ``mfcc_fused.launches``); on a CPU tensor it runs the plain version;
  anything else raises.
- :func:`mfcc_fused_plain` is the plain PyTorch version: f32 matmuls with
  the folded bases Cf, Sf, then sqrt, mel, log and DCT.

A frame whose mel channels are all zero (digital silence) gives log 0 = -inf
there and NaN features, as in the oracle and the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check
from jeicyboodsp_tpu_torch.kernels.enhance_fwd import rfft_constants

HALF = 512
N_CEP = 12
MEL_TABLE_MAX = 1024  # csrc/mfcc.cu's shared-memory room for the mel weights


@functools.lru_cache(maxsize=1)
def mfcc_consts():
    """Host-side fused bases (copy of ``_mfcc_consts`` without the 128-lane
    padding): (P^T W C), (P^T W S) (1024, 512) f32 with P the pre-emphasis
    operator and W the Hamming diagonal; mel (512, 38) and DCT+lifter
    (38, 12) f32."""
    from jeicyboodsp_tpu_torch.ops.features import (
        PRE_EMPHASIS,
        WINDOW_LEN,
        dct_lifter_matrix,
        mel_matrix,
    )
    from jeicyboodsp_tpu_torch.utils.cnum import REF_PI

    n = WINDOW_LEN
    i = np.arange(n)
    ham = 0.54 - 0.46 * np.cos(2.0 * float(REF_PI) * i / (n - 1))
    kk = i[:, None] * np.arange(512)[None, :]
    ang = -2.0 * np.pi * kk / n
    C = ham[:, None] * np.cos(ang)
    S = ham[:, None] * np.sin(ang)

    # pre-emphasis P: p[0] = 0, p[i] = f[i] - 0.96 f[i-1]; (P f)^T C = f^T (P^T C)
    def fold(B):
        out = np.zeros_like(B)
        out[: n - 1] = -PRE_EMPHASIS * B[1:]
        out += B
        out[0] -= B[0]  # P zeroes the first output sample entirely
        return out

    return (fold(C).astype(np.float32), fold(S).astype(np.float32),
            mel_matrix(np.float32), dct_lifter_matrix(np.float32))


def mel_table(mel):
    """Channel c of the (512, 38) mel matrix as its contiguous run of rows:
    (lo, hi, offset) per channel (38, 3) int32, and the runs' weights packed
    one after another (f32).  Rows outside a run hold zeros."""
    runs, weights, off = [], [], 0
    for c in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, c])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        runs.append((lo, hi, off))
        weights.append(mel[lo:hi, c])
        off += hi - lo
    assert off <= MEL_TABLE_MAX, off
    return np.asarray(runs, np.int32), np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=4)
def kernel_constants(device: torch.device):
    """The kernel's operands on ``device``: the real FFT's twiddles, split
    and Hamming window (``enhance_fwd.rfft_constants``, K4's too); the mel
    table; the DCT+lifter matrix."""
    _, _, mel, dct = mfcc_consts()
    runs, weights = mel_table(mel)
    host = {"rfft": rfft_constants(), "mel_runs": runs, "mel_w": weights, "dct": dct}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}


@functools.lru_cache(maxsize=4)
def plain_constants(device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in mfcc_consts())


def mfcc_fused_plain(prev, cur):
    """Plain PyTorch version of :func:`mfcc_fused` (any device)."""
    Cf, Sf, mel, dct = plain_constants(prev.device)
    frames = torch.cat([prev, cur], 1).to(torch.float32)
    re, im = frames @ Cf, frames @ Sf
    return torch.log(torch.sqrt(re * re + im * im) @ mel) @ dct


def mfcc_fused(prev, cur):
    """(N, 512) int16 frame halves -> (N, 12) f32 MFCC features.

    prev/cur are the two 512-sample halves of each 1024-sample analysis frame
    (framed with the in-signal keep buffer, as ``ops.features.mfcc_blocks``
    does).  CUDA tensors launch ``jb_mfcc_fused``; CPU tensors run
    :func:`mfcc_fused_plain`.
    """
    if prev.dim() != 2:
        raise ValueError(f"prev must be 2-D (frames, 512), got {tuple(prev.shape)}")
    N = prev.shape[0]
    dev = check({"prev": (prev, torch.int16, (N, HALF)), "cur": (cur, torch.int16, (N, HALF))})
    if dev.type == "cpu":
        return mfcc_fused_plain(prev, cur)
    out = torch.empty(N, N_CEP, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    K = kernel_constants(dev)
    _build.launch("jb_mfcc_fused", dev, prev.data_ptr(), cur.data_ptr(), N,
                  K["rfft"].data_ptr(), K["mel_runs"].data_ptr(),
                  K["mel_w"].data_ptr(), K["mel_w"].numel(), K["dct"].data_ptr(),
                  out.data_ptr())
    mfcc_fused.launches += 1
    return out


mfcc_fused.launches = 0
