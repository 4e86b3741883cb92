"""The forward half of engine mxu3 ("K4"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_fwd_pallas`` (``_fwd_kernel``): (T, 512) int16 blocks -> re, im,
|X| (T, 512) and re_n, |X_n|, speech and frame flags (T, 1), the outputs of K2: the
windowed real DFT of each frame [x[t-1], x[t]] (zeros for t = 0), bins
0..511, the Nyquist bin as an f32 dot and the in-kernel VAD.  The TPU
kernel computes the DFT as GEMMs with the window-folded bases WC, WS; the
kernel here computes the same function as a real FFT in shared memory
(``csrc/rfft1024.cuh``, shared with K10), from the f32 window and twiddles
of :func:`rfft_constants`.

- :func:`enhance_fwd` is the wrapper: on a CUDA tensor it launches the
  hand-written kernels of ``csrc/enhance_mxu3.cu`` (counted in
  ``enhance_fwd.launches``); on a CPU tensor it runs the plain version;
  anything else raises.
- :func:`enhance_fwd_plain` is the plain PyTorch version: f32 matmuls with
  WC, WS and K2's epilogue :func:`~jeicyboodsp_tpu_torch.kernels.
  enhance_fwd_int8.forward_outputs`.
- :func:`rfft_frames_model` is a model of the FFT kernels' arithmetic for
  the tests: the same f32 constants, ``torch.fft.fft`` for the 512-point
  transform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N
from jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8 import (
    check_blocks,
    empty_forward_outputs,
    forward_outputs,
)
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI

CONSTS = ("rfft", "nyq", "w2")
FRAME = 2 * N  # samples of a frame: 1024
TWN = 128      # entries per twiddle table (csrc/rfft1024.cuh)
SPLIT, WINDOW = 4 * TWN, 4 * TWN + FRAME  # offsets of the split's cos and of the window


@functools.lru_cache(maxsize=1)
def rfft_constants():
    """The constants of ``csrc/rfft1024.cuh``, built in f64 and stored as
    f32, (2560,): the 512-point forward twiddle tables in K12's form (W_512^e
    for e < 128, then W_512^(128 h) for h < 128, re then im each), cos and
    sin of W_1024^k for k < 512 (the split), and the reference's Hamming
    window 0.54 - 0.46 cos(2 REF_PI i / 1023), the one K4's bases (and w2)
    and K10's fold in.  K4 and K10 share them."""
    lo = np.exp(-2j * np.pi * np.arange(TWN) / N)
    hi = np.exp(-2j * np.pi * TWN * np.arange(TWN) / N)
    split = np.exp(-2j * np.pi * np.arange(N) / FRAME)
    ham = 0.54 - 0.46 * np.cos(2.0 * float(REF_PI) * np.arange(FRAME) / (FRAME - 1))
    parts = (lo.real, lo.imag, hi.real, hi.imag, split.real, split.imag, ham)
    return np.concatenate([p.astype(np.float32) for p in parts])


def rfft_frames_model(frames, consts, pre_emphasis=None):
    """The FFT kernels' arithmetic on (F, 1024) frames, for the tests: the
    f32 samples (pre-emphasised in f32 as K10 does, p[0] = 0, p[i] = f[i] -
    pre_emphasis * f[i-1], where ``pre_emphasis`` is given) times the f32
    window of ``consts`` (:func:`rfft_constants`), even and odd samples
    packed into a 512-point complex transform (``torch.fft.fft``), split
    with the f32 W_1024^k as ``rfft_frame`` splits.  Returns (re, im) (F,
    512) f32."""
    c = torch.as_tensor(consts, dtype=torch.float32)
    f = frames.to(torch.float32)
    if pre_emphasis is not None:
        pre = torch.tensor(pre_emphasis, dtype=torch.float32)
        f = torch.cat([torch.zeros_like(f[:, :1]), f[:, 1:] - pre * f[:, :-1]], 1)
    x = f * c[WINDOW:]
    Z = torch.fft.fft(torch.complex(x[:, 0::2], x[:, 1::2]))
    Zc = Z[:, (-torch.arange(N)) % N]  # Z[512 - k]
    ar, ai, br, bi = Z.real, Z.imag, Zc.real, Zc.imag
    er, ei, dr, di = ar + br, ai - bi, ar - br, ai + bi
    wr, wi = c[SPLIT:SPLIT + N], c[SPLIT + N:WINDOW]
    return 0.5 * (er + (wr * di + wi * dr)), 0.5 * (ei - (wr * dr - wi * di))


def frames_f32(blocks):
    """(T, 512) int16 -> the (T, 1024) f32 frames [x[t-1], x[t]]."""
    cur = blocks.to(torch.float32)
    prev = torch.cat([torch.zeros_like(cur[:1]), cur[:-1]])
    return torch.cat([prev, cur], 1)


def enhance_fwd_plain(blocks, C):
    """Plain PyTorch version of :func:`enhance_fwd` (any device)."""
    frames = frames_f32(blocks)
    re = frames @ C["WC"]
    im = frames @ C["WS"]
    nyq = C["nyq"]
    ren = frames[:, :N] @ nyq[:N] + frames[:, N:] @ nyq[N:]
    return forward_outputs(blocks, re, im, ren, C)


def enhance_fwd(blocks, C):
    """(T, 512) int16 blocks -> (re, im, re_n, mag, mag_n, speech), the
    shapes of ``enhance_fwd_pallas``'s outputs, and the frame flags nz
    (T, 1) for the back kernels K5 and K13.  T a multiple of 8.

    C: constants from ``ops.enhance.enhance_constants``, on blocks' device.
    CUDA tensors launch ``jb_enhance_fwd`` (the FFT pass, then the row pass
    with the Nyquist bin and the flags); CPU tensors run
    :func:`enhance_fwd_plain`.
    """
    if check_blocks(blocks, C, CONSTS).type == "cpu":
        return enhance_fwd_plain(blocks, C)
    outs = empty_forward_outputs(blocks.shape[0], blocks.device)
    _build.launch("jb_enhance_fwd", blocks.device, blocks.data_ptr(), blocks.shape[0],
                  *(C[k].data_ptr() for k in CONSTS), *(o.data_ptr() for o in outs))
    enhance_fwd.launches += 1
    return outs


enhance_fwd.launches = 0
