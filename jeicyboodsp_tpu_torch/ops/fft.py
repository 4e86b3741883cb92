"""The from-scratch FFT program: radix-2 engine and roundtrip pipeline
(counterpart of ``jeicyboodsp_tpu/ops/fft.py``).

Reference: ``FFTAlgorithm_ver2.cpp``.  Its blocks of 512 samples go through
its own decimation-in-time radix-2 FFT (bit reversal first, butterflies,
then inter-stage twiddles with the truncated ``FFT_PI``) forward and
backward, are divided by N and truncated to short; the output's ±1 steps
depend on that algorithm, so ``fft_radix2`` keeps its stage structure and
the C expression order of every element.

``roundtrip_blocks`` engines: ``radix2`` (the reference's algorithm, the
compat engine), ``xla`` (``torch.fft``) and ``fourstep`` (the four-step
transform; on a CUDA tensor in f32 the kernel K12,
:func:`~jeicyboodsp_tpu_torch.kernels.fft_four_step.fft_pallas`).

``BLOCK_LEN`` and ``bitrev_indices`` are copies of the oracle's
(``jeicyboodsp_tpu/oracle/fftprog.py:20-35``); a CPU test holds them equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels.fft_four_step import fft_four_step, fft_pallas
from jeicyboodsp_tpu_torch.utils.cnum import FFT_PI, c_short
from jeicyboodsp_tpu_torch.utils.device import entry_device

BLOCK_LEN = 512
ENGINES = ("radix2", "xla", "fourstep")


def bitrev_indices(n: int) -> np.ndarray:
    """Bitrev (:186-207), from katjaas.nl bit reversal."""
    bits = int(np.log2(n))
    out = np.zeros(n, dtype=np.int64)
    for k in range(n):
        temp = k
        b = k
        for _ in range(1, bits):
            temp >>= 1
            b <<= 1
            b |= temp & 1
        out[k] = b & (n - 1)
    return out


@functools.lru_cache(maxsize=None)
def _stages(n: int, forward: bool):
    """Per stage: the butterfly indices (idx, idx + n1) and, except for the
    last stage, the twiddled indices with their cos and sin (float64)."""
    sign = -1.0 if forward else 1.0
    out = []
    npoint = n // 2
    while True:
        n2 = n // npoint
        n1 = n2 // 2
        n3 = n2 * 2
        idx = (n2 * np.arange(npoint)[:, None] + np.arange(n1)[None, :]).ravel()
        tw = None
        if npoint > 1:
            k = np.arange(npoint // 2)[:, None]
            nn = np.arange(n2)[None, :]
            idx2 = (k * n3 + n2 + nn).ravel()
            ang = sign * 2.0 * FFT_PI * np.broadcast_to(nn, (npoint // 2, n2)).ravel() / float(n3)
            tw = (idx2, np.cos(ang), np.sin(ang))
        out.append((idx, idx + n1, tw))
        if npoint == 1:
            return out
        npoint //= 2


def fft_radix2(re, im, forward: bool = True, n: int | None = None, dtype=torch.float64):
    """Batched reference-structured radix-2 DIT FFT.

    re, im: (..., N) real/imag parts; returns (re, im) unnormalised.
    """
    if n is None:
        n = re.shape[-1]
    if n & (n - 1):
        raise ValueError("power-of-two sizes only")
    dev = re.device
    rev = torch.from_numpy(bitrev_indices(n)).to(dev)
    re = re.to(dtype)[..., rev]
    im = im.to(dtype)[..., rev]
    for idx, idxp, tw in _stages(n, forward):
        i, ip = torch.from_numpy(idx).to(dev), torch.from_numpy(idxp).to(dev)
        a_r, a_i, b_r, b_i = re[..., i], im[..., i], re[..., ip], im[..., ip]
        re[..., i], re[..., ip] = a_r + b_r, a_r - b_r
        im[..., i], im[..., ip] = a_i + b_i, a_i - b_i
        if tw is not None:
            i2 = torch.from_numpy(tw[0]).to(dev)
            c, s = (torch.from_numpy(v).to(device=dev, dtype=dtype) for v in tw[1:])
            t_r, t_i = re[..., i2], im[..., i2]
            re[..., i2] = c * t_r - s * t_i
            im[..., i2] = c * t_i + s * t_r
    return re, im


def roundtrip_blocks(blocks, dtype=torch.float64, engine: str = "radix2"):
    """(T, 512) int16 -> (T, 512) int16: FFT -> IFFT -> /N -> short, as the
    program, on the blocks' device."""
    re = blocks.to(dtype)
    if engine == "xla":
        ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
        y = torch.fft.ifft(torch.fft.fft(re.to(ctype))).real
        return c_short(y)
    if engine == "fourstep":
        if re.is_cuda and dtype == torch.float32:  # K12 is f32 only
            Xr, Xi = fft_pallas(re, None, BLOCK_LEN, forward=True)
            yr, _ = fft_pallas(Xr, Xi, BLOCK_LEN, forward=False)
        else:
            Xr, Xi = fft_four_step(re, None, BLOCK_LEN, forward=True, dtype=dtype)
            yr, _ = fft_four_step(Xr, Xi, BLOCK_LEN, forward=False, dtype=dtype)
        return c_short(yr / float(BLOCK_LEN))
    if engine != "radix2":
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    Xr, Xi = fft_radix2(re, torch.zeros_like(re), forward=True, n=BLOCK_LEN, dtype=dtype)
    yr, _ = fft_radix2(Xr, Xi, forward=False, n=BLOCK_LEN, dtype=dtype)
    return c_short(yr / float(BLOCK_LEN))


def run_stream(x, dtype=torch.float64, device="cuda"):
    """Host convenience matching ``oracle.fftprog.run``: 512-sample blocks
    (a partial last block keeps the previous block's stale tail) through
    :func:`roundtrip_blocks`'s radix-2 engine on ``device``, a CUDA card
    unless the caller asks for the CPU; raises if that card is missing."""
    dev = entry_device(device)
    x = np.asarray(x, np.int16)
    if len(x) == 0:
        return np.zeros(0, np.int16)
    blocks = torch.from_numpy(np.ascontiguousarray(stale_blocks(x, BLOCK_LEN))).to(dev)
    return roundtrip_blocks(blocks, dtype=dtype).reshape(-1).cpu().numpy()


def fft_op_counts(n: int = BLOCK_LEN) -> tuple[int, int]:
    """The reference FFT's printed operation counter (``FFTAlgorithm_ver2.cpp:
    94-148``): adds counted once per butterfly pair per stage, multiplies
    once per twiddle application, no multiply pass on the final stage.
    512-pt: (2304, 2048)."""
    add = mul = 0
    npoint = n // 2
    while True:
        n1 = (n // npoint) // 2
        add += npoint * n1
        if npoint == 1:
            break
        mul += (npoint // 2) * (n // npoint)
        npoint //= 2
    return add, mul
