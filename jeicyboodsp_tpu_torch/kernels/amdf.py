"""The AMDF of pitch method 2 ("K11"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/amdf_pallas.py:
amdf_pallas`` (``_make_kernel``): (T, 1024) frames -> (T, 512 - lo) AMDF
values for lags k in [lo, 512),

    amdf[k] = sum_{i < 1024-k} |u_i - u_{i+k}| / (1024 - k)

(PitchEstimation_method2.cpp:79-95).  The TPU kernel sums in f32, which
rounds once the sums pass 2^24; here the sums are exact integers and the
quotient one f64 division, so the values are bit for bit the oracle's
``float(int_sum) / (1024 - k)`` and the output is f64.

- :func:`amdf` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/amdf.cu`` (counted in ``amdf.launches``); on
  a CPU tensor it runs the plain version; anything else raises.
- :func:`amdf_plain` is the plain PyTorch version: a loop over lags of int64
  torch ops, then the f64 division by a tensor; bit-equal to the kernel.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check

PROC = 1024
KEEP = 512


def check_lo(lo: int):
    """The JAX kernel's precondition on ``lo``, kept so both accept the same calls."""
    if lo % 8 != 0 or not 0 <= lo < KEEP:
        raise ValueError(f"lo must be a multiple of 8 in [0, {KEEP}); got {lo}")


def amdf_plain(frames, lo: int = 0):
    """Plain PyTorch version of :func:`amdf` (any device)."""
    u = frames.to(torch.int64)
    sums = torch.stack([(u[:, :PROC - k] - u[:, k:]).abs().sum(1) for k in range(lo, KEEP)], 1)
    n = PROC - torch.arange(lo, KEEP, device=frames.device, dtype=torch.float64)
    return sums.to(torch.float64) / n


def amdf(frames, lo: int = 0):
    """(T, 1024) int16 frames -> (T, 512 - lo) f64 AMDF over lags [lo, 512).

    ``lo`` a multiple of 8 in [0, 512) (else ``ValueError``); the pitch path
    passes 96.  CUDA tensors launch ``jb_amdf``; CPU tensors run
    :func:`amdf_plain`.
    """
    check_lo(lo)
    if frames.dim() != 2:
        raise ValueError(f"frames must be 2-D (T, {PROC}), got {tuple(frames.shape)}")
    T = frames.shape[0]
    dev = check({"frames": (frames, torch.int16, (T, PROC))})
    if dev.type == "cpu":
        return amdf_plain(frames, lo)
    out = torch.empty(T, KEEP - lo, dtype=torch.float64, device=dev)
    if T == 0:
        return out
    _build.launch("jb_amdf", dev, frames.data_ptr(), T, lo, out.data_ptr())
    amdf.launches += 1
    return out


amdf.launches = 0
