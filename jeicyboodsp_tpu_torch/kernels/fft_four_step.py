"""The FFT of fastconv's mxu engines and the FFT program ("K12"): wrapper,
plain version, count.

Counterpart of ``jeicyboodsp_tpu/kernels/fft_pallas.py``, whose Pallas
kernel evaluates the four-step (Bailey) form: an n-point transform with
n = n1 * n2 (both <= 128) is

    X = transpose( DFT_n2 x ( twiddle * (DFT_n1 x view(x, n1, n2)) ) )

as real matmuls on separate real and imaginary planes, unnormalised in both
directions; X[k2*n1 + k1] = C[k1, k2].

- :func:`fft_four_step` is the plain PyTorch form, in f32 or f64: the port
  of the JAX package's plain-XLA function and K12's plain version.
- :func:`fft_pallas` is the wrapper of K12, which replaces the Pallas
  kernel ``fft_pallas`` (``_fft_kernel``): on a CUDA tensor it launches the
  hand-written kernel of ``csrc/fft4.cu`` (counted in
  ``fft_pallas.launches``), a mixed-radix Stockham FFT with each frame in
  shared memory, one launch and no scratch; on a CPU tensor it runs
  :func:`fft_four_step` in f32; anything else raises.  K12 is f32 only, as
  on the TPU, and sums in another order than the four-step: it is held
  within 1e-5 of max |X| of the plain version.

``im=None`` means a real input: the plain form then skips the two products
with the zero plane, as XLA folds them away, and the kernel loads no
imaginary plane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check, check_rows


def _factor(n: int):
    """Split n = n1 * n2 with both factors <= 128 and as square as possible."""
    best = None
    for n1 in range(2, 129):
        if n % n1 == 0 and n // n1 <= 128:
            n2 = n // n1
            score = abs(n1 - n2)
            if best is None or score < best[0]:
                best = (score, n1, n2)
    if best is None:
        raise ValueError(f"cannot factor {n} into two factors <= 128")
    return best[1], best[2]


def _plan(n: int, forward: bool, dtype=np.float32):
    n1, n2 = _factor(n)
    sign = -2j if forward else 2j
    w1 = np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    return (
        n1,
        n2,
        (w1.real.astype(dtype), w1.imag.astype(dtype)),
        (w2.real.astype(dtype), w2.imag.astype(dtype)),
        (tw.real.astype(dtype), tw.imag.astype(dtype)),
    )


@functools.lru_cache(maxsize=16)
def _plan_on(n: int, forward: bool, dtype: torch.dtype, device: torch.device):
    """The plan's bases and twiddles as tensors of ``dtype`` on ``device``."""
    n1, n2, *mats = _plan(n, forward, np.float32 if dtype == torch.float32 else np.float64)
    return n1, n2, [torch.from_numpy(a).to(device) for pair in mats for a in pair]


def fft_four_step(re, im, n: int, forward: bool = True, dtype=torch.float32):
    """Batched four-step FFT: re/im (..., n) -> (re, im) (..., n) in ``dtype``.

    Unnormalised in both directions (like FFTW); callers divide by n for
    the inverse.  ``im=None`` is a real input.
    """
    n1, n2, (w1r, w1i, w2r, w2i, twr, twi) = _plan_on(n, forward, dtype, re.device)
    batch = re.shape[:-1]
    xr = re.to(dtype).reshape(*batch, n1, n2)
    # A = W1 @ x (contract over j1)
    if im is None:
        ar, ai = w1r @ xr, w1i @ xr
    else:
        xi = im.to(dtype).reshape(*batch, n1, n2)
        ar = w1r @ xr - w1i @ xi
        ai = w1r @ xi + w1i @ xr
    # B = A * twiddle
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # C = B @ W2^T (contract over j2)
    cr = br @ w2r.T - bi @ w2i.T
    ci = br @ w2i.T + bi @ w2r.T
    # X[k2*n1 + k1] = C[k1, k2]
    return (cr.transpose(-1, -2).reshape(*batch, n),
            ci.transpose(-1, -2).reshape(*batch, n))


@functools.lru_cache(maxsize=16)
def _kernel_consts(n: int, forward: bool, device: torch.device):
    """K12's twiddle tables of (n, direction), built in f64 and stored as
    f32: W_n^e for e < 128, then W_n^(128 h) for h < 128, re then im each;
    the kernel takes W_n^e as the product of the two entries of e."""
    sign = -2j if forward else 2j
    lo = np.exp(sign * np.pi * np.arange(128) / n)
    hi = np.exp(sign * np.pi * 128 * np.arange(128) / n)
    flat = [a.astype(np.float32) for a in (lo.real, lo.imag, hi.real, hi.imag)]
    return torch.from_numpy(np.concatenate(flat)).to(device)


def fft_pallas(re, im, n: int, forward: bool = True):
    """FFT over (T, n) f32 frames -> (re, im) (T, n) f32, in natural order,
    unnormalised.  ``im=None`` is a real input.

    CUDA tensors launch ``jb_fft4`` once (it refuses, and this raises for,
    an odd n past 1024, whose frame would need more than 1024 threads); CPU
    tensors run :func:`fft_four_step`.
    """
    f32 = torch.float32
    T = re.shape[0] if re.dim() == 2 else -1
    specs = {"re": (re, f32, (T, n))}
    if im is not None:
        specs["im"] = (im, f32, (T, n))
    dev = check(specs)
    check_rows(T, 1)
    _factor(n)
    if dev.type == "cpu":
        return fft_four_step(re, im, n, forward, f32)
    outr, outi = torch.empty(T, n, dtype=f32, device=dev), torch.empty(T, n, dtype=f32, device=dev)
    _build.launch("jb_fft4", dev, re.data_ptr(), 0 if im is None else im.data_ptr(), T, n,
                  int(forward), _kernel_consts(n, forward, dev).data_ptr(), outr.data_ptr(),
                  outi.data_ptr())
    fft_pallas.launches += 1
    return outr, outi


fft_pallas.launches = 0
