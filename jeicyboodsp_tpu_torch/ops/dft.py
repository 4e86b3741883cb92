"""DFTs as matmuls, and int8 splits of DFT bases (counterpart of
``jeicyboodsp_tpu/ops/dft.py``).

The numpy functions that make the bases are copies of the JAX package's,
whose module imports jax; a CPU test holds each copy byte-identical to it.
The bases stay f32-rounded numpy constants, as the JAX package makes them.

Precision tiers.  The JAX package names its matmul-DFT engines by the TPU
precision they ask for (``mxu`` HIGHEST, ``mxu3`` HIGH, ``mxu8`` the int8
kernels' class, ``mxu1`` DEFAULT).  Here every ``mxu*`` tier outside a
kernel but ``mxu1`` is one ``torch.matmul`` in the data's dtype, full f32
for f32 data: PyTorch runs f32 matmuls without TF32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, and the port never sets
it.  ``mxu1`` is DEFAULT's one pass (:func:`matmul`): both operands rounded
to bfloat16, then multiplied and summed in the data's dtype -- each product
of two bf16 values is exact in f32, so the f32 matmul of the rounded
operands is that pass, summed in f32 (a bf16 ``torch.matmul`` would round
its output to bf16 as well).  It lands below the 60 dB compat bar
(``config.ENGINE_FIDELITY``) and no CLI reaches it.  In f64 the bases are
the f32 values cast up, which is what JAX's ``jnp.dot(f64 data, f32
constant)`` computes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def int8_col_split(W):
    """Per-column 2-term int8 quantization: W ~= s1*Wh + s2*Wl.

    Wh/Wl int8, s1/s2 positive f64 per-column scales; the second term
    recaptures the first's rounding residual, leaving a worst-case error
    of max|col|/(127*2*127) ~= 2^-16 relative per column.
    """
    W = np.asarray(W, np.float64)
    s1 = np.maximum(np.abs(W).max(0), 1e-30) / 127.0
    Wh = np.rint(W / s1).astype(np.int8)
    R = W - s1 * Wh
    s2 = np.maximum(np.abs(R).max(0), 1e-30) / 127.0
    Wl = np.rint(R / s2).astype(np.int8)
    return Wh, Wl, s1, s2


@functools.lru_cache(maxsize=None)
def _rdft_mats(n: int):
    """Forward real-DFT matrices (n, n//2+1): X_k = x @ (C + iS)."""
    k = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _irdft_mats(n: int):
    """Inverse matrices (n//2+1, n) from the non-redundant half-spectrum:
    y_t = re @ IC - im @ IS, assuming Hermitian symmetry (wk doubling)."""
    k = np.arange(n // 2 + 1)[:, None] * np.arange(n)[None, :]
    ang = 2.0 * np.pi * k / n
    wk = np.full((n // 2 + 1, 1), 2.0)
    wk[0] = wk[-1] = 1.0
    ic = (wk * np.cos(ang) / n).astype(np.float32)
    is_ = (wk * np.sin(ang) / n).astype(np.float32)
    return ic, is_


@functools.lru_cache(maxsize=None)
def _icdft_real_mats(n: int):
    """Full-bin inverse, real part only: y = re @ IC - im @ IS, (n, n).

    For spectra that are NOT Hermitian (e.g. MVDR's quirk-merged spectrum)
    this reproduces ``ifft(X).real`` exactly."""
    k = np.arange(n)[:, None] * np.arange(n)[None, :]
    ang = 2.0 * np.pi * k / n
    return (np.cos(ang) / n).astype(np.float32), (np.sin(ang) / n).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _autocorr_mats(n: int, keep: int):
    """(n//2+1, keep): ac_t = (1/n) sum_k wk P_k cos(2 pi k t / n) for a
    real symmetric power spectrum given as half bins (Wiener-Khinchin)."""
    k = np.arange(n // 2 + 1)[:, None] * np.arange(keep)[None, :]
    ang = 2.0 * np.pi * k / n
    wk = np.full((n // 2 + 1, 1), 2.0)
    wk[0] = wk[-1] = 1.0
    return (wk * np.cos(ang) / n).astype(np.float32)


def matmul(a, b, fft_engine: str = "mxu"):
    """``a @ b`` at the precision tier of ``fft_engine``: ``mxu1`` rounds
    both operands to bfloat16 (to nearest even) first; every other tier
    multiplies them as given."""
    if fft_engine == "mxu1":
        a, b = (t.to(torch.bfloat16).to(t.dtype) for t in (a, b))
    return a @ b


def const(a, like):
    """The numpy constant ``a`` as a tensor of ``like``'s dtype and device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=like.device, dtype=like.dtype)


def rdft(x, fft_engine: str = "mxu"):
    """Real (..., n) -> half-spectrum (re, im) each (..., n//2+1)."""
    C, S = _rdft_mats(x.shape[-1])
    return matmul(x, const(C, x), fft_engine), matmul(x, const(S, x), fft_engine)


def irdft(re, im, n: int):
    """Half-spectrum (re, im) (..., n//2+1) -> real (..., n) (irfft)."""
    IC, IS = _irdft_mats(n)
    return re @ const(IC, re) - im @ const(IS, re)


def full_from_half(re, im):
    """Mirror the non-redundant half-spectrum of a REAL signal to all n bins."""
    mirror = torch.arange(re.shape[-1] - 2, 0, -1, device=re.device)
    return (torch.cat([re, re[..., mirror]], -1), torch.cat([im, -im[..., mirror]], -1))


def cdft_of_real_full(x, fft_engine: str = "mxu"):
    """Real (..., n) -> full n-bin spectrum (re, im): fft(x) for real x."""
    return full_from_half(*rdft(x, fft_engine))


def icdft_real(re, im, fft_engine: str = "mxu"):
    """Full-bin (re, im) (..., n) -> ifft(..).real (..., n), no symmetry assumed."""
    IC, IS = _icdft_real_mats(re.shape[-1])
    return matmul(re, const(IC, re), fft_engine) - matmul(im, const(IS, re), fft_engine)


def autocorr_from_half_power(p_half, n: int, keep: int):
    """Half-bin power spectrum (..., n//2+1) -> autocorrelation (..., keep)."""
    return p_half @ const(_autocorr_mats(n, keep), p_half)
