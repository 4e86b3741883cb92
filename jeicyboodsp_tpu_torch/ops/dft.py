"""DFTs as matmuls, and int8 splits of DFT bases (counterpart of
``jeicyboodsp_tpu/ops/dft.py``).

The numpy functions that make the bases are copies of the JAX package's,
whose module imports jax; a CPU test holds each copy byte-identical to it.
The bases stay f32-rounded numpy constants, as the JAX package makes them.

Precision tiers.  The JAX package names its matmul-DFT engines by the TPU
precision they ask for (``mxu`` HIGHEST, ``mxu3`` HIGH, ``mxu8`` the int8
kernels' class).  Here every ``mxu*`` tier outside a kernel is one
``torch.matmul`` in the data's dtype, full f32 for f32 data: PyTorch runs
f32 matmuls without TF32 unless ``torch.backends.cuda.matmul.allow_tf32``
is set, and the port never sets it.  In f64 the bases are the f32 values
cast up, which is what JAX's ``jnp.dot(f64 data, f32 constant)`` computes.
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
def _autocorr_mats(n: int, keep: int):
    """(n//2+1, keep): ac_t = (1/n) sum_k wk P_k cos(2 pi k t / n) for a
    real symmetric power spectrum given as half bins (Wiener-Khinchin)."""
    k = np.arange(n // 2 + 1)[:, None] * np.arange(keep)[None, :]
    ang = 2.0 * np.pi * k / n
    wk = np.full((n // 2 + 1, 1), 2.0)
    wk[0] = wk[-1] = 1.0
    return (wk * np.cos(ang) / n).astype(np.float32)


def const(a, like):
    """The numpy constant ``a`` as a tensor of ``like``'s dtype and device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=like.device, dtype=like.dtype)


def rdft(x):
    """Real (..., n) -> half-spectrum (re, im) each (..., n//2+1)."""
    C, S = _rdft_mats(x.shape[-1])
    return x @ const(C, x), x @ const(S, x)


def autocorr_from_half_power(p_half, n: int, keep: int):
    """Half-bin power spectrum (..., n//2+1) -> autocorrelation (..., keep)."""
    return p_half @ const(_autocorr_mats(n, keep), p_half)
