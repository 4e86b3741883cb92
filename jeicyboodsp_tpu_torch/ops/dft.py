"""int8 splits of DFT bases (numpy; counterpart of ``jeicyboodsp_tpu/ops/dft.py``).

A copy of the JAX package's numpy function, whose module imports jax; a CPU
test holds this copy byte-identical to it.  The precision tiers (mxu,
mxu3, ...) are ported with the engines that use them.
"""

from __future__ import annotations

import numpy as np


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
