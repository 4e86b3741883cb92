"""The LPC program's float64 reference (LPCEstimation.cpp; counterpart of
``jeicyboodsp_tpu/oracle/lpc.py``)."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import stale_blocks



def reference_lpc(x):
    """float64 copy of oracle/lpc.py:run (LPCEstimation.cpp): 256-sample
    blocks with stale tails, each analysed with the block before it through
    the Hamming window over 512 samples, the biased autocorrelation lags
    0..12 as dot products over (512 - lag), the 12x12 Toeplitz system solved
    by LU; the first block's row not written.  Returns (blocks - 1, 12)."""
    n = 512
    w = 0.54 - 0.46 * np.cos(2.0 * 3.141592 * np.arange(n) / (n - 1))
    lags = np.abs(np.subtract.outer(np.arange(12), np.arange(12)))
    prev = np.zeros(256, np.int16)
    rows = []
    for t, blk in enumerate(stale_blocks(x, 256)):
        win = np.concatenate([prev, blk]).astype(np.float64) * w
        prev = blk
        r = np.array([np.dot(win[:n - i], win[i:n]) / (n - i) for i in range(13)])
        if t:
            rows.append(np.linalg.solve(r[lags], -r[1:13]))
    return np.stack(rows) if rows else np.zeros((0, 12))


run = reference_lpc
