"""The C numerics the references share: the reference programs' truncated
pi constants, their ``double -> short`` store and the stale-tail blocking
of their ``fread`` loops.  The references keep their own copies of these,
apart from the program's, so that a fault in one does not pass unseen in
both."""

from __future__ import annotations

import numpy as np

REF_PI = 3.141592  # WienerFilter_final.cpp:41 (#define PI)
FFT_PI = 3.14159265358  # FFTAlgorithm_ver2.cpp:15


def c_short(v):
    """The reference's double -> short store of an array (cvttsd2si into 32
    bits, the low 16 bits kept): NaN or a value out of int32 range stores 0."""
    t = np.trunc(np.asarray(v, np.float64))
    ok = np.isfinite(t) & (t >= -(2 ** 31)) & (t <= 2 ** 31 - 1)
    return np.where(ok, t, -(2.0 ** 31)).astype(np.int64).astype(np.int32).astype(np.int16)


def c_short_int(v):
    """The reference's double -> short store of one value (see c_short)."""
    if not -2147483649.0 < v < 2147483648.0:  # out of int32 range, or NaN
        return 0
    t = int(v) & 0xFFFF
    return t - 0x10000 if t >= 0x8000 else t


def stale_blocks(x, n):
    """x cut into n-sample blocks, a partial last block keeping the previous
    block's stale tail (zeros when there is none): the reference's fread."""
    x = np.asarray(x, np.int16)
    full, rem = divmod(len(x), n)
    if rem:
        prev = x[(full - 1) * n: full * n] if full else np.zeros(n, np.int16)
        x = np.concatenate([x, prev[rem:]])
    return x.reshape(-1, n)
