"""The NLMS echo canceller's float64 reference (NormalLMS.cpp).

- :func:`reference_nlms_blocks` is a frozen copy of the reference's block
  loop over one stream, sample by sample, and also returns the
  coefficients it ends with.
- :func:`nlms_sessions` is the same arithmetic over several independent
  streams at once, one NumPy operation a step across the streams: the
  estimate against the reversed coefficients summed tap by tap in order
  (``add.accumulate``), the window energy an exact integer, the update
  ``((2.0 * w) * MU) * e / (energy + eps)`` per tap.  ``dtype=float32``
  runs it in float32, the control.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.cnum import c_short_int

TAPS = 256
KEEP = TAPS - 1
MU = 0.0001
EPS = 0.0001
BLOCK = 1024


def reference_nlms_blocks(xb, rb):
    """float64 reference of NormalLMS.cpp over (nb, 1024) blocks: every
    block's est and err, and the final coefficients.  256 taps, mu 1e-4,
    the estimate against the reversed coefficients summed tap by tap, the
    update 2.0*u*MU*e/(norm + eps) per tap against the direct ones."""
    c = np.zeros(TAPS)
    u = np.zeros(KEEP + BLOCK)
    est = np.zeros(xb.shape, np.int16)
    err = np.zeros(xb.shape, np.int16)
    for t in range(len(xb)):
        u[KEEP:] = xb[t]
        for i in range(BLOCK):
            w = u[i:i + TAPS]
            y = c_short_int(np.add.accumulate(c[::-1] * w)[-1])
            e = int(rb[t, i]) - y
            c = c + 2.0 * w * MU * float(e) / (float(w @ w) + EPS)
            est[t, i], err[t, i] = y, c_short_int(float(e))
        u[:KEEP] = u[-KEEP:]
    return est, err, c


def nlms_sessions(x, r, dtype=np.float64, marks=()):
    """NormalLMS.cpp over S independent streams from a fresh state: x (far
    end) and r (near end) are (S, N) int16.  Returns (est, err) (S, N)
    int16, the coefficients after sample n for each n in ``marks`` (a list
    of (S, 256) arrays) and the final history (S, 255) int16 (the last
    255 far-end samples, zeros before the first).

    The streams lie along the last axis, so that a reduction over the taps
    (axis 0) adds them one after another, in tap order, for every stream at
    once: the reference's sequential sum."""
    x = np.asarray(x, np.int16)
    r = np.asarray(r, np.int16)
    S, N = x.shape
    u = np.zeros((KEEP + N, S), dtype)
    u[KEEP:] = x.T
    tmu = (dtype(2.0) * u) * dtype(MU)
    sq = np.concatenate([np.zeros((1, S), np.int64), np.cumsum(u.astype(np.int64) ** 2, axis=0)])
    d = (sq[TAPS:] - sq[:-TAPS]).astype(dtype) + dtype(EPS)  # exact integer energies
    c = np.zeros((TAPS, S), dtype)
    crev = c[::-1]
    rr = r.T.astype(np.int64)
    sums = np.zeros((N, S), dtype)
    est = np.zeros((N, S), np.int16)
    err = np.zeros((N, S), np.int64)
    p = np.empty((TAPS, S), dtype)
    marks = sorted(set(marks))
    snaps, mi = [], 0
    for i in range(N):
        np.multiply(crev, u[i:i + TAPS], out=p)
        np.add.reduce(p, axis=0, out=sums[i])
        est[i] = sums[i].astype(np.int64)  # truncated, its low 16 bits (checked below)
        e = rr[i] - est[i]
        err[i] = e
        np.multiply(tmu[i:i + TAPS], e.astype(dtype), out=p)
        np.divide(p, d[i], out=p)
        np.add(c, p, out=c)
        while mi < len(marks) and marks[mi] == i + 1:
            snaps.append(np.ascontiguousarray(c.T))
            mi += 1
    if not np.all(np.abs(sums) < 2147483648.0):  # a sum the fast store does not cover
        raise FloatingPointError("an estimate left int32's range; use reference_nlms_blocks")
    err = (((err + 32768) & 0xFFFF) - 32768).astype(np.int16)  # e is inside int32: its low 16 bits
    hist = np.concatenate([np.zeros((S, KEEP), np.int16), x], 1)[:, -KEEP:]
    return est.T.copy(), err.T.copy(), snaps, hist
