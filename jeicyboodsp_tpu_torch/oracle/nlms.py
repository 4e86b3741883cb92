"""The echo cancellers' float64 references (NormalLMS.cpp, BNLMS.cpp;
counterpart of ``jeicyboodsp_tpu/oracle/nlms.py``)."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import c_short, c_short_int, stale_blocks


def reference_nlms_blocks(xb, rb, trajectory=None):
    """float64 reference of NormalLMS.cpp over (nb, 1024) blocks, every
    block's est and err: 256 taps, mu 1e-4, the estimate against the reversed
    coefficients summed tap by tap (add.accumulate is sequential), the update
    2.0*u*MU*e/(norm + eps) per tap against the direct ones.  ``trajectory``,
    a list, gets the first three coefficients after each block (what
    ``--verbose`` prints, NormalLMS.cpp:128)."""
    c = np.zeros(256)
    u = np.zeros(255 + 1024)
    est = np.zeros(xb.shape, np.int16)
    err = np.zeros(xb.shape, np.int16)
    for t in range(len(xb)):
        u[255:] = xb[t]
        for i in range(1024):
            w = u[i:i + 256]
            y = c_short_int(np.add.accumulate(c[::-1] * w)[-1])
            e = int(rb[t, i]) - y
            c = c + 2.0 * w * 0.0001 * float(e) / (float(w @ w) + 0.0001)
            est[t, i], err[t, i] = y, c_short_int(float(e))
        u[:255] = u[-255:]
        if trajectory is not None:
            trajectory.append(tuple(c[:3]))
    return est, err


def _double_talk(u, r):
    """BNLMS.cpp:164-186, reads past the 1151-sample buffers zero: True for
    double talk.  The correlations as direct float64 dot products."""
    up = np.zeros(2048)
    rp = np.zeros(3072)
    up[:len(u)] = u
    rp[:len(r)] = r
    best = 0.0
    for k in range(1024):
        m = 2048 - k
        best = max(best, float(np.dot(up[:m], rp[k:k + m])) / m)
    return not best > 0.0


def reference_bnlms_blocks(xb, rb):
    """float64 reference of BNLMS.cpp over (nb, 1024) blocks: every block's
    est and err and its gate (True = update).  128 taps, mu 0.01, the
    estimate tap by tap with the block's frozen coefficients, the gradient
    summed sample by sample, averaged by 1024 and applied when the
    double-talk test allows."""
    c = np.zeros(128)
    u = np.zeros(127 + 1024)
    r = np.zeros(127 + 1024)
    est = np.zeros(xb.shape, np.int16)
    err = np.zeros(xb.shape, np.int16)
    gates = []
    for t in range(len(xb)):
        u[127:], r[127:] = xb[t], rb[t]
        W = np.lib.stride_tricks.sliding_window_view(u, 128)[:1024]
        y = c_short(np.add.accumulate(W * c[::-1], axis=1)[:, -1]).astype(np.int64)
        e = rb[t].astype(np.int64) - y
        est[t], err[t] = y, c_short(e)
        gates.append(not _double_talk(u, r))
        if gates[-1]:
            d = (W * W).sum(1) + 0.00001  # exact integer energies
            terms = 2.0 * W * 0.01 * e[:, None].astype(np.float64) / d[:, None]
            c = c + np.add.accumulate(terms, axis=0)[-1] / 1024
        u[:127], r[:127] = u[-127:], r[-127:]
    return est, err, gates


def reference_nlms(x, ref, bnlms=False):
    """run_nlms / run_bnlms of the reference programs: as many 1024-sample
    blocks as the shorter signal starts, each signal's blocks with its own
    stale tails, the first block's output not written.  Returns est, err
    (and the gates for BNLMS)."""
    nb = -(-min(len(x), len(ref)) // 1024)
    if nb == 0:
        return (np.zeros(0, np.int16), np.zeros(0, np.int16)) + (([],) if bnlms else ())
    xb, rb = stale_blocks(x, 1024)[:nb], stale_blocks(ref, 1024)[:nb]
    out = reference_bnlms_blocks(xb, rb) if bnlms else reference_nlms_blocks(xb, rb)
    return (out[0][1:].reshape(-1), out[1][1:].reshape(-1)) + tuple(out[2:])


def run_nlms(x, ref):
    """NormalLMS.cpp on two int16 signals: the written (est, err)."""
    return reference_nlms(x, ref)


def run_bnlms(x, ref):
    """BNLMS.cpp on two int16 signals: the written (est, err)."""
    return reference_nlms(x, ref, bnlms=True)[:2]
