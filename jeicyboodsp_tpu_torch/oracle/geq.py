"""The 7-band GEQ's float64 references (7Band_GEQ.cpp; counterpart of
``jeicyboodsp_tpu/oracle/geq.py``): the coefficient math with its quirks
(the reference's own copy; ``ops/geq.py`` keeps the program's), and the
cascade with the in-loop store into a short, in float64
(the reference), in float32 (``geq --fast``) and without the store (the
linear engine)."""

from __future__ import annotations

import math

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI, c_short, c_short_int, stale_blocks

SAMPLING_RATE = 48000.0  # 7Band_GEQ.cpp:33
TOTAL_BANDS = 7
BLOCK_LEN = 512  # 7Band_GEQ.cpp:43
Q = 4.318  # 7Band_GEQ.cpp:45
ROOT2 = 1.0 / Q  # 7Band_GEQ.cpp:59
CENTER_FREQS = (44.0, 125.0, 250.0, 500.0, 2000.0, 6000.0, 11313.0)  # :47
GAINS_DB = (12.0, 12.0, 0.0, 0.0, 3.0, 0.0, -12.0)  # 7Band_GEQ.cpp:51-57


def calc_coefficients(
    gains_db=GAINS_DB, center_freqs=CENTER_FREQS, fs=SAMPLING_RATE, compat: bool = True
):
    """Return (b, a) arrays of shape (7, 3), a[:,0] == 0 as in the reference.

    ``compat=True`` reproduces the reference's coefficient quirks
    (``K_band[k-1]`` in peak a2; V-vs-K mixups in the bass-cut branch);
    ``compat=False`` computes the textbook formulas.
    """
    K = [math.tan(REF_PI * f / fs) for f in center_freqs]
    # 7Band_GEQ.cpp:139-142 -- invert gain if a cut, so V >= 1 always
    V = [10.0 ** (g / 20.0) for g in gains_db]
    V = [1.0 / v if v < 1 else v for v in V]
    G = list(gains_db)
    r = ROOT2

    b = np.zeros((TOTAL_BANDS, 3), dtype=np.float64)
    a = np.zeros((TOTAL_BANDS, 3), dtype=np.float64)

    # --- band 0: bass shelf (7Band_GEQ.cpp:144-175)
    k0, v0 = K[0], V[0]
    if G[0] > 0:  # booster, :144-159
        d = 1 + r * k0 + k0 ** 2
        b[0] = [
            (1 + math.sqrt(v0) * r * k0 + v0 * k0 ** 2) / d,
            (2 * (v0 * k0 ** 2 - 1)) / d,
            (1 - math.sqrt(v0) * r * k0 + v0 * k0 ** 2) / d,
        ]
        a[0] = [0.0, (2 * (k0 ** 2 - 1)) / d, (1 - r * k0 + k0 ** 2) / d]
    else:  # cut, :160-175 (reference has V/K mixups in a1/a2 -- compat quirk)
        d = 1 + r * math.sqrt(v0) * k0 + v0 * k0 ** 2
        b[0] = [
            (1 + r * k0 + k0 ** 2) / d,
            (2 * (k0 ** 2 - 1)) / d,
            (1 - r * k0 + k0 ** 2) / d,
        ]
        if compat:
            # 7Band_GEQ.cpp:173-174: uses K_band[0] where V_band[0] belongs
            a[0] = [
                0.0,
                (2 * (k0 * k0 ** 2 - 1)) / d,
                (1 - r * math.sqrt(k0) * k0 + k0 * k0 ** 2) / d,
            ]
        else:
            a[0] = [
                0.0,
                (2 * (v0 * k0 ** 2 - 1)) / d,
                (1 - r * math.sqrt(v0) * k0 + v0 * k0 ** 2) / d,
            ]

    # --- band 6: treble shelf (7Band_GEQ.cpp:177-210)
    k6, v6 = K[6], V[6]
    if G[6] > 0:  # booster, :177-192
        d = 1 + r * k6 + k6 ** 2
        b[6] = [
            (v6 + r * math.sqrt(v6) * k6 + k6 ** 2) / d,
            (2 * (k6 ** 2 - v6)) / d,
            (v6 - r * math.sqrt(v6) * k6 + k6 ** 2) / d,
        ]
        a[6] = [0.0, (2 * (k6 ** 2 - 1)) / d, (1 - r * k6 + k6 ** 2) / d]
    else:  # cut, :193-210
        d = v6 + r * math.sqrt(v6) * k6 + k6 ** 2
        b[6] = [
            (1 + r * k6 + k6 ** 2) / d,
            (2 * (k6 ** 2 - 1)) / d,
            (1 - r * k6 + k6 ** 2) / d,
        ]
        d2 = 1 + r / math.sqrt(v6) * k6 + (k6 ** 2) / v6
        a[6] = [
            0.0,
            (2 * ((k6 ** 2) / v6 - 1)) / d2,
            (1 - r / math.sqrt(v6) * k6 + (k6 ** 2) / v6) / d2,
        ]

    # --- bands 1..5: peak/notch (7Band_GEQ.cpp:212-249)
    for kk in range(1, 6):
        kb, vb = K[kk], V[kk]
        ka2 = K[kk - 1] if compat else kb  # quirk: 7Band_GEQ.cpp:231,247
        if G[kk] > 0:  # boost peak, :217-232
            d = 1 + (1 / Q) * kb + kb ** 2
            b[kk] = [
                (1 + (vb / Q) * kb + kb ** 2) / d,
                (2 * (kb ** 2 - 1)) / d,
                (1 - (vb / Q) * kb + kb ** 2) / d,
            ]
            a[kk] = [0.0, b[kk][1], (1 - (1 / Q) * ka2 + kb ** 2) / d]
        else:  # cut peak, :233-248
            d = 1 + (vb / Q) * kb + kb ** 2
            b[kk] = [
                (1 + (1.0 / Q) * kb + kb ** 2) / d,
                (2 * (kb ** 2 - 1)) / d,
                (1 - (1.0 / Q) * kb + kb ** 2) / d,
            ]
            a[kk] = [0.0, b[kk][1], (1 - (vb / Q) * ka2 + kb ** 2) / d]

    return b, a


def reference_geq(x, b, a):
    """float64 reference of 7Band_GEQ.cpp on one signal: 512-sample blocks,
    seven direct-form-I biquads in series, each output stored into a short
    inside the recursion, every sum in the reference's order
    b2*x2 - a2*y2 + b1*x1 - a1*y1 + b0*x0 (7Band_GEQ.cpp:279-300)."""
    cur = [float(v) for v in stale_blocks(x, 512).reshape(-1)]
    for k in range(7):
        b0, b1, b2 = (float(v) for v in b[k])
        a1, a2 = float(a[k][1]), float(a[k][2])
        x1 = x2 = y1 = y2 = 0.0
        out = []
        for v in cur:
            acc = b2 * x2
            acc -= a2 * y2
            acc += b1 * x1
            acc -= a1 * y1
            acc += b0 * v
            y = float(c_short_int(acc))
            x2, x1, y2, y1 = x1, v, y1, y
            out.append(y)
        cur = out
    return np.array(cur, np.int16)


def reference_geq_f32(x, b, a):
    """reference_geq in float32, each product and sum one float32 numpy
    operation, so each rounded once (``geq --fast``; jeicyboodsp_tpu/ops/geq.py:
    geq_apply with dtype=float32 as written).  Not the reference's output."""
    f32 = np.float32
    cur = [f32(v) for v in stale_blocks(x, 512).reshape(-1)]
    bb, aa = np.asarray(b, f32), np.asarray(a, f32)
    for k in range(7):
        b0, b1, b2, a1, a2 = bb[k, 0], bb[k, 1], bb[k, 2], aa[k, 1], aa[k, 2]
        x1 = x2 = y1 = y2 = f32(0)
        out = []
        for v in cur:
            acc = b2 * x2
            acc = acc - a2 * y2
            acc = acc + b1 * x1
            acc = acc - a1 * y1
            acc = acc + b0 * v
            y = f32(c_short_int(float(acc)))
            x2, x1, y2, y1 = x1, v, y1, y
            out.append(y)
        cur = out
    return np.array(cur, np.int16)


def reference_geq_linear(x, b, a):
    """The same cascade in float64 with no store into a short inside it (the
    GEQ's linear engine), stored into int16 once at the end."""
    cur = [float(v) for v in stale_blocks(x, 512).reshape(-1)]
    for k in range(7):
        x1 = x2 = y1 = y2 = 0.0
        out = []
        for v in cur:
            y = b[k][0] * v + b[k][1] * x1 + b[k][2] * x2 - a[k][1] * y1 - a[k][2] * y2
            x2, x1, y2, y1 = x1, v, y1, y
            out.append(y)
        cur = out
    return c_short(np.array(cur))


def run(x, gains_db=GAINS_DB, compat=True):
    """The program on one int16 signal: the cascade of the coefficients of
    ``gains_db`` (``compat``: with the reference's quirks)."""
    b, a = calc_coefficients(gains_db=gains_db, compat=compat)
    return reference_geq(x, b, a)
