"""The arithmetic K8 (csrc/nlms.cu) computes in place of the plain version's,
held bit for bit against it on the CPU, where no card is needed:

- the doubling folded into mu: RN(RN(2w)*MU) == RN(w*RN(2*MU)) for every int16 w;
- the quotient from one reciprocal, RN(a/d) as q0 = a*y, r0 = fma(-q0, d, a),
  q1 = fma(r0, y, q0), r1 = fma(-q1, d, a), q = copysign(fma(r1, y, q1), a)
  with y = RN(1/d), each FMA modelled exactly with fractions, against IEEE
  a / d (sign of zero included) over the kernel's ranges and their edges;
- the window energy per 32-sample chunk (an inclusive scan of x^2 - old^2 on
  the carried energy) against the plain version's sequential sum.
"""

import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.kernels import nlms as K8

MU, EPS = K8.MU, K8.EPS
MU2 = 2.0 * MU
CHUNK = 32  # samples per chunk: one per lane of the kernel's warp


def _bits(v):
    return struct.unpack("<q", struct.pack("<d", v))[0]


def _fma(a, b, c):
    """RN(a*b + c) with one rounding; an exact zero takes IEEE's sign (-0
    only when a*b and c are both -0)."""
    s = Fraction(a) * Fraction(b) + Fraction(c)
    if s:
        return float(s)  # int / int: correctly rounded
    neg = math.copysign(1.0, a) * math.copysign(1.0, b) < 0
    return -0.0 if a * b == 0 and c == 0 and neg and math.copysign(1.0, c) < 0 else 0.0


def _quotient(a, d):
    """csrc/nlms.cu:quotient with y = __drcp_rn(d), the correctly rounded 1/d."""
    y = float(Fraction(1) / Fraction(d))
    q0 = a * y
    r0 = _fma(-q0, d, a)
    q1 = _fma(r0, y, q0)
    r1 = _fma(-q1, d, a)
    return math.copysign(_fma(r1, y, q1), a)


def _check_pairs(pairs):
    bad = [(a, d) for a, d in pairs if _bits(_quotient(a, d)) != _bits(a / d)]
    assert not bad, f"{len(bad)} quotients differ from IEEE a / d, first {bad[:3]}"


def test_doubling_folds_into_mu_for_every_int16():
    w = np.arange(-32768, 32768, dtype=np.float64)
    assert np.array_equal(((2.0 * w) * MU).view(np.int64), (w * MU2).view(np.int64))


def _divisors(norms):
    return [float(n) + EPS for n in norms]  # RN(norm + EPS): norms are exact integers


def test_quotient_matches_ieee_division_on_random_pairs():
    """20,000 pairs from the kernel's ranges: int16 w, e in +-65535, integer
    norms in [0, 2^38]; compat numerators RN(RN(w*2MU)*e), and a quarter of
    them the non-compat RN(2MU*e)."""
    rng = np.random.default_rng(20261017)
    n = 20000
    w = rng.integers(-32768, 32768, n).astype(np.float64)
    e = rng.integers(-65535, 65536, n).astype(np.float64)
    # norms spread over every binade up to 2^38, not only the top ones
    norms = np.floor(2.0 ** rng.uniform(0, 38, n)).astype(np.int64)
    a = (w * MU2) * e
    a[::4] = MU2 * e[::4]
    _check_pairs(zip(a.tolist(), _divisors(norms.tolist())))


def test_quotient_matches_ieee_division_on_the_edges():
    norms = [0, 1, 2, 3, 2 ** 38, 2 ** 38 - 1, 2 * 32768 ** 2]
    norms += [2 ** k + j for k in range(1, 38) for j in (-1, 0, 1)]
    ws = [-32768, -32767, -1, 0, 1, 32766, 32767]
    es = [-65535, -65534, -1, 0, 1, 65534, 65535]
    nums = [(w * MU2) * e for w in ws for e in es] + [MU2 * e for e in es]
    nums += [-0.0, 0.0, (-32768 * MU2) * -65535, (-32768 * MU2) * 65535]
    pairs = [(a, d) for a in nums for d in _divisors(norms)]
    _check_pairs(pairs)
    # the sign of zero: -0 / d is -0 (the FMAs alone would give +0)
    assert _bits(_quotient(-0.0, EPS)) == _bits(-0.0)
    assert _bits(_quotient((-5 * MU2) * 0.0, 7.0 + EPS)) == _bits(-0.0)


def _sequential_norms(x, hist):
    """The plain version's energy at every sample (kernels/nlms.py:nlms_plain)."""
    B, T = x.shape
    w = torch.cat([torch.zeros(B, 1, dtype=torch.float64), hist.to(torch.float64)], 1)
    norm = (w * w).sum(1)
    xf = x.to(torch.float64)
    out = []
    for t in range(T):
        xt, old = xf[:, t], w[:, 0]
        w = torch.cat([w[:, 1:], xt[:, None]], 1)
        norm = (norm + xt * xt) - old * old
        out.append(norm)
    return torch.stack(out, 1)


def _chunked_norms(x, hist):
    """The kernel's energy: per chunk, lane s forms x_s^2 - old_s^2 (old the
    sample 256 back: a zero at t = 0, then hist, then x), an inclusive scan
    in int64 adds them onto the carried energy, converted to f64 at the end."""
    B, T = x.shape
    h, xi = hist.to(torch.int64), x.to(torch.int64)
    stream = torch.cat([h, xi], 1)  # sample t at column t + 255
    old = torch.cat([torch.zeros(B, 1, dtype=torch.int64), stream[:, :max(T - 1, 0)]], 1)
    norm = (h * h).sum(1)
    out = []
    for t0 in range(0, T, CHUNK):
        xc, oc = xi[:, t0:t0 + CHUNK], old[:, t0:t0 + CHUNK]
        scan = torch.cumsum(xc * xc - oc * oc, 1) + norm[:, None]
        norm = scan[:, -1]
        out.append(scan)
    return torch.cat(out, 1).to(torch.float64)


@pytest.mark.parametrize("T", [1, 31, 32, 33, 255, 256, 257, 300])
def test_chunked_energy_equals_sequential_sum(T):
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.integers(-32768, 32768, (3, T)).astype(np.int16))
    x[1] = 32767
    hist = torch.from_numpy(rng.integers(-32768, 32768, (3, K8.KEEP)).astype(np.int16))
    hist[2] = -32768
    want, got = _sequential_norms(x, hist), _chunked_norms(x, hist)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal((got + EPS).view(torch.int64), (want + EPS).view(torch.int64))
