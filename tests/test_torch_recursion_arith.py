"""The arithmetic K8 and K9 (csrc/nlms.cu) compute in place of their plain
versions', held bit for bit against them on the CPU, where no card is needed:

- the doubling folded into mu: RN(RN(2w)*MU) == RN(w*RN(2*MU)) for every int16
  w, at K8's mu and K9's;
- the quotient from one reciprocal, RN(a/d) as q0 = a*y, r0 = fma(-q0, d, a),
  q1 = fma(r0, y, q0), r1 = fma(-q1, d, a), q = copysign(fma(r1, y, q1), a)
  with y = RN(1/d), each FMA modelled exactly with fractions, against IEEE
  a / d (sign of zero included) over each kernel's ranges and their edges;
- K8's window energy per 32-sample chunk (an inclusive scan of x^2 - old^2
  on the carried energy) against the plain version's sequential sum, and
  K9's per 1024-sample block (segment scans of u^2 over the 1151-sample
  window) against its plain version's energies.
"""

import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.kernels import bnlms as K9
from jeicyboodsp_tpu_torch.kernels import nlms as K8

MU, EPS = K8.MU, K8.EPS
MU2 = 2.0 * MU
CHUNK = 32  # samples per chunk: one per lane of the kernel's warp
# each kernel's mu, eps and largest window energy: K8 256 taps, K9 128
RANGES = {"K8": (K8.MU, K8.EPS, 2 ** 38), "K9": (K9.MU, K9.EPS, 2 ** 37)}


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


@pytest.mark.parametrize("kernel", sorted(RANGES))
def test_doubling_folds_into_mu_for_every_int16(kernel):
    mu = RANGES[kernel][0]
    w = np.arange(-32768, 32768, dtype=np.float64)
    assert np.array_equal(((2.0 * w) * mu).view(np.int64), (w * (2.0 * mu)).view(np.int64))


def _divisors(norms, eps):
    return [float(n) + eps for n in norms]  # RN(norm + EPS): norms are exact integers


@pytest.mark.parametrize("kernel", sorted(RANGES))
def test_quotient_matches_ieee_division_on_random_pairs(kernel):
    """20,000 pairs from the kernel's ranges: int16 w, e in +-65535, integer
    window energies in [0, 2^38] (K8, 256 taps) or [0, 2^37] (K9, 128 taps);
    numerators RN(RN(w*2MU)*e), and for K8 a quarter of them the non-compat
    RN(2MU*e)."""
    mu, eps, top = RANGES[kernel]
    rng = np.random.default_rng(20261017)
    n = 20000
    w = rng.integers(-32768, 32768, n).astype(np.float64)
    e = rng.integers(-65535, 65536, n).astype(np.float64)
    # norms spread over every binade up to the top, not only the top ones
    norms = np.floor(2.0 ** rng.uniform(0, math.log2(top), n)).astype(np.int64)
    a = (w * (2.0 * mu)) * e
    if kernel == "K8":
        a[::4] = (2.0 * mu) * e[::4]
    _check_pairs(zip(a.tolist(), _divisors(norms.tolist(), eps)))


@pytest.mark.parametrize("kernel", sorted(RANGES))
def test_quotient_matches_ieee_division_on_the_edges(kernel):
    """d = EPS, window energies at powers of two and the top, a = +-0, the
    largest |a| and the smallest nonzero |a| (|w| = |e| = 1)."""
    mu, eps, top = RANGES[kernel]
    mu2 = 2.0 * mu
    kmax = int(math.log2(top))
    norms = [0, 1, 2, 3, top, top - 1, 2 * 32768 ** 2]
    norms += [2 ** k + j for k in range(1, kmax) for j in (-1, 0, 1)]
    ws = [-32768, -32767, -1, 0, 1, 32766, 32767]
    es = [-65535, -65534, -1, 0, 1, 65534, 65535]
    nums = [(w * mu2) * e for w in ws for e in es] + [mu2 * e for e in es]
    nums += [-0.0, 0.0, (-32768 * mu2) * -65535, (-32768 * mu2) * 65535]
    pairs = [(a, d) for a in nums for d in _divisors(norms, eps)]
    _check_pairs(pairs)
    # the sign of zero: -0 / d is -0 (the FMAs alone would give +0)
    assert _bits(_quotient(-0.0, eps)) == _bits(-0.0)
    assert _bits(_quotient((-5 * mu2) * 0.0, 7.0 + eps)) == _bits(-0.0)


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


def _k9_block_energies(u):
    """K9's window energies of one block: (B, 1151) window -> (B, 1024).
    Thread t < 64 squares u[64s + t] of each of the 18 segments s of 64 (the
    1152nd slot zero); a scan within each warp of 32 gives the exclusive
    prefix, warp 1 adds warp 0's total, so P_s(t) is the sum over the threads
    before t and B_s the segment's total (warp 0's + warp 1's); sample
    64s + t's window is ((B_s - P_s(t)) + B_{s+1}) + P_{s+2}(t).  Every value
    is an integer below 2^40, exact in f64."""
    B = u.shape[0]
    seg = K9.THREADS
    v = torch.cat([u * u, torch.zeros(B, 1, dtype=torch.float64)], 1).reshape(B, -1, 2, 32)
    inc = torch.cumsum(v, 3)  # each warp's inclusive scan
    w0, w1 = inc[:, :, 0, -1:], inc[:, :, 1, -1:]
    P = torch.cat([inc[:, :, 0] - v[:, :, 0], (inc[:, :, 1] - v[:, :, 1]) + w0], 2)
    tot = w0 + w1
    E = ((tot[:, :-2] - P[:, :-2]) + tot[:, 1:-1]) + P[:, 2:]
    assert v.shape[1] == 18 and E.shape[1] * seg == K9.BLOCK
    return E.reshape(B, K9.BLOCK)


@pytest.mark.parametrize("signal", ["random", "full_scale", "sparse"])
def test_k9_block_energy_equals_plain_version(signal):
    """K9's segment-scan energies equal its plain version's (a cumulative sum
    of u^2 over the window, differenced) at every sample of blocks whose
    keep is nonzero, then + EPS as the divisor."""
    rng = np.random.default_rng(7)
    B = 4
    if signal == "random":
        u = rng.integers(-32768, 32768, (B, K9.KEEP + K9.BLOCK))
    elif signal == "full_scale":
        u = rng.choice([-32768, 32767], (B, K9.KEEP + K9.BLOCK))
    else:
        u = rng.integers(-32768, 32768, (B, K9.KEEP + K9.BLOCK)) * (rng.random((B, 1151)) < 0.01)
    u[:, :K9.KEEP] = np.where(u[:, :K9.KEEP] == 0, 3, u[:, :K9.KEEP])  # nonzero keep
    u = torch.from_numpy(u.astype(np.float64))
    cs = torch.cat([torch.zeros(B, 1, dtype=torch.float64), torch.cumsum(u * u, 1)], 1)
    want = cs[:, K9.TAPS:] - cs[:, :-K9.TAPS]  # bnlms_plain's energies
    got = _k9_block_energies(u)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert torch.equal((got + K9.EPS).view(torch.int64), (want + K9.EPS).view(torch.int64))
    seq = torch.stack([(u[:, i:i + K9.TAPS] ** 2).sum(1) for i in range(0, K9.BLOCK, 97)], 1)
    assert torch.equal(got[:, ::97], seq)
