"""Per-sample NLMS ("K8"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/nlms_pallas.py:
nlms_pallas`` (``_nlms_kernel_impl``): ``NormalLMS.cpp``'s 256-tap NLMS,
mu = 1e-4, the coefficients updated every sample, with the reference's
pairing quirk (estimate against the reversed coefficients, update against
the direct ones; ``NormalLMS.cpp:113``, ``:125``).  The TPU kernel keeps
double-single f32 state; this one keeps f64 state, and its state is carried
across calls, so a stream can be cut into chunks:

    coef (B, 256) float64, hist (B, 255) int16 (the samples before the call's
    first, oldest first)

Arithmetic, shared by the kernel and its plain version: the estimate sums
each 8-tap group in tap order and then the 32 group sums as a fixed tree
(:func:`tree_dot`); the window energy is a running sum of exact integers
(equal to the oracle's sequential sum); the update is the oracle's per-tap
``((2.0*w[j])*MU*e)/d`` (``compat=True``), or ``nlms_apply(compat=False)``'s
``g = (2*MU)*e/d; c[j] += g*w[255-j]``.  The kernel reaches the same bits
by another route: the energy and ``d`` per 32-sample chunk from an exact
integer scan, one correctly rounded ``1/d`` per sample, each quotient from it
with two FMA corrections (bit-equal to IEEE division on its ranges; the
proof is in ``csrc/nlms.cu``), ``2.0*w*MU`` as ``w*(2*MU)``
(``tests/test_torch_recursion_arith.py`` holds each step against this
module's arithmetic on the CPU).

- :func:`nlms` is the wrapper: on a CUDA tensor it launches the hand-written
  kernel of ``csrc/nlms.cu`` (counted in ``nlms.launches``); on a CPU tensor
  it runs the plain version; anything else raises.
- :func:`nlms_plain` is the plain PyTorch version: a loop over samples of
  separate f64 torch ops in the kernel's order.
- :func:`nlms_f32` and :func:`nlms_f32_plain` are the f32 instance
  (``jb_nlms_f32``, counted in ``nlms_f32.launches``), the JAX op's float32
  form (``jeicyboodsp_tpu/ops/nlms.py:nlms_apply(dtype=float32)``, what
  ``nlms --fast`` runs): f32 coefficients, the estimate in the same tree
  order in f32, ``g = RN(RN(2*MU*e) / d)`` once per sample with ``d =
  RN(RN_f32(E) + EPS)`` from the same exact energy ``E``, then ``c[j] +=
  RN(g * w[j])`` (compat) or ``RN(g * w[255-j])``; every op rounded once.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check, check_2d
from jeicyboodsp_tpu_torch.utils.cnum import c_short

TAPS = 256  # NormalLMS.cpp NLMS_TAPS
KEEP = TAPS - 1
MU = 0.0001
EPS = 0.0001
GROUP = 8  # taps per lane of the kernel's warp


def init_state(B: int, device=None, dtype=torch.float64):
    """Fresh streams: zero coefficients (``dtype``), zero history."""
    return (torch.zeros(B, TAPS, dtype=dtype, device=device),
            torch.zeros(B, KEEP, dtype=torch.int16, device=device))


def tree_dot(c, v):
    """sum_j c[j] * v[j] over the last axis (256) in the kernel's order: each
    lane's 8 products in tap order, then the lanes' sums pairwise at
    distance 16, 8, 4, 2, 1 (the xor-shuffle tree)."""
    p = (c * v).reshape(*c.shape[:-1], TAPS // GROUP, GROUP)
    s = p[..., 0]
    for m in range(1, GROUP):
        s = s + p[..., m]
    n = TAPS // GROUP
    while n > 1:
        n //= 2
        s = s[..., :n] + s[..., n:2 * n]
    return s[..., 0]


def nlms_plain(x, ref, coef, hist, compat=True):
    """Plain PyTorch version of :func:`nlms` (any device)."""
    B, T = x.shape
    f64 = dict(dtype=torch.float64, device=x.device)
    c = coef.clone()
    # the window before the first sample; its oldest value (not kept) leaves at once
    w = torch.cat([torch.zeros(B, 1, **f64), hist.to(torch.float64)], 1)
    norm = (w * w).sum(1)  # exact: integers below 2^38
    xf, ri = x.to(torch.float64), ref.to(torch.int32)
    est = torch.empty_like(x)
    err = torch.empty_like(x)
    for t in range(T):
        xt, old = xf[:, t], w[:, 0]
        w = torch.cat([w[:, 1:], xt[:, None]], 1)
        v = w.flip(1)
        norm = (norm + xt * xt) - old * old
        y = c_short(tree_dot(c, v)).to(torch.int32)
        e = ri[:, t] - y
        ef = e.to(torch.float64)[:, None]
        d = (norm + EPS)[:, None]
        if compat:
            c = c + (((2.0 * w) * MU) * ef) / d
        else:
            c = c + (((2.0 * MU) * ef) / d) * v
        est[:, t] = y.to(torch.int16)
        err[:, t] = e.to(torch.int16)  # low 16 bits: c_short(double(e))
    return est, err, (c, w[:, 1:].to(torch.int16))


def nlms_f32_plain(x, ref, coef, hist, compat=True):
    """Plain PyTorch version of :func:`nlms_f32` (any device)."""
    B, T = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    c = coef.clone()
    w = torch.cat([torch.zeros(B, 1, dtype=torch.float64, device=x.device),
                   hist.to(torch.float64)], 1)
    norm = (w * w).sum(1)  # exact integers, as in nlms_plain
    w = w.to(torch.float32)
    xd, xf, ri = x.to(torch.float64), x.to(torch.float32), ref.to(torch.int32)
    mu2 = torch.tensor(2.0 * float(torch.tensor(MU, dtype=torch.float32)), **f32)
    eps = torch.tensor(EPS, **f32)
    est = torch.empty_like(x)
    err = torch.empty_like(x)
    for t in range(T):
        old = w[:, 0].to(torch.float64)
        w = torch.cat([w[:, 1:], xf[:, t, None]], 1)
        v = w.flip(1)
        norm = (norm + xd[:, t] * xd[:, t]) - old * old
        y = c_short(tree_dot(c, v)).to(torch.int32)
        e = ri[:, t] - y
        d = norm.to(torch.float32) + eps  # the exact energy rounded once, then + eps
        g = ((mu2 * e.to(torch.float32)) / d)[:, None]
        c = c + g * (w if compat else v)
        est[:, t] = y.to(torch.int16)
        err[:, t] = e.to(torch.int16)
    return est, err, (c, w[:, 1:].to(torch.int16))


def _run(x, ref, state, compat, dtype):
    """The wrapper of either instance: checks, then the kernel on a CUDA
    tensor or the plain version on a CPU tensor."""
    B, T = check_2d(x, "x")
    if state is None:
        state = init_state(B, x.device, dtype)
    coef, hist = state
    dev = check({"x": (x, torch.int16, (B, T)), "ref": (ref, torch.int16, (B, T)),
                 "coef": (coef, dtype, (B, TAPS)),
                 "hist": (hist, torch.int16, (B, KEEP))})
    if dev.type == "cpu":
        plain = nlms_plain if dtype == torch.float64 else nlms_f32_plain
        return plain(x, ref, coef, hist, compat), False
    if B * T == 0:
        return (torch.empty_like(x), torch.empty_like(x), (coef.clone(), hist.clone())), False
    est, err = torch.empty_like(x), torch.empty_like(x)
    new = (torch.empty_like(coef), torch.empty_like(hist))
    _build.launch("jb_nlms" if dtype == torch.float64 else "jb_nlms_f32", dev, x.data_ptr(),
                  ref.data_ptr(), coef.data_ptr(), hist.data_ptr(), est.data_ptr(),
                  err.data_ptr(), new[0].data_ptr(), new[1].data_ptr(), B, T, int(bool(compat)))
    return (est, err, new), True


def nlms_f32(x, ref, state=None, compat=True):
    """K8's f32 instance: as :func:`nlms` with ``coef (B, 256) float32``.
    CUDA tensors launch ``jb_nlms_f32``; CPU tensors run
    :func:`nlms_f32_plain`."""
    out, launched = _run(x, ref, state, compat, torch.float32)
    nlms_f32.launches += launched
    return out


nlms_f32.launches = 0


def nlms(x, ref, state=None, compat=True):
    """(B, T) int16 far-end x and near-end ref -> (est, err (B, T) int16,
    state).  state: ``(coef (B, 256) f64, hist (B, 255) int16)`` from an
    earlier call, or None for fresh streams.

    The TPU kernel's ``fast`` mode (an O(1) window energy) needs no flag
    here: the running energy is this kernel's only one, and exact.  CUDA
    tensors launch ``jb_nlms``; CPU tensors run :func:`nlms_plain`.
    """
    out, launched = _run(x, ref, state, compat, torch.float64)
    nlms.launches += launched
    return out


nlms.launches = 0
