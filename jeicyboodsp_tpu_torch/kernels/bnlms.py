"""Block NLMS ("K9"): wrapper, plain version, count, and the double-talk
gate it takes.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/nlms_pallas.py:
bnlms_pallas`` (``_bnlms_kernel``): ``BNLMS.cpp``'s 128-tap block NLMS,
mu = 0.01, coefficients frozen over each 1024-sample block, the gradient
summed over the block and applied at its end, averaged by 1024, when the
double-talk gate allows (``BNLMS.cpp:103-162``), with the reference's
reversed-estimate / direct-update pairing.  The TPU kernel keeps
double-single f32 state; this one computes every sum in f64 in the oracle's
order (``oracle/nlms.py:134-153``), so given the same gate it equals the
oracle bit for bit.  State is carried across calls:

    coef (B, 128) float64, keep (B, 127) int16 (the input samples before the
    call's first, oldest first)

The gate depends on the inputs alone.  :func:`bnlms_gates` computes it for
every block of every stream before the kernel runs, as the JAX package's
``_bnlms_gates`` does: the cross-correlation of the 1151-sample processing
buffers as a matmul DFT (``_gate_bases``), here in float64 and in chunks of
rows.  Its sign then differs from the oracle's direct f64 sums only where
the largest correlation lies within f64 rounding of zero.

- :func:`bnlms` is the wrapper: on a CUDA tensor it launches the hand-written
  kernel of ``csrc/nlms.cu`` (counted in ``bnlms.launches``); on a CPU
  tensor it runs the plain version; anything else raises.
- :func:`bnlms_plain` is the plain PyTorch version: per block, the estimate
  as 128 tap-ordered vector adds and the gradient as 1024 sample-ordered
  ones.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check, check_2d
from jeicyboodsp_tpu_torch.utils.cnum import c_short

TAPS = 128  # BNLMS.cpp BNLMS_TAPS
KEEP = TAPS - 1
BLOCK = 1024
MU = 0.01
EPS = 0.00001
GATE_M = 2176  # DFT length: any m >= 1151 + 1023 gives the linear correlation
GATE_ROWS = 4096  # (stream, block) rows per chunk of the gate's GEMMs


def init_state(B: int, device=None):
    """Fresh streams: zero coefficients, zero keep."""
    return (torch.zeros(B, TAPS, dtype=torch.float64, device=device),
            torch.zeros(B, KEEP, dtype=torch.int16, device=device))


@functools.lru_cache(maxsize=4)
def _gate_bases(device_str):
    """Matmul-DFT bases of the gate's correlation (``nlms_pallas.py:
    _gate_bases``, in float64): forward cos/sin planes over the 1151 rows of
    a processing buffer, (1151, 1089); inverse planes with the irfft weights
    folded in, (1089, 1024)."""
    m = GATE_M
    nbin = m // 2 + 1
    i = np.arange(BLOCK + KEEP)[:, None] * np.arange(nbin)[None, :]
    ang = -2.0 * np.pi * i / m
    wk = np.full(nbin, 2.0)
    wk[0] = wk[-1] = 1.0
    kl = np.arange(nbin)[:, None] * np.arange(BLOCK)[None, :]
    ang2 = 2.0 * np.pi * kl / m
    planes = (np.cos(ang), np.sin(ang), wk[:, None] * np.cos(ang2) / m,
              wk[:, None] * np.sin(ang2) / m)
    return tuple(torch.from_numpy(p).to(device_str) for p in planes)


def _with_keep(blocks, keep):
    """(B, nb, 1024) blocks and (B, 127) keep -> (B, nb, 1151) processing
    buffers: each block behind the previous block's last 127 samples."""
    prev = torch.cat([keep[:, None], blocks[:, :-1, BLOCK - KEEP:]], 1)
    return torch.cat([prev, blocks], -1)


def bnlms_gates(x, ref, keep_in, keep_ref):
    """Double-talk gate of every block (``BNLMS.cpp:164-186``;
    ``nlms_pallas.py:_bnlms_gates``): (B, nb) bool, True = update.

    corr[k] = sum_i u[i] r[i+k] / (2048 - k) over k < 1024 and the 1151-sample
    buffers (reads past them are zero, as the oracle defines them); update
    iff max_k corr[k] > 0.  float64 GEMMs, GATE_ROWS rows at a time."""
    B, T = check_2d(x, "x")
    if T % BLOCK:
        raise ValueError(f"T={T} must be a multiple of {BLOCK}")
    nb = T // BLOCK
    if B * nb == 0:
        return torch.zeros(B, nb, dtype=torch.bool, device=x.device)
    u = _with_keep(x.to(torch.float64).reshape(B, nb, BLOCK), keep_in.to(torch.float64))
    r = _with_keep(ref.to(torch.float64).reshape(B, nb, BLOCK), keep_ref.to(torch.float64))
    u, r = u.reshape(B * nb, -1), r.reshape(B * nb, -1)
    Fc, Fs, Ic, Is = _gate_bases(str(x.device))
    scale = 2.0 * BLOCK - torch.arange(BLOCK, dtype=torch.float64, device=x.device)
    out = torch.empty(B * nb, dtype=torch.bool, device=x.device)
    for s in range(0, B * nb, GATE_ROWS):
        uc, rc = u[s:s + GATE_ROWS], r[s:s + GATE_ROWS]
        Ur, Ui, Rr, Ri = uc @ Fc, uc @ Fs, rc @ Fc, rc @ Fs
        corr = (Ur * Rr + Ui * Ri) @ Ic - (Ur * Ri - Ui * Rr) @ Is  # conj(U) R
        out[s:s + GATE_ROWS] = (corr / scale).amax(1) > 0.0
    return out.reshape(B, nb)


def bnlms_plain(x, ref, gates, coef, keep):
    """Plain PyTorch version of :func:`bnlms` (any device)."""
    B, T = x.shape
    c = coef.clone()
    kp = keep.to(torch.float64)
    est = torch.empty_like(x)
    err = torch.empty_like(x)
    for k in range(T // BLOCK):
        blk = slice(k * BLOCK, (k + 1) * BLOCK)
        u = torch.cat([kp, x[:, blk].to(torch.float64)], 1)  # (B, 1151): u[j + i]
        acc = torch.zeros(B, BLOCK, dtype=torch.float64, device=x.device)
        for j in range(TAPS):  # BNLMS.cpp:126-128, tap order
            acc = acc + c[:, TAPS - 1 - j, None] * u[:, j:j + BLOCK]
        y = c_short(acc).to(torch.int32)
        e = ref[:, blk].to(torch.int32) - y
        est[:, blk] = y.to(torch.int16)
        err[:, blk] = e.to(torch.int16)  # low 16 bits: c_short(double(e))
        gate = gates[:, k]
        if bool(gate.any()):
            cs = torch.cat([torch.zeros(B, 1, dtype=torch.float64, device=x.device),
                            torch.cumsum(u * u, 1)], 1)
            d = (cs[:, TAPS:] - cs[:, :-TAPS]) + EPS  # exact window energies, then + eps
            ef = e.to(torch.float64)
            grad = torch.zeros(B, TAPS, dtype=torch.float64, device=x.device)
            for i in range(BLOCK):  # BNLMS.cpp:137-146, sample order
                grad = grad + (((2.0 * u[:, i:i + TAPS]) * MU) * ef[:, i, None]) / d[:, i, None]
            c = torch.where(gate[:, None], c + grad / BLOCK, c)
        kp = u[:, BLOCK:]
    return est, err, (c, kp.to(torch.int16))


def bnlms(x, ref, gates, state=None):
    """(B, T) int16 far-end x and near-end ref, T a multiple of 1024, and the
    (B, T/1024) bool gates of :func:`bnlms_gates` -> (est, err (B, T) int16,
    state).  state: ``(coef (B, 128) f64, keep (B, 127) int16)`` from an
    earlier call, or None for fresh streams.  CUDA tensors launch
    ``jb_bnlms``; CPU tensors run :func:`bnlms_plain`."""
    B, T = check_2d(x, "x")
    if T % BLOCK:
        raise ValueError(f"T={T} must be a multiple of {BLOCK}")
    if state is None:
        state = init_state(B, x.device)
    coef, keep = state
    dev = check({"x": (x, torch.int16, (B, T)), "ref": (ref, torch.int16, (B, T)),
                 "gates": (gates, torch.bool, (B, T // BLOCK)),
                 "coef": (coef, torch.float64, (B, TAPS)),
                 "keep": (keep, torch.int16, (B, KEEP))})
    if dev.type == "cpu":
        return bnlms_plain(x, ref, gates, coef, keep)
    if B * T == 0:
        return torch.empty_like(x), torch.empty_like(x), (coef.clone(), keep.clone())
    est, err = torch.empty_like(x), torch.empty_like(x)
    new = (torch.empty_like(coef), torch.empty_like(keep))
    _build.launch("jb_bnlms", dev, x.data_ptr(), ref.data_ptr(), gates.data_ptr(),
                  coef.data_ptr(), keep.data_ptr(), est.data_ptr(), err.data_ptr(),
                  new[0].data_ptr(), new[1].data_ptr(), B, T // BLOCK)
    bnlms.launches += 1
    return est, err, new


bnlms.launches = 0
