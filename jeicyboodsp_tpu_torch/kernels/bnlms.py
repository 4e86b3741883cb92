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
``_bnlms_gates`` does, but as JAX's own op computes the correlation
(``jeicyboodsp_tpu/ops/nlms.py:125-141``): with a float64 FFT of the
1151-sample processing buffers (``torch.fft`` on the tensors' device), in
chunks of rows, where the TPU kernel's wrapper runs a matmul DFT for the
MXU.  The correlations are sums of products of int16 samples, so the
oracle's direct f64 sums are exact integers and the gate opens iff one of
them is at least 1; the FFT's error is far below 0.5 (about 1e-3 at full
scale), so the gate tests ``> 0.5`` and equals the oracle's decision.

- :func:`bnlms` is the wrapper: on a CUDA tensor it launches the hand-written
  kernel of ``csrc/nlms.cu`` (counted in ``bnlms.launches``); on a CPU
  tensor it runs the plain version; anything else raises.
- :func:`bnlms_plain` is the plain PyTorch version: per block, the estimate
  as 128 tap-ordered vector adds and the gradient as 1024 sample-ordered
  ones.
- :func:`bnlms_f32` and :func:`bnlms_f32_plain` are the f32 instance
  (``jb_bnlms_f32``, counted in ``bnlms_f32.launches``), the JAX op's
  float32 form (``jeicyboodsp_tpu/ops/nlms.py:bnlms_apply_block(dtype=
  float32)``, what ``bnlms --fast`` runs): f32 coefficients, the estimate in
  the same tap order in f32, ``g_i = RN(RN(2*MU*e_i) / d_i)`` with ``d_i =
  RN(RN_f32(E_i) + EPS)`` from the same exact energies, ``grad[j] = sum_i
  RN(u[j+i] * g_i)`` in sample order and ``c += grad / 1024`` under the gate;
  every op rounded once.  The gate stays the exact one of
  :func:`bnlms_gates`.
"""

from __future__ import annotations

import ctypes

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check, check_2d
from jeicyboodsp_tpu_torch.utils.cnum import c_short

TAPS = 128  # BNLMS.cpp BNLMS_TAPS
KEEP = TAPS - 1
THREADS = TAPS // 2  # the kernel's block: two adjacent taps a thread
BLOCK = 1024
MU = 0.01
EPS = 0.00001
# FFT length: any m >= 1151 + 1023 gives the linear correlation; 2176 = 2^7 * 17
# timed faster than 2304 and 4096 on an H100 (PERF.md, section 6)
GATE_M = 2176
GATE_ROWS = 8192  # (stream, block) rows per chunk of the gate's transforms


def init_state(B: int, device=None, dtype=torch.float64):
    """Fresh streams: zero coefficients (``dtype``), zero keep."""
    return (torch.zeros(B, TAPS, dtype=dtype, device=device),
            torch.zeros(B, KEEP, dtype=torch.int16, device=device))


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
    iff max_k corr[k] > 0.  The scale is positive, so that is the sign of the
    largest unscaled sum, an integer: it is computed as irfft(conj(rfft(u)) *
    rfft(r)) over GATE_M points in float64, GATE_ROWS rows at a time, and
    tested against 0.5."""
    B, T = check_2d(x, "x")
    if T % BLOCK:
        raise ValueError(f"T={T} must be a multiple of {BLOCK}")
    nb = T // BLOCK
    if B * nb == 0:
        return torch.zeros(B, nb, dtype=torch.bool, device=x.device)
    m, win = GATE_M, BLOCK + KEEP
    u = _with_keep(x.reshape(B, nb, BLOCK), keep_in).reshape(B * nb, -1)
    r = _with_keep(ref.reshape(B, nb, BLOCK), keep_ref).reshape(B * nb, -1)
    uf = u.flip(1)  # uf[:, j] = u[:, 1150 - j]
    rows = min(GATE_ROWS, B * nb)
    buf = torch.zeros(2 * rows, m, dtype=torch.float64, device=x.device)  # zero-padded
    out = torch.empty(B * nb, dtype=torch.bool, device=x.device)
    for s in range(0, B * nb, rows):
        n = min(rows, B * nb - s)
        # u reversed in time, circularly (u[i] at column -i mod m), so its spectrum is
        # conj(U) and the product needs no conjugate; r as it is
        buf[:n, 0] = u[s:s + n, 0]
        buf[:n, m - win + 1:] = uf[s:s + n, :-1]
        buf[rows:rows + n, :win] = r[s:s + n]
        F = torch.fft.rfft(buf)
        P = torch.mul(F[:n], F[rows:rows + n], out=F[:n])
        # norm="forward": the inverse is not scaled, so corr is m times the sums
        corr = torch.fft.irfft(P, n=m, norm="forward")[:, :BLOCK]
        out[s:s + n] = corr.amax(1) > 0.5 * m
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


def bnlms_f32_plain(x, ref, gates, coef, keep):
    """Plain PyTorch version of :func:`bnlms_f32` (any device)."""
    B, T = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    c = coef.clone()
    kp = keep.to(torch.float32)
    mu2 = torch.tensor(2.0 * MU, **f32)  # RN_f32(0.02) = 2 * RN_f32(0.01)
    eps = torch.tensor(EPS, **f32)
    est = torch.empty_like(x)
    err = torch.empty_like(x)
    for k in range(T // BLOCK):
        blk = slice(k * BLOCK, (k + 1) * BLOCK)
        u = torch.cat([kp, x[:, blk].to(torch.float32)], 1)  # (B, 1151)
        acc = torch.zeros(B, BLOCK, **f32)
        for j in range(TAPS):
            acc = acc + c[:, TAPS - 1 - j, None] * u[:, j:j + BLOCK]
        y = c_short(acc).to(torch.int32)
        e = ref[:, blk].to(torch.int32) - y
        est[:, blk] = y.to(torch.int16)
        err[:, blk] = e.to(torch.int16)
        gate = gates[:, k]
        if bool(gate.any()):
            ud = u.to(torch.float64)
            cs = torch.cat([torch.zeros(B, 1, dtype=torch.float64, device=x.device),
                            torch.cumsum(ud * ud, 1)], 1)
            d = (cs[:, TAPS:] - cs[:, :-TAPS]).to(torch.float32) + eps  # exact, rounded once
            g = (mu2 * e.to(torch.float32)) / d
            grad = torch.zeros(B, TAPS, **f32)
            for i in range(BLOCK):  # sample order
                grad = grad + u[:, i:i + TAPS] * g[:, i, None]
            c = torch.where(gate[:, None], c + grad / BLOCK, c)
        kp = u[:, BLOCK:]
    return est, err, (c, kp.to(torch.int16))


def _run(x, ref, gates, state, dtype):
    """The wrapper of either instance: checks, then the kernel on a CUDA
    tensor or the plain version on a CPU tensor."""
    B, T = check_2d(x, "x")
    if T % BLOCK:
        raise ValueError(f"T={T} must be a multiple of {BLOCK}")
    if state is None:
        state = init_state(B, x.device, dtype)
    coef, keep = state
    dev = check({"x": (x, torch.int16, (B, T)), "ref": (ref, torch.int16, (B, T)),
                 "gates": (gates, torch.bool, (B, T // BLOCK)),
                 "coef": (coef, dtype, (B, TAPS)),
                 "keep": (keep, torch.int16, (B, KEEP))})
    if dev.type == "cpu":
        plain = bnlms_plain if dtype == torch.float64 else bnlms_f32_plain
        return plain(x, ref, gates, coef, keep), False
    if B * T == 0:
        return (torch.empty_like(x), torch.empty_like(x), (coef.clone(), keep.clone())), False
    est, err = torch.empty_like(x), torch.empty_like(x)
    new = (torch.empty_like(coef), torch.empty_like(keep))
    _build.launch("jb_bnlms" if dtype == torch.float64 else "jb_bnlms_f32", dev, x.data_ptr(),
                  ref.data_ptr(), gates.data_ptr(), coef.data_ptr(), keep.data_ptr(),
                  est.data_ptr(), err.data_ptr(), new[0].data_ptr(), new[1].data_ptr(), B,
                  T // BLOCK)
    return (est, err, new), True


def bnlms(x, ref, gates, state=None):
    """(B, T) int16 far-end x and near-end ref, T a multiple of 1024, and the
    (B, T/1024) bool gates of :func:`bnlms_gates` -> (est, err (B, T) int16,
    state).  state: ``(coef (B, 128) f64, keep (B, 127) int16)`` from an
    earlier call, or None for fresh streams.  CUDA tensors launch
    ``jb_bnlms``; CPU tensors run :func:`bnlms_plain`."""
    out, launched = _run(x, ref, gates, state, torch.float64)
    bnlms.launches += launched
    return out


bnlms.launches = 0


def bnlms_f32(x, ref, gates, state=None):
    """K9's f32 instance: as :func:`bnlms` with ``coef (B, 128) float32``.
    CUDA tensors launch ``jb_bnlms_f32``; CPU tensors run
    :func:`bnlms_f32_plain`."""
    out, launched = _run(x, ref, gates, state, torch.float32)
    bnlms_f32.launches += launched
    return out


bnlms_f32.launches = 0


def occupancy(device="cuda", dtype=torch.float64) -> int:
    """K9's resident blocks of THREADS threads per SM on ``device``'s card
    (the f64 instance, or the f32 one), as the CUDA runtime computes them
    from its registers and shared memory."""
    blocks = ctypes.c_int(0)
    entry = "jb_bnlms_occupancy" if dtype == torch.float64 else "jb_bnlms_f32_occupancy"
    _build.launch(entry, torch.device(device), ctypes.addressof(blocks))
    return blocks.value
