"""The enhancement chain of engines mxu8f / mxu8t: wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_full8_pallas`` ("K1"): (T, 512) int16 blocks + a (T, 8) latch row
pack -> (T, 512) int16 output, through the int8-split forward rDFT, the
closed-form noise latch, the Wiener / spectral-subtraction gain, per-row
two-level int8 quantization, the int8 inverse, the flip and the OLA.

- :func:`enhance_full8` is the wrapper: on a CUDA tensor it launches the
  hand-written kernels of ``csrc/enhance_full8.cu`` (and counts the launch
  in ``enhance_full8.launches``); on a CPU tensor it runs the plain
  version; anything else raises.
- :func:`enhance_full8_plain` is the plain PyTorch version, written from
  the same formulas: the int8 dots are float64 matmuls of int8-valued
  tensors (exact: |sum| < 2^31 < 2^53) and the f32 epilogues are eager
  torch ops in the JAX operand order.
- :func:`noise_latch` runs K1's latch passes alone over given magnitude
  planes, for engines mxu8 and mxu3 (counted in ``noise_latch.launches``);
  its plain version is :func:`latch_from_rowpack`.

``hq=False`` (mxu8t) keeps the 16-dot forward -- the TPU kernel calls
``_fwd8_plane`` without ``hq`` -- and makes only the inverse turbo: no
``l@Wl`` dot and no level-2 plane.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import (  # noqa: F401  (CONST_SPECS re-exported)
    CONST_SPECS, N, NB, aligned16, check, check_mode, check_rows,
)
from jeicyboodsp_tpu_torch.utils.cnum import c_short

# the constants K1 reads
CONSTS = ("fwd8", "fscales", "fcrows", "nyq", "back8", "bscales", "bcrows", "u_nyq",
          "y512col")


# ---------------------------------------------------------------- plain version


def _i8dot(a, wt):
    """Exact integer dot: (R, K) int-valued @ (N, K)^T, as float64."""
    return a.to(torch.float64) @ wt.to(torch.float64).T


def _split8(x):
    """x = 256*xh + xl + 128 exactly, xh = floor(x/256), both in int8 range."""
    xh = x >> 8
    return xh, x - 256 * xh - 128


def _fwd8_plane(ph, plo, ch, cl, W, s, crow):
    """One spectral plane (enhance_pallas.py:_fwd8_plane, the hq form)."""
    f32 = lambda v: v.to(torch.float32)  # noqa: E731
    zh = 256 * _i8dot(ph, W[0]) + _i8dot(plo, W[0])
    rh = 256 * _i8dot(ph, W[1]) + _i8dot(plo, W[1])
    zc = 256 * _i8dot(ch, W[2]) + _i8dot(cl, W[2])
    rc = 256 * _i8dot(ch, W[3]) + _i8dot(cl, W[3])
    return (s[0] * f32(zh) + s[1] * f32(rh) + s[2] * f32(zc) + s[3] * f32(rc)
            + crow)


def forward8_plain(blocks, C):
    """(T, 512) int16 -> re, im (T, 512) and the Nyquist bin ren (T,)."""
    cur = blocks.to(torch.int32)
    prev = torch.cat([torch.zeros_like(cur[:1]), cur[:-1]])
    ph, plo = _split8(prev)
    ch, cl = _split8(cur)
    W, s, cr = C["fwd8"], C["fscales"], C["fcrows"]
    re = _fwd8_plane(ph, plo, ch, cl, W[0:4], s[0:4], cr[0])
    im = _fwd8_plane(ph, plo, ch, cl, W[4:8], s[4:8], cr[1])
    nyq = C["nyq"]
    ren = prev.to(torch.float32) @ nyq[:N] + cur.to(torch.float32) @ nyq[N:]
    return re, im, ren


def latch_from_rowpack(rowpack, mags, L: int):
    """Closed-form noise latch (ops/enhance.py:_noise_latch_parts) from the
    row pack [w, p, g, p[g]]: ns[t] = p_g*(A0[chunk(g)] + sum_{j<=g, same
    chunk} w_j*m_j), 0 before the first latch.  mags: (T, nb), T % L == 0."""
    T, nb = mags.shape
    Cn = T // L
    w, p, g, pg = (rowpack[:, i] for i in range(4))
    S = (w[:, None] * mags).view(Cn, L, nb).cumsum(1)
    a = p.view(Cn, L)[:, -1]
    A0 = torch.empty(Cn, nb, dtype=mags.dtype, device=mags.device)
    A = torch.zeros(nb, dtype=mags.dtype, device=mags.device)
    for c in range(Cn):  # chunk-state composition; a_c is a power of two
        A0[c] = A
        A = a[c] * A + a[c] * S[c, -1]
    gi = g.to(torch.int64).clamp(min=0)
    ns = pg[:, None] * S.reshape(T, nb)[gi] + pg[:, None] * A0[gi // L]
    return torch.where((g >= 0)[:, None], ns, torch.zeros((), dtype=ns.dtype, device=ns.device))


def frame_nonzero(blocks):
    """(T, 512) int16 blocks -> (T,) bool: whether the frame [x[t-1], x[t]]
    (zeros before the first block) holds a nonzero sample."""
    cur = blocks.ne(0).any(1)
    return cur | torch.cat([cur.new_zeros(1), cur[:-1]])


def bin_gain(re, im, ren, ns, nsn, nz, mode):
    """Gain of every bin and of the Nyquist bin (ren, nsn: (T,)).

    A bin at exactly 0 with its estimate at 0 is 0/0.  Where the frame
    flag ``nz`` (T,), bool or the forward kernels' 0.0 / 1.0, says the
    frame holds a nonzero sample, its gain is 1, so it contributes its 0,
    the reference's value (the reference's float64 spectrum has no
    exactly-zero bin in such a frame; a quantized or float32 one can).  In
    an all-zero frame it stays NaN, as in the reference, which then writes
    the row and the next as zeros.  The JAX package's kernels as written
    leave every 0/0 NaN."""
    rows = nz != 0
    if mode == "wiener":
        P = re * re + im * im
        v = _zero_bins(ns * ns / P, ns, P, rows, 0.0)
        g = 1.0 - torch.where(v >= 1.0, 1.0, v)
        Pn = ren * ren
        vn = _zero_bins(nsn * nsn / Pn, nsn, Pn, rows, 0.0)
        gn = 1.0 - torch.where(vn >= 1.0, 1.0, vn)
    else:
        mag = torch.sqrt(re * re + im * im)
        g = _zero_bins((mag - ns) / mag, ns, mag, rows, 1.0)
        magn = ren.abs()
        gn = _zero_bins((magn - nsn) / magn, nsn, magn, rows, 1.0)
    return g, gn


def _zero_bins(x, ns, p, rows, value):
    """x with ``value`` where ns = p = 0 in a frame that holds a nonzero
    sample (rows, (T,) bool)."""
    rows = rows[:, None] if x.dim() == 2 else rows
    return torch.where((ns == 0) & (p == 0) & rows, value, x)


def _quant_row_int8(Y, hq: bool):
    """Per-row two-level quantization (enhance_pallas.py:_quant_row_int8).
    Returns int-valued float planes h, l, z2 and row scales q, q2.

    ``32512 / ms`` and ``127 / m2`` divide a tensor by a tensor, as JAX and
    the kernels divide: a Python scalar over a tensor is a reciprocal
    multiply in torch, which rounds differently."""
    tiny = torch.tensor(1e-30, dtype=Y.dtype, device=Y.device)
    ms = torch.maximum(Y.abs().amax(1, keepdim=True), tiny)  # NaN propagates
    Z = torch.round(Y * (torch.full_like(ms, 32512.0) / ms))  # half to even, as jnp.rint
    h = torch.floor(Z * (1.0 / 256.0))
    l = Z - 256.0 * h - 128.0
    q = ms * (1.0 / 32512.0)
    if not hq:
        return h, l, q, None, None
    R = Y - q * Z
    m2 = torch.maximum(R.abs().amax(1, keepdim=True), tiny)
    Z2 = torch.round(R * (torch.full_like(m2, 127.0) / m2))
    return h, l, q, Z2, m2 * (1.0 / 127.0)


def _inv_plane8(h, l, W, s1, s2, crow, q, z2, q2, hq: bool):
    """q*(256h + l + 128) @ (s1*Wh + s2*Wl) [+ q2*z2 @ s1*Wh]."""
    f32 = lambda v: v.to(torch.float32)  # noqa: E731
    z = 256 * _i8dot(h, W[0]) + _i8dot(l, W[0])
    r = 256 * _i8dot(h, W[1]) + (_i8dot(l, W[1]) if hq else 0)
    out = q * (s1 * f32(z) + s2 * f32(r) + crow)
    if hq:
        out = out + (q2 * s1) * f32(_i8dot(z2, W[0]))
    return out


def y512_col(Yre, Yren, C):
    """The y512 column of the OLA tail: Yre @ y512col[:512] + Yren*y512col[512]."""
    ycol = C["y512col"]
    return Yre @ ycol[:N] + Yren * ycol[N]


def flip_ola(u, v, y512, emit_all):
    """head = u - v, tail = [y512, flip(u + v)[1:]], OLA with row t-1's
    tail, ``c_short`` -> (T, 512) int16."""
    head = u - v
    tail = torch.cat([y512[:, None], (u + v)[:, 1:].flip(1)], 1)  # the lane flip
    return _ola(head, tail, emit_all)


def quant8_plain(re, im, ren, ns, nsn, nz, C, mode, hq):
    """Gain (:func:`bin_gain`, with the frame flags ``nz``) and per-row
    two-level quantization: the scratch the kernels' gain_quant pass writes
    for the inverse pass.  q8 (6, T, 512) int8: h, l, z2 of Yre, then of
    Yim (z2 zero in turbo); rowsc (T, 8) f32: q_re, q2_re, q_im, q2_im,
    Yren, y512, 0, 0 (q2 zero in turbo)."""
    g, gn = bin_gain(re, im, ren, ns, nsn, nz, mode)
    Yre, Yim, Yren = re * g, im * g, ren * gn
    zero = torch.zeros_like(Yren)
    planes, cols = [], []
    for Y in (Yre, Yim):
        h, l, q, z2, q2 = _quant_row_int8(Y, hq)
        planes += [h, l, z2 if hq else torch.zeros_like(h)]
        cols += [q[:, 0], q2[:, 0] if hq else zero]
    rowsc = torch.stack([*cols, Yren, y512_col(Yre, Yren, C), zero, zero], 1)
    return torch.stack(planes).to(torch.int8), rowsc


def inv8_plain(q8, rowsc, C, hq):
    """The int8 inverse pass on that scratch -> uv (2, T, 512): u from the
    re planes with the Nyquist term Yren*u_nyq, v from the im planes."""
    B, sv, cr = C["back8"], C["bscales"], C["bcrows"]
    u = _inv_plane8(q8[0], q8[1], B[0:2], sv[0], sv[1], cr[0], rowsc[:, 0:1], q8[2],
                    rowsc[:, 1:2], hq)
    u = u + rowsc[:, 4:5] * C["u_nyq"]
    v = _inv_plane8(q8[3], q8[4], B[2:4], sv[2], sv[3], cr[1], rowsc[:, 2:3], q8[5],
                    rowsc[:, 3:4], hq)
    return torch.stack([u, v])


def inverse8_plain(re, im, ren, ns, nsn, nz, C, mode, hq, emit_all, return_planes=False):
    """Back half of the int8 chain (K3's function): gain, per-row two-level
    quantization, int8 inverse, flip, OLA.  ren, nsn, nz: (T,), nz the
    frame flags (:func:`bin_gain`).
    ``return_planes`` also returns the scratch q8, rowsc and uv."""
    q8, rowsc = quant8_plain(re, im, ren, ns, nsn, nz, C, mode, hq)
    uv = inv8_plain(q8, rowsc, C, hq)
    out = flip_ola(uv[0], uv[1], rowsc[:, 5], emit_all)
    return (out, {"q8": q8, "rowsc": rowsc, "uv": uv}) if return_planes else out


def enhance_full8_plain(blocks, rowpack, C, mode="wiener", hq=True,
                        emit_all=False, L=64, return_planes=False):
    """Plain PyTorch version of :func:`enhance_full8` (any device)."""
    re, im, ren = forward8_plain(blocks, C)
    mags = torch.cat([torch.sqrt(re * re + im * im), ren.abs()[:, None]], 1)
    ns = latch_from_rowpack(rowpack, mags, L)
    out, planes = inverse8_plain(re, im, ren, ns[:, :N], ns[:, N], frame_nonzero(blocks), C,
                                 mode, hq, emit_all, return_planes=True)
    return (out, {"re": re, "im": im, **planes}) if return_planes else out


def _ola(head, tail, emit_all):
    T = head.shape[0]
    tail_prev = torch.cat([torch.zeros_like(tail[:1]), tail[:-1]])
    t = torch.arange(T, device=head.device)[:, None]
    m1 = (t >= 1).to(head.dtype)
    m2 = (t >= 2).to(head.dtype)
    out = c_short((head + tail_prev * m2) * m1)
    if not emit_all:  # warm-up rows t < 2 are not part of the stream
        out = torch.where(t >= 2, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


# ---------------------------------------------------------------- wrapper


def back8_scratch(T, device, zeroed=False):
    """The int8 back half's scratch: q8 (6, T, 512) int8, rowsc (T, 8) and
    uv (2, T, 512) f32.  ``zeroed`` for a caller that reads it back: the
    turbo pass writes no level-2 planes, and rowsc's last two slots are
    never written."""
    new = torch.zeros if zeroed else torch.empty
    return (new(6, T, N, dtype=torch.int8, device=device),
            new(T, 8, dtype=torch.float32, device=device),
            torch.empty(2, T, N, dtype=torch.float32, device=device))


def _check(blocks, rowpack, C, mode, L):
    check_mode(mode)
    T = blocks.shape[0] if blocks.dim() == 2 else -1
    check({"blocks": (blocks, torch.int16, (T, N)), "rowpack": (rowpack, torch.float32, (T, 8))},
          C, CONSTS)
    check_rows(T, L)
    check_rows(T, 8)


def enhance_full8(blocks, rowpack, C, mode="wiener", hq=True, emit_all=False,
                  L=64, return_planes=False):
    """(T, 512) int16 blocks + (T, 8) f32 latch row pack -> (T, 512) int16.

    C: constants from ``ops.enhance.enhance_constants``, on blocks' device.
    CUDA tensors launch the hand-written kernels (T a multiple of L and of
    8; on a copy where the blocks do not start on a 16-byte boundary); CPU
    tensors run :func:`enhance_full8_plain`.  ``return_planes`` also
    returns the forward re/im planes and the back half's scratch q8, rowsc
    and uv (as :func:`quant8_plain` and :func:`inv8_plain` lay them out),
    for checks of the forward and inverse passes.
    """
    _check(blocks, rowpack, C, mode, L)
    if blocks.device.type == "cpu":
        return enhance_full8_plain(blocks, rowpack, C, mode, hq, emit_all, L,
                                   return_planes)
    T = blocks.shape[0]
    blocks = aligned16(blocks)
    f32 = dict(dtype=torch.float32, device=blocks.device)
    re = torch.empty(T, N, **f32)
    im = torch.empty(T, N, **f32)
    ren, nz = torch.empty(2, T, **f32)  # the Nyquist bin, the frame flags
    pfx = torch.empty(T, NB, **f32)
    A0 = torch.empty(T // L, NB, **f32)
    q8, rowsc, uv = back8_scratch(T, blocks.device, return_planes)
    out = torch.empty(T, N, dtype=torch.int16, device=blocks.device)
    p = lambda x: x.data_ptr()  # noqa: E731
    _build.launch(
        "jb_enhance_full8", blocks.device,
        p(blocks), p(rowpack), T, L, int(mode == "wiener"), int(hq), int(emit_all),
        *(p(C[k]) for k in CONSTS), p(re), p(im), p(ren), p(nz), p(pfx), p(A0), p(q8), p(rowsc),
        p(uv), p(out),
    )
    enhance_full8.launches += 1
    if return_planes:
        return out, {"re": re, "im": im, "q8": q8, "rowsc": rowsc, "uv": uv}
    return out


enhance_full8.launches = 0


def noise_latch(rowpack, mag, magn, L: int = 64):
    """The closed-form noise latch of engines mxu8 / mxu3 over the 513 bins
    of the magnitude planes mag (T, 512) and magn (T, 1): the latched
    estimates ns (T, 512) and nsn (T, 1), from the (T, 8) row pack of
    ``ops.enhance._latch_rowpack``.  T % L == 0.

    In the JAX package this is XLA glue (``ops/enhance.py:_noise_latch_parts``),
    not a Pallas kernel.  A CUDA tensor launches ``jb_noise_latch`` (K1's
    latch passes, counted in ``noise_latch.launches``); a CPU tensor runs
    :func:`latch_from_rowpack`.
    """
    T = mag.shape[0] if mag.dim() == 2 else -1
    dev = check({"rowpack": (rowpack, torch.float32, (T, 8)),
                 "mag": (mag, torch.float32, (T, N)), "magn": (magn, torch.float32, (T, 1))})
    check_rows(T, L)
    if dev.type == "cpu":
        ns = latch_from_rowpack(rowpack, torch.cat([mag, magn], 1), L)
        return ns[:, :N].contiguous(), ns[:, N:].contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    pfx = torch.empty(T, NB, **f32)
    A0 = torch.empty(T // L, NB, **f32)
    ns = torch.empty(T, N, **f32)
    nsn = torch.empty(T, 1, **f32)
    p = lambda x: x.data_ptr()  # noqa: E731
    _build.launch("jb_noise_latch", dev, p(mag), p(magn), p(rowpack), T, L, p(pfx), p(A0),
                  p(ns), p(nsn))
    noise_latch.launches += 1
    return ns, nsn


noise_latch.launches = 0
