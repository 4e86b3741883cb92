"""Wiener / spectral-subtraction enhancement chain in torch.

Counterpart of ``jeicyboodsp_tpu/ops/enhance.py``, with its
``enhance_blocks`` signature, defaults and routing:

- the generic path (the default ``fft_engine="xla"`` in float64, the
  compat contract of the CLI): the framed windowed FFT (``torch.fft``, or
  the matmul DFT of :func:`_dft_matrices` for an ``mxu*`` engine without
  ratio resynthesis), the VAD, the sequential noise latch
  :func:`_noise_scan` (or its log-depth form :func:`_noise_assoc_scan`),
  the gain with trig or ratio resynthesis and the OLA, all as torch ops in
  ``dtype`` -- plain XLA in the JAX package, so torch ops on the card here;
- ``mxu`` and ``mxu1`` with ratio resynthesis: the 512-aligned matmul DFT
  with the closed-form noise latch (:func:`_enhance_fast_mxu`), ``mxu1`` at
  the one-pass bf16 tier of :func:`~jeicyboodsp_tpu_torch.ops.dft.matmul`
  (below the 60 dB bar; no CLI reaches it, as in the JAX package);
- the four fused engines, f32 whatever ``dtype``, through kernels whose
  wrappers launch hand-written CUDA kernels on a CUDA tensor and their
  plain versions on a CPU tensor:
  ``mxu8f`` (hq) and ``mxu8t`` (turbo inverse): the VAD kernel K14
  (:func:`vad_flags`), then the whole chain in one kernel,
  :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.enhance_full8`;
  ``mxu8`` and ``mxu3``: a forward kernel (int8 K2 or f32 K4) with the
  in-kernel VAD, the noise latch
  (:func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.noise_latch`) and a
  back kernel (int8 K3 or f32 K5) with the flip, OLA and ``c_short``;
- ``_enhance_fused`` (tests and ``chip_smoke.py`` only, as in the JAX
  package): K4, the noise latch, the back kernel K13 and the OLA assembly
  in torch ops.

The numpy basis functions are copies of the JAX package's (whose module
imports jax); a CPU test holds them byte-identical.

Reference: ``WienerFilter_final.cpp`` / ``SpectralSubtraction_final.cpp``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels.enhance_back import enhance_back
from jeicyboodsp_tpu_torch.kernels.enhance_back_ola3 import enhance_back_ola3
from jeicyboodsp_tpu_torch.kernels.enhance_back_ola8 import enhance_back_ola8
from jeicyboodsp_tpu_torch.kernels.enhance_chunk64 import enhance_chunk64
from jeicyboodsp_tpu_torch.kernels.enhance_full8 import (
    enhance_full8, latch_from_rowpack, noise_latch,
)
from jeicyboodsp_tpu_torch.kernels.enhance_fwd import enhance_fwd, rfft_constants
from jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8 import enhance_fwd_int8
from jeicyboodsp_tpu_torch.kernels.vad_flags import vad_flags as vad_kernel
from jeicyboodsp_tpu_torch.ops.dft import const, int8_col_split, matmul
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI, c_short, hamming_ref
from jeicyboodsp_tpu_torch.utils.device import entry_device
from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY
from jeicyboodsp_tpu_torch.utils.scan import associative_scan

BLOCK_LEN = 512
FFT_SIZE = 1024
NOISE_FRAMES = 10
ENGINES = ("mxu8f", "mxu8t", "mxu8", "mxu3")  # the fused engines, each a chain of kernels
ALL_ENGINES = ("xla", "mxu", "mxu1", "mxu3", "mxu8", "mxu8f", "mxu8t")


@functools.lru_cache(maxsize=4)
def _vad_window(device: torch.device):
    """The second half of the f32 Hamming window, computed on ``device``."""
    return hamming_ref(FFT_SIZE, torch.float32, device)[BLOCK_LEN:]


def vad_flags(blocks, dtype=torch.float64):
    """VAD over (..., 512) int16 blocks -> (...) bool (True=speech), in
    ``dtype``, along the last axis as JAX's (float64 by default, as JAX's).

    Semantics of WienerFilter_final.cpp:261-296 including the in-place int16
    window truncation and the windowed[i] x raw[i+1] ZCR pairing.  In f32
    (the fused chain's VAD) it runs through the K14 wrapper, the leading
    axes flattened to its (N, 512) rows, with this function's own f32
    Hamming half, not the f64-built ``w2`` of :func:`_dft_mats_aligned`
    that K2 and K4 read (ROADMAP R8); in another dtype (the f64 compat path)
    as torch ops in that dtype.  An empty leading axis gives empty flags and
    launches nothing.
    """
    lead = blocks.shape[:-1]
    if dtype == torch.float32:
        if not blocks.numel():
            return torch.zeros(lead, dtype=torch.bool, device=blocks.device)
        rows = blocks.reshape(-1, BLOCK_LEN).contiguous()
        return vad_kernel(rows, _vad_window(blocks.device)).reshape(lead)
    w = hamming_ref(FFT_SIZE, dtype, blocks.device)[BLOCK_LEN:]
    x = blocks.to(dtype)
    s = c_short(x * w).to(dtype)  # truncated windowed samples
    energy = torch.sum(s * s, dim=-1) / FFT_SIZE  # integer terms: exact in f64
    nxt = torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)  # last pairs with 0
    zcr = torch.sum((s * nxt) < 0, dim=-1)
    return (energy > 700.0) | (zcr < 200.0)


def _noise_scan(speech, mags):
    """The sequential noise-estimate state over T blocks, in ``mags``'
    dtype and the scan's own order (WienerFilter_final.cpp:97-108 and
    120-159): ``avg`` is updated row by row, so each row's estimate is the
    reference's to the last bit.

    The flags, and so the run counts and the latch rows, come from the VAD
    alone: they are (T,) vectors worked out first.  Only the rows inside
    noise runs then touch the (T, nb) planes, one small update each.  The
    scan starts from zeros and stops at the last latch row, the rows after
    it changing nothing it returns.  Returns the latched estimate of every
    row (T, nb).
    """
    avg = torch.zeros(mags.shape[1], dtype=mags.dtype, device=mags.device)
    return _noise_rows(speech, mags, 0, avg, None, to_end=False)[0]


def _noise_scan_carry(speech, mags, carry):
    """:func:`_noise_scan` from a carried state ``(cnt, avg, latched)``, the
    scan's state before the first row (a streaming chunk starts partway
    through a run): the counts go on from ``cnt``, the sums from ``avg``,
    and rows before the chunk's first latch hold ``latched``.  Every noise
    row is summed.  Returns ``(ns, (cnt, avg, latched))``, the state after
    the last row."""
    with REGISTRY.span("enhance.cnt", "wait"):
        cnt0 = int(carry[0])
    ns, cnt, avg = _noise_rows(speech, mags, cnt0, carry[1].clone(), carry[2], to_end=True)
    return ns, (cnt[-1].to(torch.int32), avg, ns[-1].clone())


def _noise_rows(speech, mags, cnt0: int, avg, held, to_end: bool):
    """The row loop of both scans: sums the noise rows into ``avg`` in
    place (through the last row if ``to_end``, else through the last latch
    row) and returns ``(ns, cnt, avg)``; rows before the first latch hold
    ``held`` (zeros where it is None)."""
    T, nb = mags.shape
    cnt, run = _run_counts(speech, cnt0)
    latch = run & (cnt == NOISE_FRAMES)
    with REGISTRY.span("enhance.latch_rows", "wait"):
        lrows = torch.nonzero(latch).flatten().tolist()
    end = T if to_end else (lrows[-1] + 1 if lrows else 0)
    with REGISTRY.span("enhance.noise_rows", "wait"):
        rows = torch.nonzero(run[:end]).flatten().tolist()
    with REGISTRY.span("enhance.halve", "wait"):
        halve = (cnt >= 3).tolist()
    snap = torch.empty(len(lrows), nb, dtype=mags.dtype, device=mags.device)
    li = 0
    for t in rows:
        avg.add_(mags[t])
        if halve[t]:
            avg.div_(2.0)  # (avg + m) / 2.0, two roundings as the scan's
        if li < len(lrows) and t == lrows[li]:
            snap[li] = avg
            li += 1
    # row t holds the snapshot of the latest latch row <= t, the carried
    # estimate (zeros) before the first
    before = torch.zeros_like(mags) if held is None else held.expand(T, nb)
    k = torch.cumsum(latch.to(torch.int64), 0) - 1
    ns = torch.where((k >= 0)[:, None], snap[k.clamp(min=0)], before) if lrows else before.clone()
    return ns, cnt, avg


def _run_counts(speech, cnt0: int = 0):
    """(cnt, run): the length of the noise run ending at each row (0 on
    speech), the run going on from ``cnt0`` rows before the first, and
    whether the row updates the running average (cnt >= 2)."""
    idx = torch.arange(speech.shape[0], device=speech.device)
    last_speech = torch.cummax(torch.where(speech, idx, torch.full_like(idx, -1 - cnt0)),
                               0).values
    cnt = torch.where(speech, 0, idx - last_speech)
    return cnt, ~speech & (cnt >= 2)


def runlen_combine(l, r):
    """Segmented-count monoid: (count, all_noise_flag). Identity: (0, True)."""
    cl, fl = l
    cr, fr = r
    return torch.where(fr, cl + cr, cr), fl & fr


def noise_affine_combine(l, r):
    """Noise-state monoid: A' = a*A + b ; N' = s ? ah*A + bh : N.

    Identity: (1, 0, False, 0, 0).  The LAST latch wins on composition.
    Scalar elements (a, s, ah) broadcast against the vector elements (b, bh)
    along a trailing axis.
    """
    al, bl, sl, ahl, bhl = l
    ar, br, sr, ahr, bhr = r
    a_ = ar * al
    b_ = ar[..., None] * bl + br
    s_ = sl | sr
    ah_ = torch.where(sr, ahr * al, ahl)
    bh_ = torch.where(sr[..., None], ahr[..., None] * bl + bhr, bhl)
    return a_, b_, s_, ah_, bh_


def noise_affine_elements(speech, cnt, mags):
    """Per-block monoid elements from VAD flags, run-lengths, magnitudes
    (any leading batch axes after the first, as JAX's)."""
    dtype = mags.dtype
    run = (cnt >= 2) & ~speech
    one = torch.ones((), dtype=dtype, device=mags.device)
    zero = torch.zeros((), dtype=dtype, device=mags.device)
    half = torch.where(cnt >= 3, 0.5 * one, one)
    a = torch.where(run, half, one)
    b = torch.where(run[..., None], half[..., None] * mags, zero)
    s = run & (cnt == NOISE_FRAMES)
    ah = torch.where(s, a, zero)
    bh = torch.where(s[..., None], b, zero)
    return a, b, s, ah, bh


def latched_from_composed(s_, bh_):
    """N_t given zero initial state: latched value or zeros."""
    return torch.where(s_[..., None], bh_, torch.zeros_like(bh_))


def _noise_assoc_scan(speech, mags):
    """Associative-scan version of :func:`_noise_scan` (O(log T) depth).

    Per block the update is affine in the running average A:
        A' = a*A + b*m ,  N' = latch ? A' : N
    Composition is closed (see :func:`noise_affine_combine`), so the whole
    state sequence is a parallel prefix; the sums group otherwise than the
    sequential scan's (a is a power of two, so only additions round apart).
    """
    noise = ~speech
    cnt, _ = associative_scan(runlen_combine, (noise.to(torch.int64), noise))
    elems = noise_affine_elements(speech, cnt, mags)
    _, _, s_, _, bh_ = associative_scan(noise_affine_combine, elems)
    return latched_from_composed(s_, bh_)


def _latch_rowpack(speech, L: int = 64):
    """Per-row latch scalars of the closed-form noise latch.

    The recursion A' = a*A + c*m has a in {1, 1/2}, so with k_t the count of
    halvings up to t, A_t = 2^{-k_t} * sum_{j<=t} 2^{k_j} c_j m_j; the
    powers of two are rebased per chunk of L rows.  Returns a (T, 8) f32
    pack [w = c*2^lk, p = 2^-lk, g = latest latch row (-1 before any), p[g],
    0, 0, 0, 0].  T % L == 0.
    """
    T = speech.shape[0]
    if T % L:
        raise ValueError(f"T={T} must be a multiple of L={L}")
    idx = torch.arange(T, device=speech.device)
    cnt, upd = _run_counts(speech)
    halve = upd & (cnt >= 3)
    c = torch.where(upd, torch.where(cnt >= 3, 0.5, 1.0), 0.0).to(torch.float32)
    k2 = torch.cumsum(halve.to(torch.int32), 0).view(T // L, L)
    base = torch.cat([torch.zeros(1, dtype=k2.dtype, device=k2.device), k2[:-1, -1]])
    lk = (k2 - base[:, None]).reshape(T).to(torch.float32)
    w = c * torch.exp2(lk)  # exact power-of-two scalings
    p = torch.exp2(-lk)
    latch = upd & (cnt == NOISE_FRAMES)
    g = torch.cummax(torch.where(latch, idx, torch.full_like(idx, -1)), 0).values
    pg = torch.where(g >= 0, p[g.clamp(min=0)], 0.0)
    z = torch.zeros_like(w)
    return torch.stack([w, p, g.to(torch.float32), pg, z, z, z, z], dim=1)


def _noise_latch_parts(speech, planes, chunk: int = 64):
    """Closed-form noise latch over the magnitude planes (mag (T, 512),
    mag_n (T, 1)): the latched noise estimates (ns, ns_n) of every row
    (WienerFilter_final.cpp:97-159).  Rows past T, up to a multiple of
    ``chunk``, count as speech.  The latch kernel is f32: planes of another
    dtype take its plain version in their dtype."""
    mag, mag_n = planes
    T = mag.shape[0]
    pad = (-T) % chunk
    sp = torch.cat([speech, torch.ones(pad, dtype=torch.bool, device=speech.device)])
    if pad:
        mag, mag_n = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in planes)
    rowpack = _latch_rowpack(sp, L=chunk)
    if mag.dtype == torch.float32:
        ns, ns_n = noise_latch(rowpack, mag.contiguous(), mag_n.contiguous(), chunk)
    else:
        ns = latch_from_rowpack(rowpack.to(mag.dtype), torch.cat([mag, mag_n], 1), chunk)
        ns, ns_n = ns[:, :BLOCK_LEN], ns[:, BLOCK_LEN:]
    return ns[:T], ns_n[:T]


# ---------------------------------------------------------------- constants


@functools.lru_cache(maxsize=None)
def _dft_mats_aligned():
    """MXU-aligned DFT bases: 512-column forward bases with the Hamming window
    folded in, the Nyquist column split out, and the symmetry-halved inverse
    (u, v) bases -- see the JAX package's docstring of the same name."""
    n = FFT_SIZE
    kk = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * kk / n  # (1024, 513)
    i = np.arange(n)
    ham = (0.54 - 0.46 * np.cos(2.0 * float(REF_PI) * i / (n - 1)))[:, None]
    C = (ham * np.cos(ang)).astype(np.float32)
    S = (ham * np.sin(ang)).astype(np.float32)
    wk = np.full(n // 2 + 1, 2.0)
    wk[0] = wk[-1] = 1.0
    ks = np.arange(n // 2 + 1)[:, None] * np.arange(n // 2)[None, :]
    ang2 = 2.0 * np.pi * ks / n
    UC = (wk[:, None] * np.cos(ang2) / n).astype(np.float32)  # (513, 512)
    VS = (wk[:, None] * np.sin(ang2) / n).astype(np.float32)  # (513, 512)
    y512col = (wk * np.cos(np.pi * np.arange(n // 2 + 1)) / n).astype(np.float32)
    return dict(
        WC=np.ascontiguousarray(C[:, :512]), WS=np.ascontiguousarray(S[:, :512]),
        nyq=np.ascontiguousarray(C[:, 512]),
        UC512=UC[:512], VS512=VS[:512],  # VS[512] is exactly zero
        u_nyq=np.ascontiguousarray(UC[512]), y512col=y512col,
        w2=np.ascontiguousarray(ham[512:, 0].astype(np.float32)),  # VAD half
    )


@functools.lru_cache(maxsize=None)
def _dft_mats_int8():
    """Per-column int8 splits of the window-folded forward bases, with the
    +128 data shift folded into crows (computed in f64)."""
    M = _dft_mats_aligned()
    out = {}
    scales = []
    crows = []
    for name, W in (("C", M["WC"]), ("S", M["WS"])):
        crow = np.zeros(512, np.float64)
        for part, sl in (("p", slice(0, 512)), ("c", slice(512, 1024))):
            Wh, Wl, s1, s2 = int8_col_split(W[sl])
            out[f"Wh{name}{part}"] = Wh
            out[f"Wl{name}{part}"] = Wl
            scales += [s1.astype(np.float32), s2.astype(np.float32)]
            crow += 128.0 * (s1 * Wh.astype(np.int64).sum(0)
                             + s2 * Wl.astype(np.int64).sum(0))
        crows.append(crow.astype(np.float32))
    out["scales"] = np.stack(scales)  # (8, 512): C p s1,s2, C c, S p, S c
    out["crows"] = np.stack(crows)    # (2, 512)
    return out


@functools.lru_cache(maxsize=None)
def _dft_mats_int8_back():
    """Per-column int8 splits of the symmetry-halved inverse bases UC512/VS512."""
    M = _dft_mats_aligned()
    out = {}
    scales = []
    crows = []
    for name, W in (("U", M["UC512"]), ("V", M["VS512"])):
        Wh, Wl, s1, s2 = int8_col_split(W)
        out[f"{name}h"], out[f"{name}l"] = Wh, Wl
        scales += [s1.astype(np.float32), s2.astype(np.float32)]
        crows.append(
            (128.0 * (s1 * Wh.astype(np.int64).sum(0)
                      + s2 * Wl.astype(np.int64).sum(0))).astype(np.float32)
        )
    out["scales"] = np.stack(scales)  # (4, 512): s1U, s2U, s1V, s2V
    out["crows"] = np.stack(crows)    # (2, 512)
    return out


@functools.lru_cache(maxsize=None)
def _dft_matrices():
    """Real-DFT (1024 -> 513 bins) and inverse matrices as numpy f32."""
    n = FFT_SIZE
    k = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k / n
    fwd_re = np.cos(ang).astype(np.float32)
    fwd_im = np.sin(ang).astype(np.float32)
    # inverse real FFT: y[t] = (1/N) sum_k w_k (re_k cos - im_k sin)
    wk = np.full(n // 2 + 1, 2.0)
    wk[0] = wk[-1] = 1.0
    inv_re = (wk[:, None] * np.cos(-ang.T) / n).astype(np.float32)
    inv_im = (wk[:, None] * np.sin(-ang.T) / n).astype(np.float32)
    return fwd_re, fwd_im, inv_re, inv_im


def tf32_split(x):
    """f32 x -> its TF32 halves (hi, lo) as f32 with the 13 low mantissa bits
    zero: hi = x rounded to TF32 (nearest, ties away: PTX ``cvt.rna``), lo =
    x - hi (exact in f32) rounded likewise, so |x - hi - lo| <= 2^-22 |x|."""
    def rna(v):
        bits = np.ascontiguousarray(v).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    x = np.asarray(x, np.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def enhance_constants(device, arrays=None):
    """The chain's bases as tensors on ``device``.

    ``arrays``: None for this package's numpy basis functions, or a tuple of the
    three dicts (aligned, int8, int8_back) the JAX package's basis functions return.
    The int8 bases are stored transposed ([out column, contraction]) so a
    kernel reads each output column's weights contiguously; the f32 bases
    keep the JAX layout ([contraction, out column]); ``back32`` holds the
    TF32 halves of UC512 and VS512, transposed, as the tensor-core inverse
    of K5 and K13 reads them; ``rfft`` the twiddles, split and window of
    K4's real FFT (``kernels.enhance_fwd.rfft_constants``).  The J flip matrix of
    the TPU kernels has no counterpart: the flip is an index permutation here.
    """
    M, F8, B8 = arrays or (_dft_mats_aligned(), _dft_mats_int8(), _dft_mats_int8_back())
    tr = lambda names, d: np.stack([d[k].T for k in names])  # noqa: E731
    host = {
        "fwd8": tr(("WhCp", "WlCp", "WhCc", "WlCc", "WhSp", "WlSp", "WhSc", "WlSc"), F8),
        "fscales": F8["scales"], "fcrows": F8["crows"],
        "back8": tr(("Uh", "Ul", "Vh", "Vl"), B8),
        "bscales": B8["scales"], "bcrows": B8["crows"],
        **{k: M[k] for k in ("nyq", "w2", "WC", "WS", "UC512", "VS512", "u_nyq", "y512col")},
        # the TF32 halves of the f32 inverse bases, [s, k]: Uh Ul Vh Vl (K5, K13)
        "back32": np.stack([h for k in ("UC512", "VS512") for h in tf32_split(M[k].T)]),
        "rfft": rfft_constants(),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}


@functools.lru_cache(maxsize=4)
def _constants_on(device: torch.device):
    return enhance_constants(device)


# ---------------------------------------------------------------- the chain


def _pad_rows(blocks, L):
    """Zero rows pad T to a multiple of L: VAD calls them speech (ZCR 0 <
    200), so the latch does not move and rows < T are as unpadded."""
    pad = (-blocks.shape[0]) % L
    return torch.nn.functional.pad(blocks, (0, 0, 0, pad)) if pad else blocks.contiguous()


def _enhance_fused_full(blocks, mode, emit_all, hq=True, L=64):
    """VAD + latch row pack in torch ops, everything else in the K1 port.

    Returns (out (T, 512) int16, write_mask (T,)): rows t < 2 are warm-up.
    """
    T = blocks.shape[0]
    bp = _pad_rows(blocks, L)
    rowpack = _latch_rowpack(vad_flags(bp, torch.float32), L=L)
    out = enhance_full8(bp, rowpack, _constants_on(bp.device), mode=mode, hq=hq,
                        emit_all=emit_all, L=L)
    write_mask = torch.arange(T, device=blocks.device) >= 2
    return out[:T], write_mask


def _enhance_fused3(blocks, mode, emit_all, int8: bool, hq: bool = True, L: int = 64):
    """Engines mxu8 (``int8``) and mxu3: the forward kernel (K2 or K4) with
    the in-kernel VAD, the noise latch, then the back kernel (K3 or K5)
    with the flip, OLA, ``c_short`` and the warm-up mask.

    Returns (out (T, 512) int16, write_mask (T,)): rows t < 2 are warm-up.
    """
    T = blocks.shape[0]
    bp = _pad_rows(blocks, L)
    C = _constants_on(bp.device)
    re, im, re_n, mag, mag_n, sp = (enhance_fwd_int8 if int8 else enhance_fwd)(bp, C)
    speech = sp[:, 0] > 0.5  # in-kernel VAD (vad_flags semantics)
    ns, ns_n = _noise_latch_parts(speech, (mag, mag_n), chunk=L)
    if int8:
        out = enhance_back_ola8(re, im, re_n, ns, ns_n, C, mode, hq=hq, emit_all=emit_all)
    else:
        out = enhance_back_ola3(re, im, re_n, ns, ns_n, C, mode, emit_all=emit_all)
    write_mask = torch.arange(T, device=blocks.device) >= 2
    return out[:T], write_mask


def _enhance_fused(blocks, mode, emit_all, L: int = 64):
    """The two-kernel f32 engine (JAX ``_enhance_fused``, F = 512): the
    forward kernel K4 with the in-kernel VAD, the noise latch, the back
    kernel K13, then the OLA assembly in torch ops: tail = [y512, flip(w2)
    [1:]], out[t] = c_short(head[t] + tail[t-1]) for t >= 2 (head alone at
    t = 1, zero at t = 0).  Reached only from tests and ``chip_smoke.py``,
    as in the JAX package.

    Returns (out (T, 512) int16, write_mask (T,)): rows t < 2 are warm-up,
    zero unless ``emit_all``.
    """
    T = blocks.shape[0]
    bp = _pad_rows(blocks, L)
    C = _constants_on(bp.device)
    re, im, re_n, mag, mag_n, sp = enhance_fwd(bp, C)
    ns, ns_n = _noise_latch_parts(sp[:, 0] > 0.5, (mag, mag_n), chunk=L)
    head, w2, y512 = enhance_back(re, im, re_n, ns, ns_n, C, mode)
    tail = torch.cat([y512, w2[:, 1:].flip(1)], 1)
    tail_prev = torch.cat([torch.zeros_like(tail[:1]), tail[:-1]])
    t = torch.arange(bp.shape[0], device=bp.device)[:, None]
    out = c_short(torch.where(t >= 1, head + torch.where(t >= 2, tail_prev, 0.0), 0.0))
    if not emit_all:
        out = torch.where(t >= 2, out, 0)
    write_mask = torch.arange(T, device=blocks.device) >= 2
    return out[:T], write_mask


def frame_transform(frames, dtype, real_fft: bool = False, fft_engine: str = "xla"):
    """w * [prev, cur] -> complex spectrum (batched).

    ``real_fft`` computes only the 513 non-redundant bins (the input is
    real).  An ``mxu*`` engine evaluates the 513-bin DFT as two matmuls
    with the f32 bases of :func:`_dft_matrices` in ``dtype`` (full f32 on a
    card: the port never enables TF32; ``mxu1`` at its bf16 tier).
    """
    w = hamming_ref(FFT_SIZE, dtype, frames.device)
    windowed = frames.to(dtype) * w
    if fft_engine.startswith("mxu"):
        fwd_re, fwd_im, _, _ = _dft_matrices()
        return torch.complex(matmul(windowed, const(fwd_re, windowed), fft_engine),
                             matmul(windowed, const(fwd_im, windowed), fft_engine))
    if real_fft:
        return torch.fft.rfft(windowed)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return torch.fft.fft(windowed.to(ctype))


def gain_and_resynth(X, ns, mode: str, real_fft: bool = False, resynth: str = "trig",
                     fft_engine: str = "xla"):
    """Per-bin gain with saved phase -> time-domain frame (batched IFFT).

    ``resynth="trig"`` reproduces the reference's atan2/cos/sin phase
    save/restore literally; ``"ratio"`` uses the identity
    amp*e^{i phase} == X * (amp/|X|) (identical values up to rounding,
    including the NaN cases: a zero bin makes the ratio NaN exactly where
    the reference's gain went NaN).
    """
    xr, xi = X.real, X.imag
    if mode == "wiener":
        P = xr * xr + xi * xi
        v = ns * ns / P  # 0/0 -> nan, k/0 -> inf, as the C code does
        v = torch.where(v >= 1.0, 1.0, v)  # NaN stays NaN (matches C)
        gain = 1.0 - v  # == amp / |X|
        amp = torch.sqrt(P).abs() * gain
    elif mode == "specsub":
        amp = X.abs() - ns
        gain = amp / X.abs()
    else:
        raise ValueError(mode)
    if resynth == "ratio":
        Y = X * gain.to(xr.dtype)
    else:
        phase = torch.atan2(xi, xr)
        Y = torch.complex(amp * torch.cos(phase), amp * torch.sin(phase)).to(X.dtype)
    if fft_engine.startswith("mxu"):
        _, _, inv_re, inv_im = _dft_matrices()
        return (matmul(Y.real, const(inv_re, Y.real), fft_engine)
                - matmul(Y.imag, const(inv_im, Y.real), fft_engine))
    if real_fft:
        return torch.fft.irfft(Y, FFT_SIZE)
    return torch.fft.ifft(Y).real


def _ola(head, tail, emit_all):
    """out[t] = c_short(head[t] + tail[t-1]) for t >= 2, head alone at t = 1
    (row 0 never transformed a frame, :174-179), zero at t = 0; the warm-up
    rows t < 2 are zeroed unless ``emit_all``.  Returns (out, write_mask)."""
    T = head.shape[0]
    tail_prev = torch.cat([torch.zeros_like(tail[:1]), tail[:-1]])
    t = torch.arange(T, device=head.device)
    zero = torch.zeros((), dtype=head.dtype, device=head.device)
    ola = torch.where((t >= 1)[:, None],
                      head + torch.where((t >= 2)[:, None], tail_prev, zero), zero)
    out = c_short(ola)
    write_mask = t >= 2
    if not emit_all:
        out = torch.where(write_mask[:, None], out, torch.zeros_like(out))
    return out, write_mask


def _frames(blocks):
    """(T, 1024) frames [x[t-1], x[t]], zeros before the first block."""
    prev = torch.cat([torch.zeros_like(blocks[:1]), blocks[:-1]])
    return torch.cat([prev, blocks], 1)


def _enhance_fast_mxu(blocks, mode, dtype, emit_all, fft_engine="mxu"):
    """Engines ``mxu`` and ``mxu1`` (JAX ``_enhance_fast_mxu``, its plain
    branch): the 512-aligned matmul DFT with the window folded into the
    bases, the closed-form noise latch, ratio resynthesis and the
    symmetry-halved inverse, as torch ops in ``dtype``, every product at the
    tier of ``fft_engine``; the latch through the
    :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.noise_latch` wrapper
    in f32."""
    frames = _frames(blocks).to(dtype)  # the window is folded into WC/WS/nyq
    M = {k: const(v, frames) for k, v in _dft_mats_aligned().items()}

    def mm(a, b):
        return matmul(a, b, fft_engine)

    re, im = mm(frames, M["WC"]), mm(frames, M["WS"])
    re_n = mm(frames, M["nyq"])  # (T,) Nyquist (im == 0)
    P512 = re * re + im * im
    mag512 = torch.sqrt(P512)
    mag_n = re_n.abs()
    speech = vad_flags(blocks, dtype)
    ns512, ns_n = _noise_latch_parts(speech, (mag512, mag_n[:, None]))
    ns_n = ns_n[:, 0]
    if mode == "wiener":
        v512 = ns512 * ns512 / P512  # 0/0 -> NaN, as the reference
        g512 = 1.0 - torch.where(v512 >= 1.0, 1.0, v512)
        v_n = ns_n * ns_n / (re_n * re_n)
        g_n = 1.0 - torch.where(v_n >= 1.0, 1.0, v_n)
    else:
        g512 = (mag512 - ns512) / mag512
        g_n = (mag_n - ns_n) / mag_n
    Yre, Yim, Yre_n = re * g512, im * g512, re_n * g_n
    u = mm(Yre, M["UC512"]) + Yre_n[:, None] * M["u_nyq"]
    v = mm(Yim, M["VS512"])
    y512 = mm(Yre, M["y512col"][:BLOCK_LEN]) + Yre_n * M["y512col"][BLOCK_LEN]
    tail = torch.cat([y512[:, None], (u + v)[:, 1:].flip(1)], 1)  # y[512:1024]
    return _ola(u - v, tail, emit_all)


def enhance_blocks(blocks, mode: str = "wiener", dtype=torch.float64,
                   use_assoc_scan: bool = False, emit_all: bool = False,
                   real_fft: bool = False, resynth: str = "trig", fft_engine: str = "xla"):
    """Run the full chain over (T, 512) int16 blocks on their device, with
    the JAX package's signature, defaults and routing.

    With ``resynth="ratio"`` an ``mxu*`` engine takes its fast path:
    ``mxu8f`` int8, the whole chain in one kernel; ``mxu8t`` the same with
    the turbo inverse; ``mxu8`` int8, forward and back kernels around the
    latch; ``mxu3`` the same in f32 (these four are f32 kernels whatever
    ``dtype``); ``mxu`` the plain matmul path in ``dtype``, ``mxu1`` the
    same at the one-pass bf16 tier.  Anything else
    runs the generic path in ``dtype``: the frame transform, the VAD, the
    sequential noise scan (``use_assoc_scan``: its log-depth form), the
    gain with ``resynth`` and the OLA.

    Returns (out, write_mask): out is (T, 512) int16; blocks with
    write_mask False are not part of the reference's output stream
    (warm-up frames t<2).  With ``emit_all`` the warm-up rows are zeros.
    """
    if mode not in ("wiener", "specsub"):
        raise ValueError(mode)
    if fft_engine not in ALL_ENGINES:
        raise ValueError(f"fft_engine must be one of {ALL_ENGINES}, got {fft_engine!r}")
    if fft_engine.startswith("mxu") and resynth == "ratio":
        if fft_engine in ("mxu", "mxu1"):
            return _enhance_fast_mxu(blocks, mode, dtype, emit_all, fft_engine)
        if fft_engine in ("mxu8f", "mxu8t"):
            return _enhance_fused_full(blocks, mode, emit_all, hq=(fft_engine == "mxu8f"))
        return _enhance_fused3(blocks, mode, emit_all, int8=(fft_engine == "mxu8"))
    X = frame_transform(_frames(blocks), dtype, real_fft=real_fft, fft_engine=fft_engine)
    mags = X.abs()
    speech = vad_flags(blocks, dtype)
    ns = (_noise_assoc_scan if use_assoc_scan else _noise_scan)(speech, mags)
    y = gain_and_resynth(X, ns, mode, real_fft=real_fft, resynth=resynth,
                         fft_engine=fft_engine)
    # overlap-add: out[t] = y[t][:512] + y[t-1][512:]
    return _ola(y[:, :BLOCK_LEN], y[:, BLOCK_LEN:], emit_all)


def run_stream(x, mode: str = "wiener", dtype=torch.float64, use_assoc_scan: bool = False,
               fft_engine: str = "xla", device="cuda"):
    """Host convenience: full signal in, reference-equivalent byte stream out.

    As the JAX package's: an ``mxu*`` engine runs with ratio resynthesis
    and the real FFT, the others with the reference's trig resynthesis.
    Runs on ``device``, a CUDA card unless the caller asks for the CPU
    (``device="cpu"`` runs the kernels' plain versions); raises if that card
    is missing.
    """
    dev = entry_device(device)
    x = np.asarray(x, dtype=np.int16)
    if len(x) == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)
    blocks = stale_blocks(x, BLOCK_LEN)  # a partial final block keeps the stale tail
    mxu = fft_engine.startswith("mxu")
    out, mask = enhance_blocks(
        torch.from_numpy(np.ascontiguousarray(blocks)).to(dev), mode=mode, dtype=dtype,
        use_assoc_scan=use_assoc_scan, real_fft=mxu, resynth="ratio" if mxu else "trig",
        fft_engine=fft_engine,
    )
    return out[mask].reshape(-1).cpu().numpy()


# ---------------------------------------------------------------- streaming


def stream_init_state(dtype=torch.float64, device="cuda"):
    """Streaming carry for chunked processing / checkpoint-resume, with the
    JAX package's keys, shapes and dtypes: the noise counter ``cnt``, the
    running average ``avg`` and the latched spectrum ``latched``
    (EstimateNoiseSpectrum), the previous block ``prev_block`` (the shared
    keep buffer), the previous synthesis tail ``prev_tail`` (the overlap
    buffer), and the global block index ``t`` (the write warm-up gate).
    Tensors on ``device``, a CUDA card unless the caller asks for the CPU."""
    dev = entry_device(device)
    return {
        "cnt": torch.zeros((), dtype=torch.int32, device=dev),
        "avg": torch.zeros(FFT_SIZE, dtype=dtype, device=dev),
        "latched": torch.zeros(FFT_SIZE, dtype=dtype, device=dev),
        "prev_block": torch.zeros(BLOCK_LEN, dtype=torch.int16, device=dev),
        "prev_tail": torch.zeros(BLOCK_LEN, dtype=dtype, device=dev),
        "t": torch.zeros((), dtype=torch.int32, device=dev),
    }


def state_to_port(state, device="cuda"):
    """A streaming state in the JAX layout (arrays of any kind, their dtypes
    kept) -> tensors on ``device``."""
    dev = entry_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in state.items()}


def state_to_jax(state):
    """The streaming state -> the JAX layout as numpy arrays (what
    ``jnp.asarray`` and ``save_pytree`` take)."""
    return {k: v.cpu().numpy() for k, v in state.items()}


def enhance_chunk(state, blocks, mode: str = "wiener", dtype=torch.float64):
    """Process a chunk of (Tc, 512) int16 blocks (Tc >= 1, on the state's
    device) from an explicit carried state.

    Returns (out (Tc, 512) int16, write_mask (Tc,), new_state).  The chain
    is the generic path's (the framed windowed FFT, the VAD -- K14 in f32 --
    the sequential noise scan from the carry, trig resynthesis), so chunked
    processing with carried state equals one-shot processing exactly; the
    state dict is what checkpoints persist.

    A float64 chunk on a CUDA card runs as one kernel, K15
    (:func:`~jeicyboodsp_tpu_torch.kernels.enhance_chunk64.enhance_chunk64`),
    which reads nothing back to the host; anything else runs the chain as
    torch ops, :func:`enhance_chunk_ops` (K15's plain version).

    While spans are recorded (``utils.metrics``), the call is an
    ``enhance.chunk`` span holding the stage ``enhance.kernel`` on K15's
    route, else :func:`enhance_chunk_ops`' spans.
    """
    if blocks.dim() != 2 or blocks.shape[1] != BLOCK_LEN or not blocks.shape[0]:
        raise ValueError(f"blocks must be (Tc, {BLOCK_LEN}) with Tc >= 1, got {tuple(blocks.shape)}")
    with REGISTRY.span("enhance.chunk"):
        if blocks.is_cuda and dtype == torch.float64:
            with REGISTRY.span("enhance.kernel"):
                return enhance_chunk64(state, blocks.contiguous(), mode)
        return enhance_chunk_ops(state, blocks, mode, dtype)


def enhance_chunk_ops(state, blocks, mode: str = "wiener", dtype=torch.float64):
    """:func:`enhance_chunk`'s chain as torch ops in ``dtype`` on the
    blocks' device: its route on the CPU and in float32, and K15's plain
    version.  While spans are recorded it holds the stages ``enhance.fft``,
    ``enhance.vad``, ``enhance.noise``, ``enhance.resynth`` and
    ``enhance.ola``; each host read of a card value is a ``wait`` span of its
    own (``enhance.cnt``, ``enhance.latch_rows``, ``enhance.noise_rows``,
    ``enhance.halve``, ``enhance.t``).
    """
    blocks = blocks.contiguous()
    Tc = blocks.shape[0]
    with REGISTRY.span("enhance.fft"):
        prev = torch.cat([state["prev_block"][None], blocks[:-1]])
        X = frame_transform(torch.cat([prev, blocks], 1), dtype)
    with REGISTRY.span("enhance.vad"):
        speech = vad_flags(blocks, dtype)
    with REGISTRY.span("enhance.noise"):
        ns, (cnt, avg, latched) = _noise_scan_carry(
            speech, X.abs(), (state["cnt"], state["avg"], state["latched"]))
    with REGISTRY.span("enhance.resynth"):
        y = gain_and_resynth(X, ns, mode)
    with REGISTRY.span("enhance.ola"):
        with REGISTRY.span("enhance.t", "wait"):
            t0 = int(state["t"])
        gidx = t0 + torch.arange(Tc, device=blocks.device)
        tails = torch.cat([state["prev_tail"][None], y[:-1, BLOCK_LEN:]])
        valid, use_tail = (gidx >= 1)[:, None], gidx >= 2
        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        ola = torch.where(valid, y[:, :BLOCK_LEN] + torch.where(use_tail[:, None], tails, zero),
                          zero)
        out = torch.where(use_tail[:, None], c_short(ola), 0)
        new_state = {
            "cnt": cnt,
            "avg": avg,
            "latched": latched,
            "prev_block": blocks[-1].clone(),
            "prev_tail": y[-1, BLOCK_LEN:].clone(),
            "t": state["t"] + Tc,
        }
    return out, use_tail, new_state
