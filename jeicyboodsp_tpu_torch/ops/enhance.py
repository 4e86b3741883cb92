"""Wiener / spectral-subtraction enhancement chain in torch.

Counterpart of ``jeicyboodsp_tpu/ops/enhance.py`` for its four fused
engines and the two-kernel f32 engine ``_enhance_fused``.  The latch row
pack is torch ops on (T,) vectors; the rest runs in kernels whose wrappers
launch hand-written CUDA kernels on a CUDA tensor and their plain versions
on a CPU tensor:

- ``mxu8f`` (hq) and ``mxu8t`` (turbo inverse): the VAD kernel K14
  (:func:`vad_flags`), then the whole chain in one kernel,
  :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.enhance_full8`;
- ``mxu8`` and ``mxu3``: a forward kernel (int8 K2 or f32 K4) with the
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
from jeicyboodsp_tpu_torch.kernels.enhance_full8 import enhance_full8, noise_latch
from jeicyboodsp_tpu_torch.kernels.enhance_fwd import enhance_fwd
from jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8 import enhance_fwd_int8
from jeicyboodsp_tpu_torch.kernels.vad_flags import vad_flags as vad_kernel
from jeicyboodsp_tpu_torch.ops.dft import int8_col_split
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI, c_short, hamming_ref
from jeicyboodsp_tpu_torch.utils.device import entry_device

BLOCK_LEN = 512
FFT_SIZE = 1024
NOISE_FRAMES = 10
ENGINES = ("mxu8f", "mxu8t", "mxu8", "mxu3")


@functools.lru_cache(maxsize=4)
def _vad_window(device: torch.device):
    """The second half of the f32 Hamming window, computed on ``device``."""
    return hamming_ref(FFT_SIZE, torch.float32, device)[BLOCK_LEN:]


def vad_flags(blocks):
    """VAD over (T, 512) int16 blocks -> (T,) bool (True=speech), in f32
    as the fused chain computes it, through the K14 wrapper.

    Semantics of WienerFilter_final.cpp:261-296 including the in-place int16
    window truncation and the windowed[i] x raw[i+1] ZCR pairing.  The window
    is this function's own f32 Hamming half, not the f64-built ``w2`` of
    :func:`_dft_mats_aligned` that K2 and K4 read (ROADMAP R8).
    """
    return vad_kernel(blocks, _vad_window(blocks.device))


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
    noise = ~speech
    minus1 = torch.full_like(idx, -1)
    last_speech = torch.cummax(torch.where(speech, idx, minus1), 0).values
    cnt = torch.where(noise, idx - last_speech, 0)
    upd = noise & (cnt >= 2)
    halve = upd & (cnt >= 3)
    c = torch.where(upd, torch.where(cnt >= 3, 0.5, 1.0), 0.0).to(torch.float32)
    k2 = torch.cumsum(halve.to(torch.int32), 0).view(T // L, L)
    base = torch.cat([torch.zeros(1, dtype=k2.dtype, device=k2.device), k2[:-1, -1]])
    lk = (k2 - base[:, None]).reshape(T).to(torch.float32)
    w = c * torch.exp2(lk)  # exact power-of-two scalings
    p = torch.exp2(-lk)
    latch = upd & (cnt == NOISE_FRAMES)
    g = torch.cummax(torch.where(latch, idx, minus1), 0).values
    pg = torch.where(g >= 0, p[g.clamp(min=0)], 0.0)
    z = torch.zeros_like(w)
    return torch.stack([w, p, g.to(torch.float32), pg, z, z, z, z], dim=1)


def _noise_latch_parts(speech, planes, chunk: int = 64):
    """Closed-form noise latch over the magnitude planes (mag (T, 512),
    mag_n (T, 1)): the latched noise estimates (ns, ns_n) of every row
    (WienerFilter_final.cpp:97-159).  Rows past T, up to a multiple of
    ``chunk``, count as speech."""
    mag, mag_n = planes
    T = mag.shape[0]
    pad = (-T) % chunk
    sp = torch.cat([speech, torch.ones(pad, dtype=torch.bool, device=speech.device)])
    if pad:
        mag, mag_n = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in planes)
    ns, ns_n = noise_latch(_latch_rowpack(sp, L=chunk), mag, mag_n, chunk)
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


def enhance_constants(device, arrays=None):
    """The chain's bases as tensors on ``device``.

    ``arrays``: None for this package's numpy basis functions, or a tuple of the
    three dicts (aligned, int8, int8_back) the JAX package's basis functions return.
    The int8 bases are stored transposed ([out column, contraction]) so a
    kernel reads each output column's weights contiguously; the f32 bases
    keep the JAX layout ([contraction, out column]).  The J flip matrix of
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
    rowpack = _latch_rowpack(vad_flags(bp), L=L)
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


def enhance_blocks(blocks, mode: str = "wiener", emit_all: bool = False,
                   fft_engine: str = "mxu8f"):
    """Run the full chain over (T, 512) int16 blocks on their device.

    Engines (the JAX package's names): ``mxu8f`` int8, whole chain in one
    kernel; ``mxu8t`` the same with the turbo inverse; ``mxu8`` int8,
    forward and back kernels around the latch; ``mxu3`` the same in f32.

    Returns (out, write_mask): out is (T, 512) int16; blocks with
    write_mask False are not part of the reference's output stream
    (warm-up frames t<2).  With ``emit_all`` the warm-up rows are zeros.
    """
    if fft_engine not in ENGINES:
        raise NotImplementedError(
            f"fft_engine {fft_engine!r} is not ported yet (ROADMAP.md queue 1, "
            "item 2: the f64/xla compat path (d), the plain mxu path (e)); "
            f"ported: {ENGINES}, and the two-kernel f32 engine as the private "
            "_enhance_fused"
        )
    if mode not in ("wiener", "specsub"):
        raise ValueError(mode)
    if fft_engine in ("mxu8f", "mxu8t"):
        return _enhance_fused_full(blocks, mode, emit_all, hq=(fft_engine == "mxu8f"))
    return _enhance_fused3(blocks, mode, emit_all, int8=(fft_engine == "mxu8"))


def run_stream(x, mode: str = "wiener", fft_engine: str = "mxu8f", device="cuda"):
    """Host convenience: full signal in, reference-equivalent byte stream out.

    Runs on ``device``, a CUDA card unless the caller asks for the CPU
    (``device="cpu"`` runs the kernels' plain versions); raises if that card
    is missing.
    """
    dev = entry_device(device)
    x = np.asarray(x, dtype=np.int16)
    if len(x) == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)
    blocks = stale_blocks(x, BLOCK_LEN)  # a partial final block keeps the stale tail
    out, mask = enhance_blocks(
        torch.from_numpy(np.ascontiguousarray(blocks)).to(dev), mode=mode,
        fft_engine=fft_engine,
    )
    return out[mask].reshape(-1).cpu().numpy()
