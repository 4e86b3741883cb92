"""The MVDR beamformer's float64 reference (BeamForming_MVDR_ver1.cpp;
counterpart of ``jeicyboodsp_tpu/oracle/mvdr.py``)."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI, c_short

MV_BLOCK, MV_KEEP, MV_FFT = 512, 511, 1024  # BeamForming_MVDR_ver1.cpp
MV_THRESHOLD, MV_FS = 700.0, 16000.0


def reference_mvdr(xl, xr, d_time=0.0):
    """float64 numpy reference of BeamForming_MVDR_ver1.cpp (a copy of
    jeicyboodsp_tpu/oracle/mvdr.py): 512-sample stereo blocks of the shorter
    channel (stale tails), the left channel's energy VAD on [zeros(511), x,
    0], a never-reset 2x2 correlation R summed from the unwindowed FFTs of
    [previous noise block, block] once two noise blocks follow each other,
    frames [keep(511), x, 0] whose keep is the current block's first 511
    samples, weights R^-1 c / (c^H R^-1 c), the overwrite-sequencing quirk,
    samples 511..1022 of the IFFT to short, written from the second block."""
    w = 0.54 - 0.46 * np.cos(2.0 * REF_PI * np.arange(MV_FFT) / (MV_FFT - 1))
    xl, xr = np.asarray(xl, np.int16), np.asarray(xr, np.int16)
    n = min(len(xl), len(xr))
    noise_cnt, count = 0, 0
    temp_l, temp_r = np.zeros(MV_BLOCK, np.int16), np.zeros(MV_BLOCK, np.int16)
    R = np.zeros((2, 2))
    keep_l, keep_r = np.zeros(MV_KEEP), np.zeros(MV_KEEP)
    prev_l, prev_r = np.zeros(MV_BLOCK, np.int16), np.zeros(MV_BLOCK, np.int16)
    i = np.arange(MV_FFT)
    ang = 2.0 * REF_PI * i * (MV_FS / MV_FFT) * d_time
    c = np.stack([np.ones(MV_FFT, np.complex128), np.cos(ang) + 1j * np.sin(ang)])
    out = []
    for s in range(0, n, MV_BLOCK):
        bl, br = xl[s: s + MV_BLOCK], xr[s: s + MV_BLOCK]
        if len(bl) < MV_BLOCK:
            bl = np.concatenate([bl, prev_l[len(bl):]])
        if len(br) < MV_BLOCK:
            br = np.concatenate([br, prev_r[len(br):]])
        prev_l, prev_r = bl, br
        frame = np.zeros(MV_FFT, np.int64)
        frame[MV_KEEP: MV_KEEP + MV_BLOCK] = bl
        if not np.sum(c_short(frame * w).astype(np.float64) ** 2) / MV_FFT > MV_THRESHOLD:
            noise_cnt += 1
            if noise_cnt > 1:
                L = np.fft.fft(np.concatenate([temp_l, bl]).astype(np.float64), MV_FFT)
                Rt = np.fft.fft(np.concatenate([temp_r, br]).astype(np.float64), MV_FFT)
                R[0, 0] += np.sum(L.real ** 2 + L.imag ** 2) / MV_FFT
                R[0, 1] += np.sum(-L.real * Rt.imag + L.imag * Rt.real) / MV_FFT
                R[1, 0] += np.sum(-Rt.real * L.imag + Rt.imag * L.real) / MV_FFT
                R[1, 1] += np.sum(Rt.real ** 2 + Rt.imag ** 2) / MV_FFT
            temp_l, temp_r = bl.copy(), br.copy()
        else:
            noise_cnt = 0
        count += 1
        frame_l, frame_r = np.zeros(MV_FFT), np.zeros(MV_FFT)
        frame_l[:MV_KEEP], frame_r[:MV_KEEP] = keep_l, keep_r
        frame_l[MV_KEEP: MV_KEEP + MV_BLOCK], frame_r[MV_KEEP: MV_KEEP + MV_BLOCK] = bl, br
        L, Rf = np.fft.fft(frame_l), np.fft.fft(frame_r)
        Rc = R.astype(np.complex128)
        with np.errstate(divide="ignore", invalid="ignore"):
            det = Rc[0, 0] * Rc[1, 1] - Rc[0, 1] * Rc[1, 0]
            Rinv = np.array([[Rc[1, 1], -Rc[0, 1]], [-Rc[1, 0], Rc[0, 0]]],
                            dtype=np.complex128) / det
            wv = Rinv @ c
            wv = wv / (np.conj(c) * wv).sum(axis=0)
        wl_r, wl_i, wr_r, wr_i = wv[0].real, -wv[0].imag, wv[1].real, -wv[1].imag
        L0 = L.real * wl_r - L.imag * wl_i
        L1 = L0 * wl_i + L.imag * wl_r
        R0 = Rf.real * wr_r - Rf.imag * wr_i
        R1 = R0 * wr_i + Rf.imag * wr_r
        y = np.fft.ifft((L0 + R0) + 1j * (L1 + R1)).real
        if count > 1:
            out.append(c_short(y[MV_KEEP: MV_KEEP + MV_BLOCK]))
        keep_l = frame_l[MV_KEEP: 2 * MV_KEEP].copy()
        keep_r = frame_r[MV_KEEP: 2 * MV_KEEP].copy()
    return np.concatenate(out) if out else np.zeros(0, np.int16)


run = reference_mvdr
