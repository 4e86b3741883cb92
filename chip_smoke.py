#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- the Wiener / spectral-subtraction chain of
engines mxu8f and mxu8t -- at its full size (T = 16384 blocks of 512
samples per call, 8.39 M samples), in phases that each print one line and
raise on failure:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the CUDA sources with nvcc and prints the seconds;
3. kernel against plain version at T = 16384 for {wiener, specsub} x
   {mxu8f, mxu8t}: SNR >= 90 dB of the int16 outputs, forward re/im planes
   within 1e-6 of their row max;
4. main path: the file-in/file-out pipelines on a 192-block probe and on
   the full-size signal, against a float64 numpy reference of the
   reference program (SNR >= 78 dB for mxu8f, >= 65 dB for mxu8t), plus the
   empty-payload and partial-final-block cases; the kernel's launch count
   over this phase must be > 0;
5. timing: ``enhance_blocks`` and the kernel alone, kernel path against
   plain version, CUDA events, median of 7 after warm-up.

Then one JSON line of per-kernel results and, last, the ``{"ok": true, ...}``
line.  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_FULL = 16384  # blocks per call (8.39 M samples), the benchmark's size
T_PROBE = 192   # blocks of the fidelity probe
FS = 16000
SEED = 20260817
FLOORS = {"mxu8f": 78.0, "mxu8t": 65.0}  # dB vs the reference (ENGINE_FIDELITY)
KERNEL_VS_PLAIN_DB = 90.0
PLANE_RTOL = 1e-6
REPS = 7


def make_signal(n, rng):
    """Noisy gated 313 Hz tone: speech-like on/off segments over N(0, 20) noise."""
    t = np.arange(n) / FS
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


def _c_short(v):
    t = np.trunc(np.asarray(v, np.float64))
    ok = np.isfinite(t) & (t >= -(2 ** 31)) & (t <= 2 ** 31 - 1)
    return np.where(ok, t, -(2.0 ** 31)).astype(np.int64).astype(np.int32).astype(np.int16)


def reference_enhance(x, mode="wiener"):
    """float64 numpy reference of WienerFilter_final.cpp /
    SpectralSubtraction_final.cpp: 512-sample blocks (a partial last block
    keeps the previous block's stale tail), VAD on [zeros, x], the
    10-frame noise latch, the gain with saved phase, 512-shift OLA, output
    from the third block on, double -> short truncation."""
    x = np.asarray(x, np.int16)
    if len(x) == 0:
        return np.zeros(0, np.int16)
    T = -(-len(x) // 512)
    xb = np.zeros(T * 512, np.int16)
    xb[: len(x)] = x
    blocks = xb.reshape(T, 512)
    if len(x) % 512 and T > 1:
        blocks[-1, len(x) % 512:] = blocks[-2, len(x) % 512:]
    w = 0.54 - 0.46 * np.cos(2.0 * 3.141592 * np.arange(1024) / 1023)
    raw = blocks.astype(np.int64)
    s = _c_short(raw * w[512:]).astype(np.int64)
    energy = np.sum(s.astype(np.float64) ** 2, axis=1) / 1024
    zcr = np.sum(s[:, :-1] * raw[:, 1:] < 0, axis=1)
    speech = (energy > 700.0) | (zcr < 200.0)
    prev = np.concatenate([np.zeros((1, 512), np.int16), blocks[:-1]])
    X = np.fft.fft(np.concatenate([prev, blocks], axis=1).astype(np.float64) * w, axis=1)
    mags = np.abs(X)
    latched = np.zeros((T, 1024))
    cnt, avg, lat = 0, np.zeros(1024), np.zeros(1024)
    for t in range(T):
        cnt = 0 if speech[t] else cnt + 1
        if cnt >= 2:
            avg = avg + mags[t]
            if cnt >= 3:
                avg = avg / 2.0
            if cnt == 10:
                lat = avg.copy()
        latched[t] = lat
    with np.errstate(divide="ignore", invalid="ignore"):
        if mode == "wiener":
            P = X.real ** 2 + X.imag ** 2
            v = latched ** 2 / P
            amp = np.abs(np.sqrt(P)) * (1.0 - np.where(v >= 1.0, 1.0, v))
        else:
            amp = mags - latched
    phase = np.arctan2(X.imag, X.real)
    y = np.fft.ifft(amp * np.cos(phase) + 1j * amp * np.sin(phase), axis=1).real
    out = _c_short(y[1:-1, 512:] + y[2:, :512])  # written from t = 2 on
    return out.reshape(-1)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, sync):
    import torch

    fn()  # warm-up
    sync()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        sync()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from jeicyboodsp_tpu_torch.kernels import _build
    from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K
    from jeicyboodsp_tpu_torch.ops import enhance as E
    from jeicyboodsp_tpu_torch.pipelines import registry
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    # 1. device
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: true f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {card}")
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")

    # 2. build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    _build.load_library()
    secs = _build.build_seconds
    print(f"[2 build] {'nvcc %.1f s' % secs if secs is not None else 'cached'} "
          f"-> {os.path.relpath(_build.library_path(), ROOT)} ({nvcc})")

    sync = torch.cuda.synchronize
    rng = np.random.default_rng(SEED)  # drawn in bench.py's order: probe, then batch
    probe = make_signal(T_PROBE * 512, rng)
    x_full = make_signal(T_FULL * 512, rng)
    blocks = torch.from_numpy(x_full.reshape(T_FULL, 512)).to(dev)
    C = E.enhance_constants(dev)
    speech = E.vad_flags(blocks)
    rowpack = E._latch_rowpack(speech)
    engines = {"mxu8f": True, "mxu8t": False}

    # 3. kernel against plain version
    max_abs_err = 0
    for mode in ("wiener", "specsub"):
        for eng, hq in engines.items():
            got, pk = K.enhance_full8(blocks, rowpack, C, mode, hq, return_planes=True)
            want, pp = K.enhance_full8_plain(blocks, rowpack, C, mode, hq, return_planes=True)
            sync()
            got, want = got.cpu().numpy(), want.cpu().numpy()
            snr = snr_db(want, got)
            diff = float(np.mean(got != want))
            err = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
            max_abs_err = max(max_abs_err, err)
            rel = max(
                float(((pk[k] - pp[k]).abs().amax(1) / pp[k].abs().amax(1)).max())
                for k in ("re", "im")
            )
            print(f"[3 kernel-vs-plain] {mode} {eng} T={T_FULL}: {snr:.2f} dB, "
                  f"differing samples {diff:.3e}, max |diff| {err}, "
                  f"fwd planes max err/rowmax {rel:.2e}")
            if not snr >= KERNEL_VS_PLAIN_DB:
                raise RuntimeError(f"kernel vs plain {snr:.2f} dB < {KERNEL_VS_PLAIN_DB}")
            if not rel <= PLANE_RTOL:
                raise RuntimeError(f"forward planes differ: {rel:.2e} > {PLANE_RTOL}")

    # 4. main path, file in / file out; count kernel launches over it
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    cases = {
        "probe": probe,
        "full": x_full,
        "partial": probe[: T_PROBE * 512 - 100],
        "empty": probe[:0],
    }
    refs = {(c, m): reference_enhance(x, m) for c, x in cases.items()
            for m in ("wiener", "specsub")}
    for c, x in cases.items():
        x.tofile(os.path.join(work, f"{c}.pcm"))
    K.enhance_full8.launches = 0
    t0 = time.perf_counter()
    results = {}
    for c in cases:
        for mode in ("wiener", "specsub"):
            for eng in engines:
                out = os.path.join(work, f"{c}_{mode}_{eng}.pcm")
                getattr(registry, mode)(os.path.join(work, f"{c}.pcm"), out,
                                        fft_engine=eng, device=dev)
                results[c, mode, eng] = np.fromfile(out, "<i2")
    sync()
    launches = K.enhance_full8.launches
    main_s = time.perf_counter() - t0
    for (c, mode, eng), got in results.items():
        want = refs[c, mode]
        if got.shape != want.shape:
            raise RuntimeError(f"{c} {mode} {eng}: {got.shape} samples, want {want.shape}")
        if c == "empty":
            continue
        snr = snr_db(want, got)
        print(f"[4 main-path] {c} {mode} {eng}: {len(got)} samples, {snr:.2f} dB vs reference")
        if not snr >= FLOORS[eng]:
            raise RuntimeError(f"{c} {mode} {eng}: {snr:.2f} dB < {FLOORS[eng]}")
    print(f"[4 main-path] empty payload -> 0 samples for every mode/engine; "
          f"enhance_full8 launches {launches} in {main_s:.1f} s")
    if launches == 0:
        raise RuntimeError("the main path did not launch enhance_full8")

    # 5. timing at T = 16384, kernel path and plain version in turns
    def plain_chain(eng):
        sp = E.vad_flags(blocks)
        return K.enhance_full8_plain(blocks, E._latch_rowpack(sp), C, "wiener", engines[eng])

    times = {}
    for eng, hq in engines.items():
        times[eng] = {
            "chain": median_ms(lambda: E.enhance_blocks(blocks, "wiener", fft_engine=eng), sync),
            "chain_plain": median_ms(lambda: plain_chain(eng), sync),
            "k1": median_ms(lambda: K.enhance_full8(blocks, rowpack, C, "wiener", hq), sync),
            "k1_plain": median_ms(lambda: K.enhance_full8_plain(blocks, rowpack, C, "wiener", hq), sync),
        }
        sps = {k: T_FULL * 512 / (v * 1e-3) for k, v in times[eng].items()}
        print(f"[5 timing] wiener {eng} T={T_FULL} on {card}: enhance_blocks "
              f"{times[eng]['chain']:.3f} ms = {sps['chain']:.4g} samples/s; plain "
              f"{times[eng]['chain_plain']:.3f} ms = {sps['chain_plain']:.4g} samples/s; "
              f"K1 alone {times[eng]['k1']:.3f} ms, plain {times[eng]['k1_plain']:.3f} ms")

    print(json.dumps({"kernels": [{
        "name": "enhance_full8",
        "route": "cuda",
        "source": "jeicyboodsp_tpu_torch/csrc/enhance_full8.cu",
        "replaces": "jeicyboodsp_tpu/kernels/enhance_pallas.py:737",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": times["mxu8f"]["k1"],
        "plain_ms": times["mxu8f"]["k1_plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
