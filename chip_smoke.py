#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- the Wiener / spectral-subtraction chain of
engines mxu8f, mxu8t (kernel K1), mxu8 (K2, K3) and mxu3 (K4, K5) -- at
its full size (T = 16384 blocks of 512 samples per call, 8.39 M samples),
in phases that each print lines and raise on failure:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the CUDA sources with nvcc and prints the seconds;
3. each kernel against its plain version at T = 16384, wiener and specsub:
   K1 >= 90 dB of the int16 outputs with bit-equal forward planes; K2
   re/im planes bit-equal and flags equal; K4 planes within 1e-5 of their
   row max and flags equal; the noise latch within 1e-6; K3 and K5
   >= 90 dB;
4. main path: the file-in/file-out pipelines of every engine on a 192-block
   probe and on the full-size signal, against a float64 numpy reference of
   the reference program (floors: mxu8f and mxu8 78 dB, mxu8t 65 dB, mxu3
   85 dB), plus the empty-payload and partial-final-block cases; every
   kernel's launch count over this phase must be > 0;
5. timing: ``enhance_blocks`` of each engine and each kernel alone against
   its plain version and one PyTorch call of its GEMM core, CUDA events,
   median of 7 after warm-up.

Then the card's line, one JSON line of per-kernel results and, last, the
``{"ok": true, ...}`` line.  Imports neither jax nor the JAX package.
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
FLOORS = {"mxu8f": 78.0, "mxu8t": 65.0, "mxu8": 78.0, "mxu3": 85.0}  # dB vs the reference
KERNEL_VS_PLAIN_DB = 90.0
PLANE_RTOL = 1e-6   # K1's int8 forward planes against the plain version's
F32_RTOL = 1e-5     # K4's f32 planes: its sums run in another order than cuBLAS's
LATCH_RTOL = 1e-6
REPS = 7
# published H100 SXM peaks (dense): bytes/s of HBM3, int8 and bf16 tensor-core op/s
HBM_BPS, INT8_OPS, BF16_OPS = 3.35e12, 1979e12, 989e12


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


def bound(nbytes, ops, peak):
    """The least time (ms) of a kernel on this card: its bytes (each input
    read once, each output written once) over the memory rate, or its
    operations over the peak rate of their type, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got, want):
    """max over rows of the max |error| over the row's max (0 on zero rows)"""
    return float(((got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-30)).max())


def int16_diff(got, want, what):
    """SNR, differing share and max |diff| of two int16 outputs; fails below
    KERNEL_VS_PLAIN_DB."""
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    got, want = got.cpu().numpy(), want.cpu().numpy()
    snr = snr_db(want, got)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"[3 kernel-vs-plain] {what} T={T_FULL}: {snr:.2f} dB, differing samples "
          f"{np.mean(d > 0):.3e}, max |diff| {d.max()}")
    if not snr >= KERNEL_VS_PLAIN_DB:
        raise RuntimeError(f"{what}: kernel vs plain {snr:.2f} dB < {KERNEL_VS_PLAIN_DB}")
    return int(d.max())


def _port():
    """The port's modules, imported from this checkout."""
    sys.path.insert(0, ROOT)
    from types import SimpleNamespace

    from jeicyboodsp_tpu_torch.kernels import _build
    from jeicyboodsp_tpu_torch.kernels import enhance_back_ola3 as K5
    from jeicyboodsp_tpu_torch.kernels import enhance_back_ola8 as K3
    from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K1
    from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
    from jeicyboodsp_tpu_torch.kernels import enhance_fwd_int8 as K2
    from jeicyboodsp_tpu_torch.ops import enhance as E
    from jeicyboodsp_tpu_torch.pipelines import registry

    return SimpleNamespace(_build=_build, K1=K1, K2=K2, K3=K3, K4=K4, K5=K5, E=E,
                           registry=registry)


K1_ENGINES = {"mxu8f": True, "mxu8t": False}  # the engines of K1: hq
MODES = ("wiener", "specsub")


def check_kernels(P, blocks, C, rowpack, speech, sync):
    """Phase 3: every kernel against its plain version on the same inputs.
    Returns the max |kernel - plain| of each and the K3 / K5 inputs (the
    forward kernels' planes and the latch over them)."""
    import torch

    err = {"K1": 0}
    for mode in MODES:
        for eng, hq in K1_ENGINES.items():
            got, pk = P.K1.enhance_full8(blocks, rowpack, C, mode, hq, return_planes=True)
            want, pp = P.K1.enhance_full8_plain(blocks, rowpack, C, mode, hq, return_planes=True)
            sync()
            rel = max(rel_err(pk[k], pp[k]) for k in ("re", "im"))
            err["K1"] = max(err["K1"], int16_diff(got, want, f"K1 {mode} {eng}"))
            print(f"[3 kernel-vs-plain] K1 {mode} {eng}: fwd planes max err/rowmax {rel:.2e}")
            if not rel <= PLANE_RTOL:
                raise RuntimeError(f"K1 forward planes differ: {rel:.2e} > {PLANE_RTOL}")

    back_ins = {}
    for name, (kernel, plain) in {"K2": (P.K2.enhance_fwd_int8, P.K2.enhance_fwd_int8_plain),
                                  "K4": (P.K4.enhance_fwd, P.K4.enhance_fwd_plain)}.items():
        got, want = kernel(blocks, C), plain(blocks, C)
        sync()
        planes = (0, 1, 3)  # re, im, |X|
        err[name] = max(float((got[i] - want[i]).abs().max()) for i in planes)
        rel = max(rel_err(got[i], want[i]) for i in planes)
        bit_equal = all(torch.equal(got[i], want[i]) for i in planes)
        flags_diff = int((got[5] != want[5]).sum())
        vad_diff = int(((got[5][:, 0] > 0.5) != speech).sum())
        print(f"[3 kernel-vs-plain] {name} T={T_FULL}: planes bit-equal {bit_equal}, "
              f"max err/rowmax {rel:.2e}, max |err| {err[name]:.3e}, Nyquist max |err| "
              f"{float((got[2] - want[2]).abs().max()):.3e}; speech flags differing from the "
              f"plain version {flags_diff}, from vad_flags {vad_diff} of {T_FULL}")
        if flags_diff:
            raise RuntimeError(f"{name}: {flags_diff} speech flags differ from the plain version")
        if name == "K2" and not bit_equal:
            raise RuntimeError("K2: re/im/|X| planes are not bit-equal to the plain version")
        if not rel <= F32_RTOL:
            raise RuntimeError(f"{name}: planes differ by {rel:.2e} of the row max > {F32_RTOL}")
        re, im, re_n, mag, mag_n, sp = got
        rp = P.E._latch_rowpack(sp[:, 0] > 0.5)
        ns, ns_n = P.K1.noise_latch(rp, mag, mag_n)
        want_ns = P.K1.latch_from_rowpack(rp, torch.cat([mag, mag_n], 1), 64)
        sync()
        lrel = float((torch.cat([ns, ns_n], 1) - want_ns).abs().max()
                     / want_ns.abs().max().clamp_min(1e-30))
        print(f"[3 kernel-vs-plain] noise latch on {name}'s planes: max err / max "
              f"{lrel:.2e}; {int((rp[:, 2] >= 0).sum())} rows latched")
        if not lrel <= LATCH_RTOL:
            raise RuntimeError(f"noise latch differs by {lrel:.2e} > {LATCH_RTOL}")
        back_ins[name] = (re, im, re_n, ns, ns_n)

    for name, (kernel, plain, fwd) in {
            "K3": (P.K3.enhance_back_ola8, P.K3.enhance_back_ola8_plain, "K2"),
            "K5": (P.K5.enhance_back_ola3, P.K5.enhance_back_ola3_plain, "K4")}.items():
        err[name] = 0
        for mode in MODES:
            got = kernel(*back_ins[fwd], C, mode)
            want = plain(*back_ins[fwd], C, mode)
            sync()
            err[name] = max(err[name], int16_diff(got, want, f"{name} {mode}"))
    return err, back_ins


def drive_main_path(P, dev, cases, sync):
    """Phase 4: the file pipelines of every engine, with every launch
    counter set to 0 just before and read just after.  Returns the counts."""
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    counted = {"K1": P.K1.enhance_full8, "K2": P.K2.enhance_fwd_int8,
               "K3": P.K3.enhance_back_ola8, "K4": P.K4.enhance_fwd,
               "K5": P.K5.enhance_back_ola3, "latch": P.K1.noise_latch}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    refs = {(c, m): reference_enhance(x, m) for c, x in cases.items() for m in MODES}
    for c, x in cases.items():
        x.tofile(os.path.join(work, f"{c}.pcm"))
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = {}
    for c in cases:
        for mode in MODES:
            for eng in FLOORS:
                out = os.path.join(work, f"{c}_{mode}_{eng}.pcm")
                getattr(P.registry, mode)(os.path.join(work, f"{c}.pcm"), out,
                                          fft_engine=eng, device=dev)
                results[c, mode, eng] = np.fromfile(out, "<i2")
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0
    for (c, mode, eng), got in results.items():
        want = refs[c, mode]
        if got.shape != want.shape:
            raise RuntimeError(f"{c} {mode} {eng}: {got.shape} samples, want {want.shape}")
        if not len(want):
            continue
        snr = snr_db(want, got)
        print(f"[4 main-path] {c} {mode} {eng}: {len(got)} samples, {snr:.2f} dB vs reference")
        if not snr >= FLOORS[eng]:
            raise RuntimeError(f"{c} {mode} {eng}: {snr:.2f} dB < {FLOORS[eng]}")
    print(f"[4 main-path] empty payload -> 0 samples for every mode/engine; launches "
          f"{json.dumps(launches)} in {main_s:.1f} s")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the main path did not launch {missing}")
    return launches


def gemm_cores(P, blocks, C, back_ins):
    """One PyTorch call per kernel that computes its GEMM core on the same
    operands (timed as library_ms; the port never calls them); None for K1,
    whose function no single call computes."""
    import torch

    K1, i8 = P.K1, torch.int8
    cur = blocks.to(torch.int32)
    ph, pl = K1._split8(torch.cat([torch.zeros_like(cur[:1]), cur[:-1]]))  # prev rows
    ch, cl = K1._split8(cur)
    a2 = torch.cat([torch.cat([ph, ch], 1), torch.cat([pl, cl], 1)]).to(i8)  # (2T, 1024)
    w8 = C["fwd8"].transpose(1, 2)  # [k, n]: WhCp WlCp WhCc WlCc WhSp WlSp WhSc WlSc
    # B operands column-major, the layout cuBLAS's int8 GEMM takes without a copy
    b2 = torch.cat([torch.cat([w8[i], w8[i + 1], w8[i + 4], w8[i + 5]], 1)
                    for i in (0, 2)]).t().contiguous().t()  # (1024, 2048): 16 dots' MACs
    re, im, re_n, ns, ns_n = back_ins["K2"]
    g, _ = K1.bin_gain(re, im, re_n[:, 0], ns, ns_n[:, 0], "wiener")
    qre, qim = (K1._quant_row_int8(Y, True) for Y in (re * g, im * g))
    a3 = torch.cat([torch.cat([qre[i], qim[i]], 1) for i in (0, 1, 3)]).to(i8)  # h, l, z2
    u8 = C["back8"].transpose(1, 2)  # [k, s]: Uh Ul Vh Vl
    b3 = torch.cat([torch.cat([u8[0], u8[1]], 1),
                    torch.cat([u8[2], u8[3]], 1)]).t().contiguous().t()  # (1024, 1024)
    frames = P.K4.frames_f32(blocks)
    wcs = torch.cat([C["WC"], C["WS"]], 1)  # (1024, 1024)
    re, im, re_n, ns, ns_n = back_ins["K4"]
    g, _ = K1.bin_gain(re, im, re_n[:, 0], ns, ns_n[:, 0], "wiener")
    y5 = torch.stack([re * g, im * g])
    b5 = torch.stack([C["UC512"], C["VS512"]])
    return {"K1": None, "K2": lambda: torch._int_mm(a2, b2), "K3": lambda: torch._int_mm(a3, b3),
            "K4": lambda: frames @ wcs, "K5": lambda: torch.matmul(y5, b5)}


def time_kernels(P, blocks, C, rowpack, back_ins, card, sync):
    """Phase 5: each kernel, its plain version and its GEMM core at
    T = 16384 in turns, with its bound.  Returns the numbers per kernel."""
    import torch

    K1, K2, K3, K4, K5 = P.K1, P.K2, P.K3, P.K4, P.K5
    consts = lambda mod: [C[k] for k in mod.CONSTS]  # noqa: E731
    dots = T_FULL * 512 * 512  # MACs of one (T, 512) x (512, 512) product
    runs = {  # kernel, plain version, bytes in + out, operations, peak of their type
        "K1": (lambda: K1.enhance_full8(blocks, rowpack, C, "wiener", True),
               lambda: K1.enhance_full8_plain(blocks, rowpack, C, "wiener", True),
               nbytes(blocks, rowpack, *consts(K1), blocks),  # out: int16 as blocks
               2 * 26 * dots, INT8_OPS),  # hq: 16 forward, 10 inverse int8 dots
        "K2": (lambda: K2.enhance_fwd_int8(blocks, C),
               lambda: K2.enhance_fwd_int8_plain(blocks, C),
               nbytes(blocks, *consts(K2), *K2.enhance_fwd_int8(blocks, C)),
               2 * 16 * dots, INT8_OPS),
        "K3": (lambda: K3.enhance_back_ola8(*back_ins["K2"], C, "wiener"),
               lambda: K3.enhance_back_ola8_plain(*back_ins["K2"], C, "wiener"),
               nbytes(*back_ins["K2"], *consts(K3), blocks),
               2 * 10 * dots, INT8_OPS),
        "K4": (lambda: K4.enhance_fwd(blocks, C), lambda: K4.enhance_fwd_plain(blocks, C),
               nbytes(blocks, *consts(K4), *K4.enhance_fwd(blocks, C)),
               3 * 2 * 4 * dots, BF16_OPS),  # 4 f32 GEMMs as bf16x3 on tensor cores
        "K5": (lambda: K5.enhance_back_ola3(*back_ins["K4"], C, "wiener"),
               lambda: K5.enhance_back_ola3_plain(*back_ins["K4"], C, "wiener"),
               nbytes(*back_ins["K4"], *consts(K5), blocks),
               3 * 2 * 2 * dots, BF16_OPS),
    }
    library = gemm_cores(P, blocks, C, back_ins)
    times = {}
    for name, (kern, plain, nb, ops, peak) in runs.items():
        ms, plain_ms = median_ms(kern, sync), median_ms(plain, sync)
        lib_ms = median_ms(library[name], sync) if library[name] else None
        b_ms, b_by = bound(nb, ops, peak)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms)
        print(f"[5 timing] {name} wiener T={T_FULL} on {card}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, GEMM core {'-' if lib_ms is None else '%.3f ms' % lib_ms}, "
              f"bound {b_ms:.4f} ms by {b_by} ({nb / 1e6:.1f} MB, {ops:.3g} ops)")
    mag, mag_n = K2.enhance_fwd_int8(blocks, C)[3:5]
    latch = (median_ms(lambda: K1.noise_latch(rowpack, mag, mag_n), sync),
             median_ms(lambda: K1.latch_from_rowpack(rowpack, torch.cat([mag, mag_n], 1), 64),
                       sync))
    print(f"[5 timing] noise latch T={T_FULL} on {card}: kernel {latch[0]:.3f} ms, "
          f"plain {latch[1]:.3f} ms")
    return times


def time_chains(P, blocks, C, card, sync):
    """Phase 5: ``enhance_blocks`` of each engine against the same chain of
    plain versions."""
    import torch

    K1, E = P.K1, P.E

    def plain_chain(eng):
        sp = E.vad_flags(blocks)
        if eng in K1_ENGINES:
            return K1.enhance_full8_plain(blocks, E._latch_rowpack(sp), C, "wiener",
                                          K1_ENGINES[eng])
        fwd, back = ((P.K2.enhance_fwd_int8_plain, P.K3.enhance_back_ola8_plain)
                     if eng == "mxu8" else
                     (P.K4.enhance_fwd_plain, P.K5.enhance_back_ola3_plain))
        re, im, re_n, mag, mag_n, sp = fwd(blocks, C)
        ns = K1.latch_from_rowpack(E._latch_rowpack(sp[:, 0] > 0.5),
                                   torch.cat([mag, mag_n], 1), 64)
        return back(re, im, re_n, ns[:, :512].contiguous(), ns[:, 512:].contiguous(), C,
                    "wiener")

    for eng in FLOORS:
        ms = median_ms(lambda: E.enhance_blocks(blocks, "wiener", fft_engine=eng), sync)
        plain_ms = median_ms(lambda: plain_chain(eng), sync)
        print(f"[5 timing] wiener {eng} T={T_FULL} on {card}: enhance_blocks {ms:.3f} ms = "
              f"{T_FULL * 512 / (ms * 1e-3):.4g} samples/s; plain version {plain_ms:.3f} ms = "
              f"{T_FULL * 512 / (plain_ms * 1e-3):.4g} samples/s")


SOURCES = {  # kernel: wrapper name, CUDA source, line of the TPU wrapper it replaces
    "K1": ("enhance_full8", "enhance_full8.cu", 737),
    "K2": ("enhance_fwd_int8", "enhance_mxu8.cu", 217),
    "K3": ("enhance_back_ola8", "enhance_mxu8.cu", 491),
    "K4": ("enhance_fwd", "enhance_mxu3.cu", 87),
    "K5": ("enhance_back_ola3", "enhance_mxu3.cu", 337),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    P = _port()

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
    nvcc = subprocess.run([P._build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    P._build.load_library()
    secs = P._build.build_seconds
    print(f"[2 build] {'nvcc %.1f s' % secs if secs is not None else 'cached'} "
          f"-> {os.path.relpath(P._build.library_path(), ROOT)} ({nvcc})")

    sync = torch.cuda.synchronize
    rng = np.random.default_rng(SEED)  # drawn in bench.py's order: probe, then batch
    probe = make_signal(T_PROBE * 512, rng)
    x_full = make_signal(T_FULL * 512, rng)
    blocks = torch.from_numpy(x_full.reshape(T_FULL, 512)).to(dev)
    C = P.E.enhance_constants(dev)
    speech = P.E.vad_flags(blocks)
    rowpack = P.E._latch_rowpack(speech)

    # 3. kernels against plain versions; 4. main path; 5. timing
    err, back_ins = check_kernels(P, blocks, C, rowpack, speech, sync)
    cases = {"probe": probe, "full": x_full, "partial": probe[: T_PROBE * 512 - 100],
             "empty": probe[:0]}
    launches = drive_main_path(P, dev, cases, sync)
    time_chains(P, blocks, C, card, sync)
    times = time_kernels(P, blocks, C, rowpack, back_ins, card, sync)

    print(card)
    print(json.dumps({"kernels": [{
        "name": fn,
        "route": "cuda",
        "source": f"jeicyboodsp_tpu_torch/csrc/{src}",
        "replaces": f"jeicyboodsp_tpu/kernels/enhance_pallas.py:{line}",
        "launches": launches[name],
        "max_abs_err": err[name],
        **times[name],
    } for name, (fn, src, line) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
