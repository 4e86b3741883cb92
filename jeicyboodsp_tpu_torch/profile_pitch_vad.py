"""Card time of the AMDF kernel K11 with pitch method 2, and of the VAD kernel K14.

    python jeicyboodsp_tpu_torch/profile_pitch_vad.py [--reps 7] [--tag NAME]

At chip_smoke.py's sizes: K11 (``amdf`` at lo = 96) and
``pitch_frames(method=2, mxu, f32)`` over 16,384 frames of 1024, and K14
(``vad_flags``) over 16,384 blocks of 512.  Each time is the median of
``--reps`` batches of back-to-back calls between CUDA events after a warm-up
(a batch runs about 2 ms, as ``chip_smoke.median_ms``), so a short call's
time is the longer of its device time and its host path.  K14 is also run 50
times under ``torch.profiler``: its device busy time and the wall time per
call, whose difference is the wrapper's host path.  That host path is then
taken apart, on 8 rows, where the card is idle most of the time, and on all
16,384: the host microseconds per call (``time.perf_counter`` over many
calls) of the wrapper, of its output's ``torch.empty``, of
``_build.launch`` with the pointers ready, and of the bare ctypes entry.
Prints one line per item and, last, a JSON object of the times.

The script imports the port from the import path, not from its own
checkout: run it with ``PYTHONPATH`` set to another checkout's root to time
that checkout's kernels (its library builds there), so two versions can be
timed in turns on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SEED = 20260817
T = 16384
AMDF_LO = 96
BATCH_MS, BATCH_MAX = 2.0, 50
PROFILED_CALLS = 50
HOST_CALLS = 2000


def _smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def batched_ms(fn, reps):
    """ms per call: the median of ``reps`` batches of back-to-back calls."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    batch = max(1, min(BATCH_MAX, int(BATCH_MS / max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(reps):
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def profiled_ms(fn, calls):
    """Wall ms per call by CUDA events and device busy ms per call, over
    ``calls`` calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            busy += ev.self_cuda_time_total if dev_us is None else dev_us
    return a.elapsed_time(b) / calls, busy / 1e3 / calls


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back calls
    (after a warm-up; the card synchronised before and after)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pitch_vad: needs a CUDA device")
    import jeicyboodsp_tpu_torch as pkg
    from jeicyboodsp_tpu_torch.kernels import _build
    from jeicyboodsp_tpu_torch.kernels import amdf as K11
    from jeicyboodsp_tpu_torch.kernels import vad_flags as K14
    from jeicyboodsp_tpu_torch.ops import enhance as E
    from jeicyboodsp_tpu_torch.ops import features as F

    dev = torch.device("cuda:0")
    card = _smi("name,power.limit")
    print(f"[{args.tag}] {card}; port from {pkg.__file__}")
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.integers(-8000, 8000, (T, 1024)).astype(np.int16)).to(dev)
    blocks = torch.from_numpy(rng.integers(-3000, 3000, (T, 512)).astype(np.int16)).to(dev)
    w2 = E._vad_window(dev)
    runs = {
        "K11 amdf lo=96": lambda: K11.amdf(frames, AMDF_LO),
        "pitch_frames(method=2, mxu, f32)": lambda: F.pitch_frames(
            frames, method=2, dtype=torch.float32, fft_engine="mxu"),
        "K14 vad_flags": lambda: K14.vad_flags(blocks, w2),
    }
    out = {}
    for name, fn in runs.items():
        out[name] = batched_ms(fn, args.reps)
        print(f"[{args.tag}] {name} T={T}: {out[name]:.4f} ms a call in batches; SM clock "
              f"{_smi('clocks.sm')}")
    wall, busy = profiled_ms(runs["K14 vad_flags"], PROFILED_CALLS)
    out["K14 profiled wall"], out["K14 profiled device busy"] = wall, busy
    print(f"[{args.tag}] K14 under torch.profiler, {PROFILED_CALLS} calls: wall {wall:.4f} ms a "
          f"call, device busy {busy:.4f} ms a call, host share {1 - busy / wall:.1%}")
    entry = getattr(_build.load_library(), "jb_vad_flags")
    stream = torch.cuda.current_stream().cuda_stream
    for rows in (8, T):
        cur = blocks[:rows]
        flags = torch.empty(rows, dtype=torch.bool, device=dev)
        ptrs = (cur.data_ptr(), w2.data_ptr(), rows, flags.data_ptr())
        host = {
            "wrapper": lambda: K14.vad_flags(cur, w2),
            "torch.empty": lambda: torch.empty(rows, dtype=torch.bool, device=dev),
            "_build.launch": lambda: _build.launch("jb_vad_flags", dev, *ptrs),
            "ctypes entry": lambda: entry(*ptrs, stream),
        }
        out[f"host us, {rows} rows"] = us = {name: host_us(fn) for name, fn in host.items()}
        print(f"[{args.tag}] K14's host path on {rows} rows, us a call: " + ", ".join(
            f"{name} {v:.2f}" for name, v in us.items()))
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
