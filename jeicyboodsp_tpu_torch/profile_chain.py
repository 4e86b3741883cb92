"""Where the time of one ``enhance_blocks`` call goes, per engine, on a card.

    python -m jeicyboodsp_tpu_torch.profile_chain [--engines mxu8f,mxu8t,mxu8,mxu3]
                                                   [--calls 5] [--out DIR]

For each engine: Wiener mode at T = 16384 blocks (chip_smoke.py's signal
and seed), one warm-up call, then ``torch.profiler`` over ``--calls`` calls.
Prints the device time per call of every kernel (ours and torch's), their
sum, and the wall time per call by CUDA events over the same calls; writes
the profiler tables to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

T_FULL = 16384
SEED = 20260817


def _signal(n, rng):
    """chip_smoke.make_signal: a gated 313 Hz tone over N(0, 20) noise."""
    t = np.arange(n) / 16000
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


def profile_engine(blocks, engine, calls, out_dir):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jeicyboodsp_tpu_torch.ops.enhance import enhance_blocks

    run = lambda: enhance_blocks(blocks, "wiener", fft_engine=engine, resynth="ratio")  # noqa: E731
    run()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(calls):
            run()
        b.record()
        torch.cuda.synchronize()
    wall = a.elapsed_time(b) / calls
    rows = []
    for ev in prof.key_averages():  # kernels only: a torch op's row repeats its kernels'
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3 / calls, ev.count // calls, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{engine}: wall {wall:.3f} ms per call (CUDA events), device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for ms, n, key in rows[:14]:
        print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{n:<3d} {key[:90]}")
    with open(os.path.join(out_dir, f"profile_{engine}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engines", default="mxu8f,mxu8t,mxu8,mxu3")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "build", "profile"))
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_chain: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(ns.out, exist_ok=True)
    rng = np.random.default_rng(SEED)
    _signal(192 * 512, rng)  # chip_smoke.py draws its probe first
    x = _signal(T_FULL * 512, rng)
    blocks = torch.from_numpy(x.reshape(T_FULL, 512)).cuda()
    print(torch.cuda.get_device_name(0), torch.__version__)
    for engine in ns.engines.split(","):
        profile_engine(blocks, engine, ns.calls, ns.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
