"""Card time of the recursion kernels K6-K9 and of the ops around them.

    python jeicyboodsp_tpu_torch/profile_recursions.py [--reps 7] [--tag NAME]
        [--geq-streams 2048] [--aec-streams 1024]

At chip_smoke.py's sizes and from its seed: K6 (f64 and its f32 instance)
and K7 over 2048 streams x 49,152 samples, K8 with compat on and off, K9 and
the BNLMS gate (a float64 FFT) over 1024 streams x 65,536 samples, and the
ops ``geq_apply`` (f64 and f32), ``nlms_apply`` and ``bnlms_apply``.  Fewer streams show
what one warp's chain costs alone: a recursion kernel whose time does not
grow with the streams is bound by its chain, not by the card's throughput.
Each time is the median of ``--reps`` calls between CUDA events after a
warm-up; beside it the SM clock nvidia-smi reads while a further batch of
calls runs, so a time can be turned into cycles per step.  Prints one line per item and, last, a
JSON object of the times.

The script imports the port from the import path, not from its own
checkout: run it with ``PYTHONPATH`` set to another checkout's root to time
that checkout's kernels (its library builds there), so two versions can be
timed in turns on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

SEED = 20260817
GEQ_B, GEQ_T = 2048, 49152
AEC_B, AEC_T = 1024, 65536


def geq_streams(dev, B):
    """chip_smoke.make_geq_streams: a tone over N(0, 500) per stream, the
    first B/8 streams full-scale random int16."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.arange(GEQ_T, **f32) / 48000.0
    f = 50.0 + 8000.0 * torch.rand(B, 1, generator=g, **f32)
    amp = 8000.0 * torch.rand(B, 1, generator=g, **f32)
    x = amp * torch.sin(2 * np.pi * f * t) + 500.0 * torch.randn(B, GEQ_T, generator=g, **f32)
    x = x.clamp(-32768, 32767).to(torch.int16)
    x[: B // 8] = torch.randint(-32768, 32768, (B // 8, GEQ_T), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int16)
    return x


def aec_streams(dev, B):
    """chip_smoke.make_aec_streams: far ends N(0, 3000), near ends their echo
    plus noise, a quarter with a near-end talker."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32 = dict(dtype=torch.float32, device=dev)
    x = (3000.0 * torch.randn(B, AEC_T, generator=g, **f32)).clamp(-32768, 32767).round()

    def delay(v, k):
        return torch.nn.functional.pad(v, (k, 0))[:, :AEC_T]

    r = 0.5 * x + 0.2 * delay(x, 7) - 0.1 * delay(x, 19)
    r = r + 50.0 * torch.randn(B, AEC_T, generator=g, **f32)
    r[3 * B // 4:] += 2000.0 * torch.randn(B - 3 * B // 4, AEC_T, generator=g, **f32)
    return x.to(torch.int16), r.clamp(-32768, 32767).to(torch.int16)


def _smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Median ms of ``reps`` single calls after a warm-up, and the SM clock
    (MHz) nvidia-smi reads while three more calls run."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    for _ in range(3):
        fn()
    clock = _smi("clocks.sm")
    torch.cuda.synchronize()
    return float(np.median(times)), clock


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--tag", default="")
    ap.add_argument("--geq-streams", type=int, default=GEQ_B)
    ap.add_argument("--aec-streams", type=int, default=AEC_B)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_recursions: needs a CUDA device")
    import jeicyboodsp_tpu_torch as pkg
    from jeicyboodsp_tpu_torch.kernels import bnlms as K9
    from jeicyboodsp_tpu_torch.kernels import geq_cascade as K7
    from jeicyboodsp_tpu_torch.kernels import geq_cascade_quant as K6
    from jeicyboodsp_tpu_torch.kernels import nlms as K8
    from jeicyboodsp_tpu_torch.ops import geq as G
    from jeicyboodsp_tpu_torch.ops import nlms as N

    dev = torch.device("cuda:0")
    card = _smi("name,power.limit")
    print(f"[{args.tag}] {card}; port from {pkg.__file__}")
    gb, ab = args.geq_streams, args.aec_streams
    geq = geq_streams(dev, gb)
    x, r = aec_streams(dev, ab)
    b, a = G.geq_coefficients()
    c64 = torch.from_numpy(K7.pack_coefficients(b, a, np.float64)).to(dev)
    c32 = torch.from_numpy(K7.pack_coefficients(b, a)).to(dev)
    gf = geq.float()
    xb, rb = x.reshape(ab, -1, 1024), r.reshape(ab, -1, 1024)
    keep = torch.zeros(ab, 127, dtype=torch.int16, device=dev)
    gates = K9.bnlms_gates(x, r, keep, keep)
    gz = {"xh": torch.zeros(gb, 2, dtype=torch.int32),
          "yh": torch.zeros(gb, 7, 2, dtype=torch.int32)}
    nz = {k: v.expand(ab, *v.shape).contiguous() for k, v in N.nlms_init_state().items()}
    bz = {k: v.expand(ab, *v.shape).contiguous() for k, v in N.bnlms_init_state().items()}
    runs = {
        "K6": (lambda: K6.geq_cascade_quant(geq, c64), GEQ_T),
        "K6 f32": (lambda: K6.geq_cascade_quant(geq, c32), GEQ_T),
        "K7": (lambda: K7.geq_cascade(gf, c32), GEQ_T),
        "K8 compat": (lambda: K8.nlms(x, r), AEC_T),
        "K8 compat=False": (lambda: K8.nlms(x, r, compat=False), AEC_T),
        "K9": (lambda: K9.bnlms(x, r, gates), AEC_T // 1024),
        "bnlms gates": (lambda: K9.bnlms_gates(x, r, keep, keep), AEC_T // 1024),
        "geq_apply": (lambda: G.geq_apply(geq, b, a, gz, dtype=torch.float64), GEQ_T),
        "geq_apply f32": (lambda: G.geq_apply(geq, b, a, gz), GEQ_T),
        "nlms_apply": (lambda: N.nlms_apply(x, r, nz), AEC_T),
        "bnlms_apply": (lambda: N.bnlms_apply(xb, rb, bz), AEC_T // 1024),
    }
    out = {}
    for name, (fn, steps) in runs.items():
        ms, clock = time_ms(fn, args.reps)
        mhz = float(clock.split()[0])
        out[name] = ms
        B = gb if name.startswith(("K6", "K7", "geq_apply")) else ab
        print(f"[{args.tag}] {name} B={B}: {ms:.3f} ms; SM clock under load {clock}; "
              f"{ms * 1e-3 * mhz * 1e6 / steps:.1f} cycles per step ({steps} steps)")
    print(json.dumps({"tag": args.tag, "card": card, "streams": [gb, ab], "ms": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
