"""The traffic's signals, made on the device from a ``torch.Generator``.

Copies of the smoke test's generators (``chip_smoke.make_signal``, a gated
tone over Gaussian noise, and ``chip_smoke.make_aec_streams``, a far end,
its echo plus noise, and a near-end talker on a share of the streams), with
each recording's parameters drawn from the generator within the ranges a
traffic file gives.  The same seed gives the same signals.
"""

from __future__ import annotations

import math

import torch


def _draw(gen, lo_hi, n, device):
    """n values uniform in [lo, hi] (a fixed value where lo == hi)."""
    lo, hi = (lo_hi, lo_hi) if isinstance(lo_hi, (int, float)) else lo_hi
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return (lo + (hi - lo) * u).tolist()


def gated_tones(lengths, rate, params, gen, device):
    """One int16 recording of each length in ``lengths``: a tone of
    ``tone_hz`` at amplitude ``amp``, on while sin(2 pi gate_hz t + phase) >
    ``gate_level``, over N(0, noise_sd) noise, clipped and truncated to int16
    (``chip_smoke.make_signal``: 313 Hz, 5000, 0.5 Hz, 0.2, 20).  Each
    recording draws its tone, amplitude, noise level and gate phase from
    ``gen`` within ``params``' ranges."""
    n = len(lengths)
    tone = _draw(gen, params["tone_hz"], n, device)
    amp = _draw(gen, params["amp"], n, device)
    sd = _draw(gen, params["noise_sd"], n, device)
    phase = _draw(gen, [0.0, 1.0], n, device)
    out = []
    for L, f, a, s, ph in zip(lengths, tone, amp, sd, phase):
        i = torch.arange(L, device=device, dtype=torch.float64)
        cyc = torch.frac(i * (f / rate))  # the tone's phase in cycles, exact for an hour
        gcyc = torch.frac(i * (params["gate_hz"] / rate) + ph)
        on = torch.sin(2 * math.pi * gcyc) > params["gate_level"]
        x = a * torch.sin(2 * math.pi * cyc) * on
        x = x + s * torch.randn(L, generator=gen, device=device, dtype=torch.float32).double()
        out.append(x.clamp(-32768, 32767).to(torch.int16))
    return out


def echo_streams(B, T, params, gen, device):
    """(B, T) int16 far ends x ~ N(0, far_sd), rounded, and near ends: the
    far end's echo (the taps ``echo``: [delay, gain] pairs) plus
    N(0, noise_sd), and on the last ``talk_share`` of the streams an
    independent N(0, talker_sd) near-end talker (double talk)
    (``chip_smoke.make_aec_streams``: 3000; 0.5, 0.2 at 7, -0.1 at 19; 50;
    a quarter at 2000)."""
    f32 = dict(dtype=torch.float32, device=device)
    x = (params["far_sd"] * torch.randn(B, T, generator=gen, **f32)).clamp(-32768, 32767).round()
    r = torch.zeros(B, T, **f32)
    for k, g in params["echo"]:
        r = r + g * torch.nn.functional.pad(x, (int(k), 0))[:, :T]
    r = r + params["noise_sd"] * torch.randn(B, T, generator=gen, **f32)
    talk = B - int(round(B * (1 - params["talk_share"])))
    if talk:
        r[B - talk:] += params["talker_sd"] * torch.randn(talk, T, generator=gen, **f32)
    return x.to(torch.int16), r.clamp(-32768, 32767).to(torch.int16)
