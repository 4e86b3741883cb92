"""The C numerics the references share (a frozen copy): the reference
programs' truncated pi and their ``double -> short`` store."""

from __future__ import annotations

import numpy as np

REF_PI = 3.141592  # WienerFilter_final.cpp:41 (#define PI)


def c_short(v):
    """The reference's double -> short store of an array (cvttsd2si into 32
    bits, the low 16 bits kept): NaN or a value out of int32 range stores 0."""
    t = np.trunc(np.asarray(v, np.float64))
    ok = np.isfinite(t) & (t >= -(2 ** 31)) & (t <= 2 ** 31 - 1)
    return np.where(ok, t, -(2.0 ** 31)).astype(np.int64).astype(np.int32).astype(np.int16)


def c_short_int(v):
    """The reference's double -> short store of one value (see c_short)."""
    if not -2147483649.0 < v < 2147483648.0:  # out of int32 range, or NaN
        return 0
    t = int(v) & 0xFFFF
    return t - 0x10000 if t >= 0x8000 else t


def c_short_torch(v):
    """:func:`c_short` of a torch tensor, on its device."""
    import torch

    t = torch.trunc(v.to(torch.float64))
    ok = torch.isfinite(t) & (t >= -(2 ** 31)) & (t <= 2 ** 31 - 1)
    return torch.where(ok, t, -(2.0 ** 31)).to(torch.int64).to(torch.int32).to(torch.int16)


def hamming():
    """The reference's 1024-point Hamming window, 0.54 - 0.46 cos(2 PI i / 1023)."""
    return 0.54 - 0.46 * np.cos(2.0 * REF_PI * np.arange(1024) / 1023)
