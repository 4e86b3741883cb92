"""C-numeric emulation in torch (counterpart of ``jeicyboodsp_tpu/utils/cnum.py``).

The reference programs store ``double`` intermediates into ``short``
buffers; MSVC/x86-64 lowers that as ``cvttsd2si`` into 32 bits followed by
a 16-bit move:

    * NaN or |value| too large for int32  ->  0x80000000  ->  low 16 bits = 0
    * otherwise truncate toward zero to int32, keep the low 16 bits

``REF_PI`` is the reference's truncated pi (``#define PI 3.141592``);
``FFT_PI`` the slightly longer pi of the from-scratch FFT program
(``FFTAlgorithm_ver2.cpp:15``).

The kernels apply the same rule on the card (``csrc/cnum.cuh``), checking the
range before they convert: a GPU's double->int conversion saturates instead.
"""

from __future__ import annotations

import torch

REF_PI = 3.141592  # WienerFilter_final.cpp:41
FFT_PI = 3.14159265358  # FFTAlgorithm_ver2.cpp:15

_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


def c_short(x: torch.Tensor) -> torch.Tensor:
    """double/float -> short with MSVC x86-64 semantics; returns int16."""
    t = torch.trunc(x.to(torch.float64))
    in_range = torch.isfinite(t) & (t >= _INT32_MIN) & (t <= _INT32_MAX)
    i32 = torch.where(in_range, t, float(_INT32_MIN)).to(torch.int32)
    return i32.to(torch.int16)  # low 16 bits, two's-complement wrap


def hamming_ref(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The reference's Hamming window 0.54 - 0.46*cos(2*REF_PI*i/(n-1))."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 0.54 - 0.46 * torch.cos(2.0 * REF_PI * i / (n - 1))
