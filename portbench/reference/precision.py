"""Rounding of a stage's values to a lower precision, in NumPy and torch.

``None`` (or ``"float64"``) leaves values as they are, so the references
stay their float64 selves; ``"float32"`` and ``"bfloat16"`` round each
stage's values to nearest even in that type (the values stay float64
arrays), which makes the same code the control of a lower precision."""

from __future__ import annotations

import numpy as np

NAMES = (None, "float64", "float32", "bfloat16")


def _bf16(a):
    f = np.ascontiguousarray(a, np.float32)
    b = f.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    out = b.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(f), out, f).astype(np.float64)


def rounder(precision):
    """A function that rounds a NumPy array (real or complex) to ``precision``."""
    if precision not in NAMES:
        raise ValueError(f"precision must be one of {NAMES}, got {precision!r}")
    if precision in (None, "float64"):
        return lambda a: a
    real = _bf16 if precision == "bfloat16" else (
        lambda a: np.asarray(a, np.float32).astype(np.float64))

    def q(a):
        a = np.asarray(a)
        if np.iscomplexobj(a):
            return real(a.real) + 1j * real(a.imag)
        return real(a)
    return q


def rounder_torch(precision):
    """A function that rounds a torch tensor (real or complex) to ``precision``."""
    import torch

    if precision not in NAMES:
        raise ValueError(f"precision must be one of {NAMES}, got {precision!r}")
    if precision in (None, "float64"):
        return lambda t: t
    low = torch.bfloat16 if precision == "bfloat16" else torch.float32

    def real(t):
        return t.to(low).to(torch.float64)

    def q(t):
        if t.is_complex():
            return torch.complex(real(t.real), real(t.imag))
        return real(t)
    return q
