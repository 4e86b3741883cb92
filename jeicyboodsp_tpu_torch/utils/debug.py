"""Numeric guards for debugging (counterpart of ``jeicyboodsp_tpu/utils/debug.py``).

- :func:`nan_debug` raises ``FloatingPointError``, naming the op, as soon as
  an op inside it outputs a NaN (JAX's ``jax_debug_nans``);
- :func:`checked` wraps a function so that a call raises on a NaN and on an
  inf that appears from finite inputs (what JAX's ``checkify.float_checks``
  reports, division by zero among them);
- :func:`assert_all_finite` checks the floating tensors of a nested output.

The guards are opt-in and cost a host sync per op on the card (each output
is tested, and the test read back), so they are for debugging the fast
paths and new code.  Several compat paths produce *legitimate* NaN: the
reference's own 0/0 gains, and NaN MFCC frames on silence.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _is_float(t):
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


def _floats(tree):
    return [t for t in tree_flatten(tree)[0] if _is_float(t)]


class _NanCheck(TorchDispatchMode):
    """Runs each op, then raises if a floating output holds a NaN (or, with
    ``infs``, an inf while every floating input was finite)."""

    def __init__(self, infs: bool = False):
        super().__init__()
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _floats(out)
        if any(bool(torch.isnan(t).any()) for t in outs):
            raise FloatingPointError(f"NaN in the output of {func}")
        if self.infs and any(bool(torch.isinf(t).any()) for t in outs):
            if all(bool(torch.isfinite(t).all()) for t in _floats((args, kwargs))):
                raise FloatingPointError(f"inf from finite inputs in the output of {func}")
        return out


def nan_debug():
    """A context in which any op that outputs a NaN raises FloatingPointError
    naming the op (``with nan_debug(): ...``)."""
    return _NanCheck()


def checked(fn):
    """``fn`` wrapped so that a call raises FloatingPointError, naming the op,
    on a NaN or on an inf from finite inputs inside it."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with _NanCheck(infs=True):
            return fn(*args, **kw)

    return wrapper


def assert_all_finite(tree, name: str = "output"):
    """Raise FloatingPointError if a floating tensor in ``tree`` (nested dicts,
    lists and tuples) holds a NaN or an inf."""
    for i, leaf in enumerate(tree_flatten(tree)[0]):
        if _is_float(leaf) and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"{name}: non-finite values in leaf {i}")
