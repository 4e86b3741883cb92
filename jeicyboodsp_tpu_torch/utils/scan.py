"""The associative scan in torch (counterpart of ``jax.lax.associative_scan``).

Torch has none.  :func:`associative_scan` follows JAX's algorithm step for
step -- combine adjacent pairs, scan the pairs recursively, combine the
odd results with the even elements, interleave -- so every element is
grouped as JAX groups it and the work is about 2N combines.  The earlier
operand of ``combine`` is always the left one.
"""

from __future__ import annotations

import torch


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along dim 0 (len(a) == len(b) or len(b) + 1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(combine, elems):
    """Inclusive scan of ``combine`` along dim 0 of every tensor of the tuple
    ``elems``; ``combine(l, r)`` takes and returns tuples of tensors batched
    along dim 0, ``l`` the earlier."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))
