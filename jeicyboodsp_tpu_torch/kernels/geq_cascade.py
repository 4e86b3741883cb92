"""The linear 7-band GEQ cascade ("K7"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/biquad_pallas.py:
geq_cascade_pallas`` (``_make_kernel``): the fast engine, a linear f32
transposed-direct-form-II cascade with no int16 feedback, per band and
sample in the TPU kernel's op order

    y = c0*v + s0;  s0 = c1*v - c3*y + s1;  s1 = c2*v - c4*y;  v = y

from zero state.  By design it does not match the reference, whose
feedback is quantized.  The TPU kernel's ``quant_boundaries=True`` variant
measured negative there and is not ported.

- :func:`geq_cascade` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/biquad.cu`` (counted in
  ``geq_cascade.launches``); on a CPU tensor it runs the plain version;
  anything else raises.
- :func:`geq_cascade_plain` is the plain PyTorch version: a loop over
  samples of separate f32 torch ops in the same order, bit-equal to the
  kernel (built with ``-fmad=false``).
"""

from __future__ import annotations

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check, check_2d

BANDS = 7


def pack_coefficients(b, a, dtype=np.float32):
    """(7, 3) b + (7, 3) a (a[:, 0] = 0) -> (7, 5) ``[b0 b1 b2 a1 a2]``
    (``biquad_pallas.py:156``; K6 takes it in float64)."""
    b = np.asarray(b, dtype)
    a = np.asarray(a, dtype)
    return np.concatenate([b, a[:, 1:3]], axis=1)


def geq_cascade_plain(x, coef):
    """Plain PyTorch version of :func:`geq_cascade` (any device)."""
    B, T = x.shape
    c = coef.tolist()
    s0 = [torch.zeros(B, dtype=torch.float32, device=x.device) for _ in range(BANDS)]
    s1 = list(s0)
    out = []
    for n in range(T):
        v = x[:, n]
        for k in range(BANDS):
            c0, c1, c2, c3, c4 = c[k]
            y = c0 * v + s0[k]
            s0[k] = (c1 * v - c3 * y) + s1[k]
            s1[k] = c2 * v - c4 * y
            v = y
        out.append(v)
    return torch.stack(out, 1) if T else torch.empty_like(x)


def geq_cascade(x, coef):
    """(B, T) f32 streams -> (B, T) f32, each through the linear cascade
    from zero state.  coef: (7, 5) f32 from :func:`pack_coefficients`.
    CUDA tensors launch ``jb_geq_cascade``; CPU tensors run
    :func:`geq_cascade_plain`."""
    B, T = check_2d(x, "x")
    dev = check({"x": (x, torch.float32, (B, T)), "coef": (coef, torch.float32, (BANDS, 5))})
    if dev.type == "cpu":
        return geq_cascade_plain(x, coef)
    y = torch.empty_like(x)
    if B * T == 0:
        return y
    _build.launch("jb_geq_cascade", dev, x.data_ptr(), coef.data_ptr(), y.data_ptr(), B, T)
    geq_cascade.launches += 1
    return y


geq_cascade.launches = 0
