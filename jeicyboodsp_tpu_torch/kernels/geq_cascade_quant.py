"""The 7-band GEQ cascade with int16 feedback ("K6"): wrapper, plain
version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/biquad_pallas.py:
geq_cascade_pallas_quant`` (``_kernel_quant_impl``): the reference's
direct-form-I cascade ``y = short(b2*x2 - a2*y2 + b1*x1 - a1*y1 + b0*x0)``
per band, each band fed the previous band's int16 output
(``7Band_GEQ.cpp:279-300``), bit-exact against ``oracle/geq.py``.  The TPU
kernel computes it in double-single f32; this one in the coefficients'
type, f64 (the reference's arithmetic) or f32 (``jeicyboodsp_tpu/ops/geq.py:
geq_apply``'s default ``dtype``, which JAX computes with XLA ops), with
every operation rounded as written, the seven bands of a stream on seven
lanes of a warp, skewed so that they run side by side (``csrc/biquad.cu``).
Its state is per stream, (B, 7, 4) int16 = x1, x2, y1, y2 of each band, so
any B works and no batch tile shapes it (ROADMAP R2, R3).

- :func:`geq_cascade_quant` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/biquad.cu`` (counted in
  ``geq_cascade_quant.launches``); on a CPU tensor it runs the plain
  version; anything else raises.
- :func:`geq_cascade_quant_plain` is the plain PyTorch version: a loop over
  samples of separate torch ops in the coefficients' type, in the kernel's
  order.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check, check_2d
from jeicyboodsp_tpu_torch.utils.cnum import c_short

BANDS = 7
DTYPES = {torch.float64: "jb_geq_cascade_quant", torch.float32: "jb_geq_cascade_quant_f32"}


def init_state(B: int, device=None) -> torch.Tensor:
    """Zero carried state for ``B`` streams: (B, 7, 4) int16."""
    return torch.zeros(B, BANDS, 4, dtype=torch.int16, device=device)


def geq_cascade_quant_plain(x, coef, state):
    """Plain PyTorch version of :func:`geq_cascade_quant` (any device), in
    ``coef``'s type: each product and sum is one torch op of that type, so
    it is rounded once, as the kernel rounds it."""
    B, T = x.shape
    c = coef.tolist()  # the values of coef's type, exact as Python floats
    s = state.to(coef.dtype)
    x1, x2, y1, y2 = ([s[:, k, i] for k in range(BANDS)] for i in range(4))
    xf = x.to(coef.dtype)
    out = []
    for n in range(T):
        v = xf[:, n]
        for k in range(BANDS):
            b0, b1, b2, a1, a2 = c[k]
            acc = b2 * x2[k]
            acc = acc - a2 * y2[k]
            acc = acc + b1 * x1[k]
            acc = acc - a1 * y1[k]
            acc = acc + b0 * v
            y = c_short(acc).to(coef.dtype)  # the short the reference feeds back
            x2[k], x1[k], y2[k], y1[k] = x1[k], v, y1[k], y
            v = y
        out.append(v)
    y = torch.stack(out, 1).to(torch.int16) if T else torch.empty_like(x)
    new = torch.stack([torch.stack([x1[k], x2[k], y1[k], y2[k]], 1) for k in range(BANDS)], 1)
    return y, new.to(torch.int16)


def geq_cascade_quant(x, coef, state=None):
    """(B, T) int16 streams -> (y (B, T) int16, state (B, 7, 4) int16).

    coef: (7, 5) ``[b0 b1 b2 a1 a2]`` in f64 or f32, the type the cascade
    runs in (``kernels.geq_cascade.pack_coefficients(b, a, dtype)``); state:
    from an earlier call, or None for fresh streams.  CUDA tensors launch
    ``jb_geq_cascade_quant`` (f64) or ``jb_geq_cascade_quant_f32``; CPU
    tensors run :func:`geq_cascade_quant_plain`.
    """
    B, T = check_2d(x, "x")
    if state is None:
        state = init_state(B, x.device)
    if coef.dtype not in DTYPES:
        raise ValueError(f"coef must be float64 or float32, got {coef.dtype}")
    dev = check({"x": (x, torch.int16, (B, T)), "coef": (coef, coef.dtype, (BANDS, 5)),
                 "state": (state, torch.int16, (B, BANDS, 4))})
    if dev.type == "cpu":
        return geq_cascade_quant_plain(x, coef, state)
    if B * T == 0:
        return torch.empty_like(x), state.clone()
    y, new = torch.empty_like(x), torch.empty_like(state)
    _build.launch(DTYPES[coef.dtype], dev, x.data_ptr(), coef.data_ptr(), state.data_ptr(),
                  y.data_ptr(), new.data_ptr(), B, T)
    geq_cascade_quant.launches += 1
    return y, new


geq_cascade_quant.launches = 0
