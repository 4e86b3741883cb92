"""The 7-band graphic EQ (counterpart of ``jeicyboodsp_tpu/ops/geq.py``, with
its own copy of the constants and coefficient math of
``jeicyboodsp_tpu/oracle/geq.py``).

Reference: ``7Band_GEQ.cpp``.  48 kHz int16 in 512-sample blocks through
seven biquads; the direct-form-I output is stored into a ``short`` inside
the recursion (``:284``), so the feedback runs on int16 values and every
band's input is the previous band's int16 output.

- The reference's semantics: :func:`geq_apply` (streaming, the JAX state
  dict) and :func:`run_quant` (a whole signal; the pipeline's route) go
  through K6 (``kernels.geq_cascade_quant``) in the ``dtype`` they are
  given, with JAX's defaults: ``geq_apply`` float32, ``run_quant`` (JAX's
  ``stream_blocks``) float64.  float64 is bit-exact against the reference;
  float32 (``geq --fast``) rounds every op as JAX's f32 ``geq_apply`` does
  and equals it bit for bit, but it is not the reference's output: the
  int16 feedback wraps differently under f32 rounding.
- The fast engine: the cascade without the in-loop quantization, by design
  not the reference's output.  Batches of streams go through K7
  (``kernels.geq_cascade.geq_cascade``, in f32), which callers use directly,
  as the JAX package's benchmark uses ``geq_cascade_pallas``.
  :func:`geq_apply_fast` is the JAX op of that name: the same linear cascade
  written as a per-band affine 2x2 state-space scan (:func:`_biquad_linear`,
  torch ops, plain XLA in JAX), the form ``parallel.sharded.geq_sharded``
  shards over time.  Its float32 form overflows at the 44 Hz shelf's
  near-unity pole on long signals, as JAX's does.

Entry points run on a CUDA card unless the caller passes ``device="cpu"``
(the kernels' plain versions).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels.geq_cascade import pack_coefficients
from jeicyboodsp_tpu_torch.kernels.geq_cascade_quant import geq_cascade_quant
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI
from jeicyboodsp_tpu_torch.utils.device import entry_device
from jeicyboodsp_tpu_torch.utils.scan import associative_scan

SAMPLING_RATE = 48000.0  # 7Band_GEQ.cpp:33
TOTAL_BANDS = 7
BLOCK_LEN = 512  # 7Band_GEQ.cpp:43
Q = 4.318  # 7Band_GEQ.cpp:45
ROOT2 = 1.0 / Q  # 7Band_GEQ.cpp:59
CENTER_FREQS = (44.0, 125.0, 250.0, 500.0, 2000.0, 6000.0, 11313.0)  # :47
GAINS_DB = (12.0, 12.0, 0.0, 0.0, 3.0, 0.0, -12.0)  # 7Band_GEQ.cpp:51-57


def calc_coefficients(
    gains_db=GAINS_DB, center_freqs=CENTER_FREQS, fs=SAMPLING_RATE, compat: bool = True
):
    """Return (b, a) arrays of shape (7, 3), a[:,0] == 0 as in the reference.

    ``compat=True`` reproduces the reference's coefficient quirks
    (``K_band[k-1]`` in peak a2; V-vs-K mixups in the bass-cut branch);
    ``compat=False`` computes the textbook formulas.
    """
    K = [math.tan(REF_PI * f / fs) for f in center_freqs]
    # 7Band_GEQ.cpp:139-142 -- invert gain if a cut, so V >= 1 always
    V = [10.0 ** (g / 20.0) for g in gains_db]
    V = [1.0 / v if v < 1 else v for v in V]
    G = list(gains_db)
    r = ROOT2

    b = np.zeros((TOTAL_BANDS, 3), dtype=np.float64)
    a = np.zeros((TOTAL_BANDS, 3), dtype=np.float64)

    # --- band 0: bass shelf (7Band_GEQ.cpp:144-175)
    k0, v0 = K[0], V[0]
    if G[0] > 0:  # booster, :144-159
        d = 1 + r * k0 + k0 ** 2
        b[0] = [
            (1 + math.sqrt(v0) * r * k0 + v0 * k0 ** 2) / d,
            (2 * (v0 * k0 ** 2 - 1)) / d,
            (1 - math.sqrt(v0) * r * k0 + v0 * k0 ** 2) / d,
        ]
        a[0] = [0.0, (2 * (k0 ** 2 - 1)) / d, (1 - r * k0 + k0 ** 2) / d]
    else:  # cut, :160-175 (reference has V/K mixups in a1/a2 -- compat quirk)
        d = 1 + r * math.sqrt(v0) * k0 + v0 * k0 ** 2
        b[0] = [
            (1 + r * k0 + k0 ** 2) / d,
            (2 * (k0 ** 2 - 1)) / d,
            (1 - r * k0 + k0 ** 2) / d,
        ]
        if compat:
            # 7Band_GEQ.cpp:173-174: uses K_band[0] where V_band[0] belongs
            a[0] = [
                0.0,
                (2 * (k0 * k0 ** 2 - 1)) / d,
                (1 - r * math.sqrt(k0) * k0 + k0 * k0 ** 2) / d,
            ]
        else:
            a[0] = [
                0.0,
                (2 * (v0 * k0 ** 2 - 1)) / d,
                (1 - r * math.sqrt(v0) * k0 + v0 * k0 ** 2) / d,
            ]

    # --- band 6: treble shelf (7Band_GEQ.cpp:177-210)
    k6, v6 = K[6], V[6]
    if G[6] > 0:  # booster, :177-192
        d = 1 + r * k6 + k6 ** 2
        b[6] = [
            (v6 + r * math.sqrt(v6) * k6 + k6 ** 2) / d,
            (2 * (k6 ** 2 - v6)) / d,
            (v6 - r * math.sqrt(v6) * k6 + k6 ** 2) / d,
        ]
        a[6] = [0.0, (2 * (k6 ** 2 - 1)) / d, (1 - r * k6 + k6 ** 2) / d]
    else:  # cut, :193-210
        d = v6 + r * math.sqrt(v6) * k6 + k6 ** 2
        b[6] = [
            (1 + r * k6 + k6 ** 2) / d,
            (2 * (k6 ** 2 - 1)) / d,
            (1 - r * k6 + k6 ** 2) / d,
        ]
        d2 = 1 + r / math.sqrt(v6) * k6 + (k6 ** 2) / v6
        a[6] = [
            0.0,
            (2 * ((k6 ** 2) / v6 - 1)) / d2,
            (1 - r / math.sqrt(v6) * k6 + (k6 ** 2) / v6) / d2,
        ]

    # --- bands 1..5: peak/notch (7Band_GEQ.cpp:212-249)
    for kk in range(1, 6):
        kb, vb = K[kk], V[kk]
        ka2 = K[kk - 1] if compat else kb  # quirk: 7Band_GEQ.cpp:231,247
        if G[kk] > 0:  # boost peak, :217-232
            d = 1 + (1 / Q) * kb + kb ** 2
            b[kk] = [
                (1 + (vb / Q) * kb + kb ** 2) / d,
                (2 * (kb ** 2 - 1)) / d,
                (1 - (vb / Q) * kb + kb ** 2) / d,
            ]
            a[kk] = [0.0, b[kk][1], (1 - (1 / Q) * ka2 + kb ** 2) / d]
        else:  # cut peak, :233-248
            d = 1 + (vb / Q) * kb + kb ** 2
            b[kk] = [
                (1 + (1.0 / Q) * kb + kb ** 2) / d,
                (2 * (kb ** 2 - 1)) / d,
                (1 - (1.0 / Q) * kb + kb ** 2) / d,
            ]
            a[kk] = [0.0, b[kk][1], (1 - (vb / Q) * ka2 + kb ** 2) / d]

    return b, a


def geq_coefficients(gains_db=GAINS_DB, center_freqs=CENTER_FREQS, compat=True):
    b, a = calc_coefficients(gains_db=gains_db, center_freqs=center_freqs, compat=compat)
    return np.asarray(b), np.asarray(a)


def init_state():
    """Per-band int16 keep buffers as the JAX op keeps them: x history (2,)
    and per-band y history (7, 2), oldest first, int32."""
    return {"xh": torch.zeros(2, dtype=torch.int32),
            "yh": torch.zeros(TOTAL_BANDS, 2, dtype=torch.int32)}


def state_to_port(state) -> torch.Tensor:
    """JAX state dict ``{"xh": (..., 2), "yh": (..., 7, 2)}`` -> the kernel's
    (..., 7, 4) int16 state [x1, x2, y1, y2] per band.  Band k > 0 takes
    band k-1's output history as its input history."""
    xh = torch.as_tensor(np.array(state["xh"])).to(torch.int16)
    yh = torch.as_tensor(np.array(state["yh"])).to(torch.int16)
    xin = torch.cat([xh.unsqueeze(-2), yh[..., :-1, :]], -2)  # (..., 7, 2) input histories
    return torch.stack([xin[..., 1], xin[..., 0], yh[..., 1], yh[..., 0]], -1)


def state_to_jax(state: torch.Tensor):
    """The kernel's (..., 7, 4) state -> the JAX dict (int32, on the CPU)."""
    s = state.cpu().to(torch.int32)
    return {"xh": torch.stack([s[..., 0, 1], s[..., 0, 0]], -1),
            "yh": torch.stack([s[..., 3], s[..., 2]], -1)}


def _coef(b, a, dtype, device):
    """(7, 5) K6 coefficients in ``dtype`` (float64 or float32; cast as
    ``jnp.asarray(b, dtype)`` casts them)."""
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}.get(dtype)
    if np_dtype is None:
        raise ValueError(f"dtype must be torch.float64 or torch.float32, got {dtype}")
    return torch.from_numpy(pack_coefficients(b, a, np_dtype)).to(device)


def geq_apply(x, b, a, state, dtype=torch.float32):
    """Compat-mode cascade (the JAX op, with its ``dtype`` and default).
    x: int16-valued (N,) or (B, N) tensor -> (y int16 of x's shape,
    new_state), state as :func:`init_state` (with a leading B for a (B, N)
    x).  Runs on x's device through K6 in ``dtype``: float64 is the
    reference's arithmetic, float32 JAX's default."""
    coef = _coef(b, a, dtype, x.device)
    s = state_to_port(state).to(x.device)
    xs = x.to(torch.int16).reshape(-1, x.shape[-1]).contiguous()
    y, new = geq_cascade_quant(xs, coef, s.reshape(-1, TOTAL_BANDS, 4).contiguous())
    return y.reshape(x.shape), state_to_jax(new.reshape(s.shape))


def run_quant(x, gains_db=GAINS_DB, compat=True, device="cuda", dtype=torch.float64):
    """Whole-signal compat GEQ through K6 (counterpart of
    ``run_pallas_quant`` and ``stream_blocks``, with the latter's ``dtype``
    and default): in float64 it equals ``oracle.geq.run()`` byte for byte,
    in float32 (``geq --fast``) JAX's ``stream_blocks(dtype=float32)``.
    The output length is rounded up to a 512 multiple with the reference's
    stale-tail semantics; an empty payload gives 0 samples.  The kernel
    carries each band's keep buffers along the signal, so one call is the
    block-by-block stream."""
    dev = entry_device(device)
    if len(x) == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)
    b, a = geq_coefficients(gains_db=gains_db, compat=compat)
    coef = _coef(b, a, dtype, dev)
    xx = torch.from_numpy(stale_blocks(x, BLOCK_LEN).reshape(1, -1)).to(dev)
    y, _ = geq_cascade_quant(xx, coef)
    return y[0].cpu().numpy()



# ---------------------------------------------------------------- fast path: the linear scan


def state_space_combine(l, r):
    """The affine 2x2 state-space monoid, r after l: (A, b) -> (Ar Al, Ar bl
    + br).  A (n, 2, 2), shared by the batch; b (n, B, 2).  Each entry is
    written out as two products and their sum, each rounded once (a BLAS
    call may fuse them), in the order of the dot's index."""
    Al, bl = l
    Ar, br = r

    def dot2(r0, r1, c0, c1):
        return r0 * c0 + r1 * c1

    A = torch.stack([torch.stack([dot2(Ar[:, i, 0], Ar[:, i, 1], Al[:, 0, k], Al[:, 1, k])
                                  for k in range(2)], -1) for i in range(2)], -2)
    b = torch.stack([dot2(Ar[:, i, 0, None], Ar[:, i, 1, None], bl[..., 0], bl[..., 1]) + br[..., i]
                     for i in range(2)], -1)
    return A, b


def biquad_fir(x, x1, x2, b0, b1, b2):
    """The biquad's FIR part b0 x[n] + b1 x[n-1] + b2 x[n-2], JAX's order."""
    return b0 * x + b1 * x1 + b2 * x2


def biquad_elements(f, a1, a2):
    """The scan's elements of one band for FIR terms f (n, B): A = [[-a1,
    -a2], [1, 0]] for every sample, b = (f, 0)."""
    A = torch.stack([torch.stack([-a1, -a2]), torch.stack([torch.ones_like(a1),
                                                           torch.zeros_like(a1)])])
    return A.expand(f.shape[0], 2, 2), torch.stack([f, torch.zeros_like(f)], -1)


def _biquad_linear(x, b0, b1, b2, a1, a2):
    """One biquad as an associative scan over 2x2 state-space transitions
    (``jeicyboodsp_tpu/ops/geq.py:_biquad_linear``): s[n] = (y[n], y[n-1])
    = A s[n-1] + (f[n], 0), A = [[-a1, -a2], [1, 0]], f the FIR part, the
    samples before the first zero.  x: (..., N) float; returns y of x's
    shape.  The coefficients are 0-d tensors of x's dtype."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1]).t()  # (N, B): time first
    zero = torch.zeros_like(xt[:1])
    x1 = torch.cat([zero, xt[:-1]])
    x2 = torch.cat([zero, zero, xt[:-2]])[: xt.shape[0]]
    f = biquad_fir(xt, x1, x2, b0, b1, b2)
    _, s = associative_scan(state_space_combine, biquad_elements(f, a1, a2))
    return s[..., 0].t().reshape(shape)


def geq_apply_fast(x, b, a, dtype=torch.float32):
    """Fast-mode cascade: float linear filtering, no int16 feedback.
    x: (..., N) float or int tensor -> (..., N) in ``dtype`` (JAX's float32
    default), on x's device."""
    y = x.to(dtype)
    b = torch.as_tensor(np.asarray(b), device=x.device).to(dtype)
    a = torch.as_tensor(np.asarray(a), device=x.device).to(dtype)
    for k in range(TOTAL_BANDS):
        y = _biquad_linear(y, b[k, 0], b[k, 1], b[k, 2], a[k, 1], a[k, 2])
    return y
