"""NLMS / BNLMS adaptive echo cancellers (counterpart of
``jeicyboodsp_tpu/ops/nlms.py``, with its own copy of the constants of
``jeicyboodsp_tpu/oracle/nlms.py``).

References: ``NormalLMS.cpp`` (per-sample NLMS, 256 taps, mu 1e-4) and
``BNLMS.cpp`` (block NLMS, 128 taps, mu 0.01, double-talk gate), both in
1024-sample blocks whose first block's output is not written.

- :func:`nlms_apply` and :func:`run_nlms_stream` go through K8
  (``kernels.nlms``); :func:`bnlms_apply`, :func:`bnlms_apply_block` and
  :func:`run_bnlms_stream` through the double-talk gate
  (``kernels.bnlms.bnlms_gates``) and K9 (``kernels.bnlms``).  They take
  the JAX ops' ``dtype``: float64 (the default) keeps f64 state and is
  int16-equal to the f64 oracle (K9 by construction, given the same gate);
  float32 (``nlms --fast``, ``bnlms --fast``) runs the kernels' f32
  instances, the JAX ops' f32 arithmetic with exact window energies and the
  exact f64 gate.  Any other dtype raises.
- The state dicts keep the JAX ops' layout (:func:`nlms_init_state`,
  :func:`bnlms_init_state`), with an optional leading batch axis;
  :func:`state_to_port` / :func:`state_to_jax` convert them to and from
  the kernels' tuples, keeping the coefficients' dtype.
- The time-parallel BNLMS (:func:`bnlms_affine_elements`,
  :func:`affine_combine`, :func:`bnlms_apply_timeparallel`): the block
  recursion linearized into per-block affine maps and composed by a
  log-depth scan, in torch ops (plain XLA in the JAX package).

Entry points run on a CUDA card unless the caller passes ``device="cpu"``
(the kernels' plain versions).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels import bnlms as K9
from jeicyboodsp_tpu_torch.kernels import nlms as K8
from jeicyboodsp_tpu_torch.utils.cnum import c_short
from jeicyboodsp_tpu_torch.utils.device import entry_device
from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY
from jeicyboodsp_tpu_torch.utils.scan import associative_scan

BLOCK_LEN = 1024  # oracle/nlms.py:34-43
NLMS_TAPS = 256
NLMS_KEEP = 255
NLMS_MU = 0.0001
NLMS_EPS = 0.0001

BNLMS_TAPS = 128
BNLMS_KEEP = 127
BNLMS_MU = 0.01
BNLMS_EPS = 0.00001

DTYPES = (torch.float64, torch.float32)
VERBOSE_LINE = "rgsdCoefficient[0] %f, rgsdCoefficient[1] %f, rgsdCoefficient[2] %f \n"


def _check_dtype(dtype):
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.float64 or torch.float32, got {dtype}")


def nlms_init_state(dtype=torch.float64):
    _check_dtype(dtype)
    return {"hist": torch.zeros(NLMS_KEEP, dtype=torch.int32),
            "coeff": torch.zeros(NLMS_TAPS, dtype=dtype)}


def bnlms_init_state(dtype=torch.float64):
    _check_dtype(dtype)
    return {"keep_in": torch.zeros(BNLMS_KEEP, dtype=torch.int32),
            "keep_ref": torch.zeros(BNLMS_KEEP, dtype=torch.int32),
            "coeff": torch.zeros(BNLMS_TAPS, dtype=dtype)}


def _as(v, dtype=None, device=None):
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.array(v))
    return t.to(dtype=dtype or t.dtype, device=device)


def state_to_port(state, device=None):
    """A JAX state dict (NLMS: hist, coeff; BNLMS: keep_in, keep_ref, coeff;
    optional leading batch axes) -> the kernels' tuple: NLMS ``(coef,
    hist int16)``, BNLMS ``(coef, keep_in int16, keep_ref int16)``, the
    coefficients in their own dtype."""
    i16 = torch.int16
    if "hist" in state:
        return _as(state["coeff"], None, device), _as(state["hist"], i16, device)
    return (_as(state["coeff"], None, device), _as(state["keep_in"], i16, device),
            _as(state["keep_ref"], i16, device))


def state_to_jax(state):
    """The kernels' state tuple -> the JAX dict (int32 histories, on the CPU)."""
    if len(state) == 2:
        coef, hist = state
        return {"hist": hist.cpu().to(torch.int32), "coeff": coef.cpu()}
    coef, keep_in, keep_ref = state
    return {"keep_in": keep_in.cpu().to(torch.int32), "keep_ref": keep_ref.cpu().to(torch.int32),
            "coeff": coef.cpu()}


def _coef(coef, dtype):
    _check_dtype(dtype)
    if coef.dtype != dtype:
        raise ValueError(f"the state's coefficients are {coef.dtype}, the op's dtype {dtype}")
    return coef


def _streams(x, ref):
    """int (N,) or (B, N) signals -> contiguous (B, N) int16 and the shape."""
    x, ref = torch.as_tensor(x), torch.as_tensor(ref)
    if x.shape != ref.shape:
        raise ValueError(f"x and ref shapes differ: {tuple(x.shape)} vs {tuple(ref.shape)}")
    rows = (int(np.prod(x.shape[:-1])), x.shape[-1])
    return (x.to(torch.int16).reshape(rows).contiguous(),
            ref.to(torch.int16).reshape(rows).contiguous(), x.shape)


def nlms_apply(x, ref, state, dtype=torch.float64, compat: bool = True):
    """Per-sample NLMS over aligned int16 signals x (far end) and ref (near
    end), (N,) or (B, N) -> (est, err int16 of x's shape, new_state), state
    as :func:`nlms_init_state` (with a leading B for (B, N) signals, its
    coefficients in ``dtype``).  Runs on x's device through K8, its f64
    instance or, for ``dtype=float32``, its f32 one.  ``compat=False`` is the
    corrected update pairing (see ``jeicyboodsp_tpu/ops/nlms.py:nlms_apply``).

    While spans are recorded (``utils.metrics``), the call is an
    ``nlms.apply`` span holding ``nlms.state_in`` (copy), ``nlms.kernel``,
    ``nlms.drain`` (wait: K8) and ``nlms.state_out`` (copy)."""
    with REGISTRY.span("nlms.apply"):
        xs, rs, shape = _streams(x, ref)
        with REGISTRY.span("nlms.state_in", "copy"):
            coef, hist = state_to_port(state, xs.device)
        coef = _coef(coef, dtype)
        kernel = K8.nlms if dtype == torch.float64 else K8.nlms_f32
        with REGISTRY.span("nlms.kernel"):
            est, err, new = kernel(xs, rs, (coef.reshape(-1, NLMS_TAPS).contiguous(),
                                            hist.reshape(-1, NLMS_KEEP).contiguous()),
                                   compat=compat)
        lead = shape[:-1]
        REGISTRY.drain("nlms.drain", xs.device)
        with REGISTRY.span("nlms.state_out", "copy"):
            new = state_to_jax((new[0].reshape(*lead, NLMS_TAPS),
                                new[1].reshape(*lead, NLMS_KEEP)))
        return est.reshape(shape), err.reshape(shape), new


def bnlms_apply_block(x, ref, state, dtype=torch.float64):
    """One 1024-sample block of BNLMS (BlockLMSFilter, BNLMS.cpp:103-162):
    x, ref (1024,) or (B, 1024) -> (est, err, new_state); :func:`bnlms_apply`
    of one block."""
    x, ref = torch.as_tensor(x), torch.as_tensor(ref)
    est, err, new = bnlms_apply(x.unsqueeze(-2), ref.unsqueeze(-2), state, dtype=dtype)
    return est.squeeze(-2), err.squeeze(-2), new


def bnlms_apply(x_blocks, ref_blocks, state, dtype=torch.float64):
    """BNLMS over (nb, 1024) or (B, nb, 1024) blocks -> (est, err of the
    blocks' shape, new_state).  The gates of all blocks come first, from
    :func:`~jeicyboodsp_tpu_torch.kernels.bnlms.bnlms_gates` (a float64
    FFT, exact whatever ``dtype``); then one K9 call (its f32 instance for
    ``dtype=float32``) runs every block on x's device."""
    xb, rb = torch.as_tensor(x_blocks), torch.as_tensor(ref_blocks)
    if xb.shape != rb.shape:
        raise ValueError(f"x and ref shapes differ: {tuple(xb.shape)} vs {tuple(rb.shape)}")
    if xb.dim() < 2 or xb.shape[-1] != BLOCK_LEN:
        raise ValueError(f"blocks must be (..., nb, {BLOCK_LEN}), got {tuple(xb.shape)}")
    shape, lead = xb.shape, xb.shape[:-2]
    B = int(np.prod(lead))
    x = xb.to(torch.int16).reshape(B, -1).contiguous()
    ref = rb.to(torch.int16).reshape(B, -1).contiguous()
    coef, keep_in, keep_ref = (v.reshape(B, -1).contiguous()
                               for v in state_to_port(state, x.device))
    coef = _coef(coef, dtype)
    gates = K9.bnlms_gates(x, ref, keep_in, keep_ref)
    kernel = K9.bnlms if dtype == torch.float64 else K9.bnlms_f32
    est, err, (c, k) = kernel(x, ref, gates, (coef, keep_in))
    kr = torch.cat([keep_ref, ref], 1)[:, -BNLMS_KEEP:]
    return (est.reshape(shape), err.reshape(shape),
            state_to_jax((c.reshape(*lead, BNLMS_TAPS), k.reshape(*lead, BNLMS_KEEP),
                          kr.reshape(*lead, BNLMS_KEEP))))


# ---------------------------------------------------------------- time-parallel BNLMS


def _chunk(T: int) -> int:
    """Blocks per chunk of the A/v build: JAX's choice, the largest of 64,
    32, ..., 1 that divides T."""
    return next(c for c in (64, 32, 16, 8, 4, 2, 1) if T % c == 0)


def bnlms_affine_elements(x_blocks, ref_blocks, dtype=torch.float32, keep_in=None,
                          keep_ref=None):
    """Per-block affine maps (A_b, v_b) of the BNLMS coefficient recursion
    (``jeicyboodsp_tpu/ops/nlms.py:bnlms_affine_elements``):

        c_{b+1} = A_b c_b + v_b
        A_b = I - gate_b * (2mu/N) * W_b^T D_b W_b^P
        v_b =     gate_b * (2mu/N) * W_b^T D_b ref_b

    with W_b the block's (1024, 128) input windows, D_b = diag(1 / (E_t +
    eps)) from the exact integer window energies, W^P = W with its columns
    flipped (the reference's mirrored pairing) and gate_b the exact double-
    talk gate of :func:`~jeicyboodsp_tpu_torch.kernels.bnlms.bnlms_gates`,
    called with the halo block prepended as JAX prepends it (its own gate
    dropped).  The int16 truncation of the estimate is left out of the
    recursion, as in JAX.

    x_blocks, ref_blocks: (T, 1024) int16 on one device; ``keep_in`` /
    ``keep_ref``: the full previous blocks (zeros when the stream starts
    here).  A and v are built ``_chunk(T)`` blocks at a time with
    ``torch.matmul`` in ``dtype`` (TF32 is never enabled).  Returns (A (T,
    128, 128), v (T, 128), W (T, 1024, 128), a strided view of the flat
    signal that holds no copy, gates (T,) in ``dtype``)."""
    _check_dtype(dtype)
    T = x_blocks.shape[0]
    dev = x_blocks.device
    pz = torch.zeros(BLOCK_LEN, dtype=torch.int32, device=dev)
    pxb = pz if keep_in is None else torch.as_tensor(keep_in, device=dev).to(torch.int32)
    prb = pz if keep_ref is None else torch.as_tensor(keep_ref, device=dev).to(torch.int32)
    xi, ri = x_blocks.to(torch.int32), ref_blocks.to(torch.int32)
    flat_i = torch.cat([pxb[BLOCK_LEN - BNLMS_KEEP:], xi.reshape(-1)])
    flat = flat_i.to(dtype)
    zk = torch.zeros(1, BNLMS_KEEP, dtype=torch.int16, device=dev)
    gx = torch.cat([pxb[None], xi]).reshape(1, -1).to(torch.int16)
    gr = torch.cat([prb[None], ri]).reshape(1, -1).to(torch.int16)
    gates = K9.bnlms_gates(gx, gr, zk, zk)[0, 1:].to(dtype)
    eta = torch.tensor(2.0 * BNLMS_MU / BLOCK_LEN, dtype=dtype, device=dev)
    eps = torch.tensor(BNLMS_EPS, dtype=dtype, device=dev)
    # exact integer window energies E[t] = sum_k flat[t + k]^2, rounded to dtype once
    sq = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.cumsum(flat_i.to(torch.int64) ** 2, 0)])
    energy = (sq[BNLMS_TAPS:] - sq[:-BNLMS_TAPS]).to(dtype).reshape(T, BLOCK_LEN)
    W = flat.unfold(0, BNLMS_TAPS, 1).reshape(T, BLOCK_LEN, BNLMS_TAPS)
    eye = torch.eye(BNLMS_TAPS, dtype=dtype, device=dev)
    CH = _chunk(T) if T else 1
    A = torch.empty(T, BNLMS_TAPS, BNLMS_TAPS, dtype=dtype, device=dev)
    v = torch.empty(T, BNLMS_TAPS, dtype=dtype, device=dev)
    for s in range(0, T, CH):
        Wc = W[s:s + CH].contiguous()  # (CH, 1024, 128)
        WD = Wc * (1.0 / (energy[s:s + CH] + eps))[:, :, None]
        Mc = torch.matmul(WD.transpose(1, 2), Wc.flip(2))
        g = (eta * gates[s:s + CH])
        A[s:s + CH] = eye - g[:, None, None] * Mc
        v[s:s + CH] = g[:, None] * torch.matmul(WD.transpose(1, 2),
                                                ri[s:s + CH].to(dtype)[:, :, None])[..., 0]
    return A, v, W, gates


def affine_combine(l, r):
    """(A, v) monoid: r AFTER l.  Identity: (I, 0)."""
    Al, vl = l
    Ar, vr = r
    return torch.matmul(Ar, Al), torch.matmul(Ar, vl[..., None])[..., 0] + vr


def bnlms_apply_timeparallel(x_blocks, ref_blocks, dtype=torch.float32):
    """Block-parallel BNLMS over (T, 1024) far/near int16 blocks, O(log T)
    depth: :func:`bnlms_affine_elements`, the inclusive scan of
    :func:`affine_combine` in JAX's grouping
    (:func:`~jeicyboodsp_tpu_torch.utils.scan.associative_scan`; the earlier
    map on the left), c_b the exclusive
    prefix (c_0 = 0), then each block's estimate W_b c_b reversed, chunked
    as the build.  Returns (est, err) int16 (T, 1024), c_short-quantized as
    :func:`bnlms_apply`'s; only the recursion is linearized."""
    T = x_blocks.shape[0]
    if T == 0:
        return torch.empty_like(x_blocks), torch.empty_like(x_blocks)
    A, v, W, _ = bnlms_affine_elements(x_blocks, ref_blocks, dtype=dtype)
    _, v_incl = associative_scan(affine_combine, (A, v))
    c = torch.cat([torch.zeros(1, BNLMS_TAPS, dtype=dtype, device=v.device), v_incl[:-1]])
    return _timeparallel_out(W, c, ref_blocks)


def _timeparallel_out(W, c, ref_blocks):
    """est, err of blocks whose coefficients before each block are ``c``."""
    CH = _chunk(W.shape[0])
    y = torch.cat([torch.matmul(W[s:s + CH].contiguous(), c[s:s + CH].flip(1)[:, :, None])[..., 0]
                   for s in range(0, W.shape[0], CH)])
    y_s = c_short(y)
    e = ref_blocks.to(torch.int32) - y_s.to(torch.int32)
    return y_s, c_short(e.to(c.dtype))


# ---------------------------------------------------------------- streams


def _stream_blocks(x, ref, device):
    """Both signals in 1024-sample blocks, as many as the shorter one starts,
    a partial block keeping the previous block's stale tail (the
    reference's fread; ``oracle/nlms.py:_run``).  Where the longer signal
    goes on past the shorter one's end, its last block holds its own
    samples; the JAX op cuts both signals to the shorter length first
    (ROADMAP R9)."""
    dev = entry_device(device)
    nb = -(-min(len(x), len(ref)) // BLOCK_LEN)
    xb = stale_blocks(x, BLOCK_LEN)[:nb]
    rb = stale_blocks(ref, BLOCK_LEN)[:nb]
    return torch.from_numpy(xb).to(dev), torch.from_numpy(rb).to(dev)


def _written(est, err):
    """Drop the first block, which the reference does not write."""
    return est[BLOCK_LEN:].cpu().numpy(), err[BLOCK_LEN:].cpu().numpy()


def run_nlms_stream(x, ref, dtype=torch.float64, verbose=False, compat=True, device="cuda"):
    """Whole signals in, the reference's est and err streams out (counterpart
    of ``run_nlms_stream``, with its ``dtype``, ``verbose`` and ``compat``;
    one K8 call, no native route).

    ``verbose`` prints the reference's per-block coefficient line
    (``NormalLMS.cpp:128``) after each block, on the f64 compat path only,
    as JAX prints it: K8 runs block by block, the first three coefficients
    after each block are kept in a device tensor and read once at the end,
    so the printed trajectory is K8's, the oracle's bit for bit.  JAX prints
    nothing for float32 or ``compat=False``, and neither does this."""
    xb, rb = _stream_blocks(x, ref, device)
    if verbose and compat and dtype == torch.float64:
        state = (torch.zeros(1, NLMS_TAPS, dtype=dtype, device=xb.device),
                 torch.zeros(1, NLMS_KEEP, dtype=torch.int16, device=xb.device))
        taps = torch.empty(xb.shape[0], 3, dtype=dtype, device=xb.device)
        ests, errs = [], []
        for t in range(xb.shape[0]):
            e1, e2, state = K8.nlms(xb[t:t + 1], rb[t:t + 1], state)
            taps[t] = state[0][0, :3]
            ests.append(e1[0])
            errs.append(e2[0])
        for c in taps.cpu().tolist():
            sys.stdout.write(VERBOSE_LINE % tuple(c))
        est = torch.cat(ests) if ests else xb.reshape(-1)
        err = torch.cat(errs) if errs else rb.reshape(-1)
        return _written(est, err)
    est, err, _ = nlms_apply(xb.reshape(-1), rb.reshape(-1), nlms_init_state(dtype), dtype=dtype,
                             compat=compat)
    return _written(est, err)


def run_bnlms_stream(x, ref, dtype=torch.float64, device="cuda"):
    """Whole signals in, the reference's est and err streams out (counterpart
    of ``run_bnlms_stream``, with its ``dtype``; the gates, then one K9
    call)."""
    xb, rb = _stream_blocks(x, ref, device)
    est, err, _ = bnlms_apply(xb, rb, bnlms_init_state(dtype), dtype=dtype)
    return _written(est.reshape(-1), err.reshape(-1))
