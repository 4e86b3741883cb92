"""NLMS / BNLMS adaptive echo cancellers (counterpart of
``jeicyboodsp_tpu/ops/nlms.py``, with its own copy of the constants of
``jeicyboodsp_tpu/oracle/nlms.py``).

References: ``NormalLMS.cpp`` (per-sample NLMS, 256 taps, mu 1e-4) and
``BNLMS.cpp`` (block NLMS, 128 taps, mu 0.01, double-talk gate), both in
1024-sample blocks whose first block's output is not written.

- :func:`nlms_apply` and :func:`run_nlms_stream` go through K8
  (``kernels.nlms``); :func:`bnlms_apply`, :func:`bnlms_apply_block` and
  :func:`run_bnlms_stream` through the double-talk gate
  (``kernels.bnlms.bnlms_gates``) and K9 (``kernels.bnlms``).  Both kernels
  keep f64 state and are int16-equal to the f64 oracle (K9 by construction,
  given the same gate).  Only float64 is ported: the ops take no dtype.
- The state dicts keep the JAX ops' layout (:func:`nlms_init_state`,
  :func:`bnlms_init_state`), with an optional leading batch axis;
  :func:`state_to_port` / :func:`state_to_jax` convert them to and from
  the kernels' tuples.

Entry points run on a CUDA card unless the caller passes ``device="cpu"``
(the kernels' plain versions).  Not ported yet: the time-parallel BNLMS
(``bnlms_affine_elements``, ``bnlms_apply_timeparallel``,
``affine_combine``) and the NLMS ``--verbose`` coefficient prints.
"""

from __future__ import annotations

import numpy as np
import torch

from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels import bnlms as K9
from jeicyboodsp_tpu_torch.kernels import nlms as K8
from jeicyboodsp_tpu_torch.utils.device import entry_device

BLOCK_LEN = 1024  # oracle/nlms.py:34-43
NLMS_TAPS = 256
NLMS_KEEP = 255
NLMS_MU = 0.0001
NLMS_EPS = 0.0001

BNLMS_TAPS = 128
BNLMS_KEEP = 127
BNLMS_MU = 0.01
BNLMS_EPS = 0.00001


def nlms_init_state():
    return {"hist": torch.zeros(NLMS_KEEP, dtype=torch.int32),
            "coeff": torch.zeros(NLMS_TAPS, dtype=torch.float64)}


def bnlms_init_state():
    return {"keep_in": torch.zeros(BNLMS_KEEP, dtype=torch.int32),
            "keep_ref": torch.zeros(BNLMS_KEEP, dtype=torch.int32),
            "coeff": torch.zeros(BNLMS_TAPS, dtype=torch.float64)}


def _as(v, dtype, device=None):
    return torch.as_tensor(np.array(v)).to(dtype=dtype, device=device)


def state_to_port(state, device=None):
    """A JAX state dict (NLMS: hist, coeff; BNLMS: keep_in, keep_ref, coeff;
    optional leading batch axes) -> the kernels' tuple: NLMS ``(coef f64,
    hist int16)``, BNLMS ``(coef f64, keep_in int16, keep_ref int16)``."""
    i16, f64 = torch.int16, torch.float64
    if "hist" in state:
        return _as(state["coeff"], f64, device), _as(state["hist"], i16, device)
    return (_as(state["coeff"], f64, device), _as(state["keep_in"], i16, device),
            _as(state["keep_ref"], i16, device))


def state_to_jax(state):
    """The kernels' state tuple -> the JAX dict (int32 histories, on the CPU)."""
    if len(state) == 2:
        coef, hist = state
        return {"hist": hist.cpu().to(torch.int32), "coeff": coef.cpu()}
    coef, keep_in, keep_ref = state
    return {"keep_in": keep_in.cpu().to(torch.int32), "keep_ref": keep_ref.cpu().to(torch.int32),
            "coeff": coef.cpu()}


def _streams(x, ref):
    """int (N,) or (B, N) signals -> contiguous (B, N) int16 and the shape."""
    x, ref = torch.as_tensor(x), torch.as_tensor(ref)
    if x.shape != ref.shape:
        raise ValueError(f"x and ref shapes differ: {tuple(x.shape)} vs {tuple(ref.shape)}")
    rows = (int(np.prod(x.shape[:-1])), x.shape[-1])
    return (x.to(torch.int16).reshape(rows).contiguous(),
            ref.to(torch.int16).reshape(rows).contiguous(), x.shape)


def nlms_apply(x, ref, state, compat: bool = True):
    """Per-sample NLMS over aligned int16 signals x (far end) and ref (near
    end), (N,) or (B, N) -> (est, err int16 of x's shape, new_state), state
    as :func:`nlms_init_state` (with a leading B for (B, N) signals).  Runs
    on x's device through K8.  ``compat=False`` is the corrected update
    pairing (see ``jeicyboodsp_tpu/ops/nlms.py:nlms_apply``)."""
    xs, rs, shape = _streams(x, ref)
    coef, hist = state_to_port(state, xs.device)
    est, err, new = K8.nlms(xs, rs, (coef.reshape(-1, NLMS_TAPS).contiguous(),
                                     hist.reshape(-1, NLMS_KEEP).contiguous()), compat=compat)
    lead = shape[:-1]
    return (est.reshape(shape), err.reshape(shape),
            state_to_jax((new[0].reshape(*lead, NLMS_TAPS), new[1].reshape(*lead, NLMS_KEEP))))


def bnlms_apply_block(x, ref, state):
    """One 1024-sample block of BNLMS (BlockLMSFilter, BNLMS.cpp:103-162):
    x, ref (1024,) or (B, 1024) -> (est, err, new_state); :func:`bnlms_apply`
    of one block."""
    x, ref = torch.as_tensor(x), torch.as_tensor(ref)
    est, err, new = bnlms_apply(x.unsqueeze(-2), ref.unsqueeze(-2), state)
    return est.squeeze(-2), err.squeeze(-2), new


def bnlms_apply(x_blocks, ref_blocks, state):
    """BNLMS over (nb, 1024) or (B, nb, 1024) blocks -> (est, err of the
    blocks' shape, new_state).  The gates of all blocks come first, from
    :func:`~jeicyboodsp_tpu_torch.kernels.bnlms.bnlms_gates` (a float64
    FFT); then one K9 call runs every block on x's device."""
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
    gates = K9.bnlms_gates(x, ref, keep_in, keep_ref)
    est, err, (c, k) = K9.bnlms(x, ref, gates, (coef, keep_in))
    kr = torch.cat([keep_ref, ref], 1)[:, -BNLMS_KEEP:]
    return (est.reshape(shape), err.reshape(shape),
            state_to_jax((c.reshape(*lead, BNLMS_TAPS), k.reshape(*lead, BNLMS_KEEP),
                          kr.reshape(*lead, BNLMS_KEEP))))


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


def run_nlms_stream(x, ref, compat=True, device="cuda"):
    """Whole signals in, the reference's est and err streams out (counterpart
    of ``run_nlms_stream``; one K8 call, no native route)."""
    xb, rb = _stream_blocks(x, ref, device)
    est, err, _ = nlms_apply(xb.reshape(-1), rb.reshape(-1), nlms_init_state(), compat=compat)
    return _written(est, err)


def run_bnlms_stream(x, ref, device="cuda"):
    """Whole signals in, the reference's est and err streams out (counterpart
    of ``run_bnlms_stream``; the gates, then one K9 call)."""
    xb, rb = _stream_blocks(x, ref, device)
    est, err, _ = bnlms_apply(xb, rb, bnlms_init_state())
    return _written(est.reshape(-1), err.reshape(-1))
