"""One chunk of the float64 compat stream in one launch ("K15"): wrapper,
constants, plain version, count.

Replaces no Pallas kernel: the JAX package runs ``enhance_chunk`` as plain
XLA ops.  On the card the same chain as torch ops (``ops.enhance``'s
generic path in f64) is bound by the host, so ``ops.enhance.enhance_chunk``
routes a float64 chunk on a CUDA card here:

- :func:`enhance_chunk64` is the wrapper: on CUDA tensors it launches the
  hand-written kernel of ``csrc/enhance_chunk64.cu`` (counted in
  ``enhance_chunk64.launches``), which computes the output rows, the write
  mask and the whole new state in one launch and reads nothing back to the
  host; on CPU tensors it runs the plain version, the torch-op chain
  ``ops.enhance.enhance_chunk_ops``; anything else raises.
- :func:`constants` gives the kernel's window (``hamming_ref(1024,
  float64)`` on the device, the bits the chain's frames and VAD read there)
  and its twiddle table (:func:`twiddle_table`, built on the host).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import check_mode
from jeicyboodsp_tpu_torch.utils.cnum import hamming_ref

BLOCK = 512
NFFT = 1024
_F64 = torch.float64
# the carried state, the JAX package's layout: key, dtype, shape
STATE = (("cnt", torch.int32, ()), ("avg", _F64, (NFFT,)), ("latched", _F64, (NFFT,)),
         ("prev_block", torch.int16, (BLOCK,)), ("prev_tail", _F64, (BLOCK,)),
         ("t", torch.int32, ()))


def twiddle_table() -> np.ndarray:
    """(1024, 2) float64: W^k = exp(-2 pi i k / 1024) as (re, im), k <
    1024.  The first octant comes from numpy's cos and sin, the rest by the
    circle's symmetries, so W^256 = -i and W^512 = -1 exactly."""
    k = np.arange(NFFT // 8 + 1)
    ang = 2.0 * np.pi * k / NFFT
    c, s = np.cos(ang), np.sin(ang)  # angle in [0, pi/4]
    cq, sq = np.concatenate([c, s[-2::-1]]), np.concatenate([s, c[-2::-1]])  # [0, pi/2]
    ch = np.concatenate([cq, -sq[1:]])  # [0, pi]: cos(pi/2 + a) = -sin(a)
    sh = np.concatenate([sq, cq[1:]])
    cos_full = np.concatenate([ch, -ch[1:-1]])  # [0, 2 pi): cos(pi + a) = -cos(a)
    sin_full = np.concatenate([sh, -sh[1:-1]])
    return np.ascontiguousarray(np.stack([cos_full, -sin_full], 1))


@functools.lru_cache(maxsize=4)
def constants(device: torch.device):
    """(window (1024,) f64, twiddles (1024, 2) f64) on ``device``."""
    return (hamming_ref(NFFT, _F64, device).contiguous(),
            torch.from_numpy(twiddle_table()).to(device))


def enhance_chunk64(state, blocks, mode: str = "wiener"):
    """(Tc, 512) int16 blocks (Tc >= 1) from the carried f64 ``state`` ->
    (out (Tc, 512) int16, write_mask (Tc,) bool, new_state), as
    ``ops.enhance.enhance_chunk`` in float64.

    Every tensor must have its dtype and shape, be contiguous and lie on
    the blocks' device.  The outputs and the new state are views of fresh
    buffers, one an element type."""
    check_mode(mode)
    shape = blocks.shape
    if blocks.dtype != torch.int16 or len(shape) != 2 or shape[1] != BLOCK or not shape[0]:
        raise ValueError(f"blocks must be (Tc, {BLOCK}) torch.int16 with Tc >= 1, "
                         f"got {tuple(shape)} {blocks.dtype}")
    dev = blocks.device
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    for name, dtype, want in STATE:
        x = state[name]
        if x.dtype != dtype or x.shape != want:
            raise ValueError(f"state[{name!r}] must be {want} {dtype}, "
                             f"got {tuple(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"state[{name!r}] is on {x.device}, the blocks on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"state[{name!r}] must be contiguous")
    if not blocks.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"no kernel for device {dev}")
        from jeicyboodsp_tpu_torch.ops.enhance import enhance_chunk_ops

        return enhance_chunk_ops(state, blocks, mode, _F64)
    Tc = shape[0]
    window, tw = constants(dev)
    # a torch call costs the host microseconds: four buffers, their views in three calls
    avg, latched, prev_tail = torch.empty(2 * NFFT + BLOCK, dtype=_F64, device=dev).split(
        (NFFT, NFFT, BLOCK))
    out, prev_block = torch.empty((Tc + 1) * BLOCK, dtype=torch.int16, device=dev).split(
        (Tc * BLOCK, BLOCK))
    cnt, t = torch.empty(2, dtype=torch.int32, device=dev).unbind()
    out = out.view(Tc, BLOCK)
    mask = torch.empty(Tc, dtype=torch.bool, device=dev)
    new = {"cnt": cnt, "avg": avg, "latched": latched, "prev_block": prev_block,
           "prev_tail": prev_tail, "t": t}
    _build.launch("jb_enhance_chunk64", dev, blocks.data_ptr(), Tc, window.data_ptr(),
                  tw.data_ptr(), *(state[k].data_ptr() for k, _, _ in STATE),
                  int(mode == "wiener"), out.data_ptr(), mask.data_ptr(),
                  *(new[k].data_ptr() for k, _, _ in STATE))
    enhance_chunk64.launches += 1
    return out, mask, new


enhance_chunk64.launches = 0
