"""The forward half of engine mxu3 ("K4"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_fwd_pallas`` (``_fwd_kernel``): (T, 512) int16 blocks -> re, im,
|X| (T, 512) and re_n, |X_n|, speech flags (T, 1), the outputs of K2, from
the f32 window-folded bases: re = [prev, cur] @ WC, im = [prev, cur] @ WS
(K = 1024), the Nyquist bin as an f32 dot and the in-kernel VAD.  The TPU
kernel runs its GEMMs as bf16x3 only because Mosaic has no
``Precision.HIGH``; these are f32 GEMMs.  The prev row is input row t-1
(zeros for t = 0), read by the kernel itself.

- :func:`enhance_fwd` is the wrapper: on a CUDA tensor it launches the
  hand-written kernels of ``csrc/enhance_mxu3.cu`` (counted in
  ``enhance_fwd.launches``); on a CPU tensor it runs the plain version;
  anything else raises.
- :func:`enhance_fwd_plain` is the plain PyTorch version: f32 matmuls and
  K2's epilogue :func:`~jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8.
  forward_outputs`.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N
from jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8 import (
    check_blocks,
    empty_forward_outputs,
    forward_outputs,
)

CONSTS = ("WC", "WS", "nyq", "w2")


def frames_f32(blocks):
    """(T, 512) int16 -> the (T, 1024) f32 frames [x[t-1], x[t]]."""
    cur = blocks.to(torch.float32)
    prev = torch.cat([torch.zeros_like(cur[:1]), cur[:-1]])
    return torch.cat([prev, cur], 1)


def enhance_fwd_plain(blocks, C):
    """Plain PyTorch version of :func:`enhance_fwd` (any device)."""
    frames = frames_f32(blocks)
    re = frames @ C["WC"]
    im = frames @ C["WS"]
    nyq = C["nyq"]
    ren = frames[:, :N] @ nyq[:N] + frames[:, N:] @ nyq[N:]
    return forward_outputs(blocks, re, im, ren, C)


def enhance_fwd(blocks, C):
    """(T, 512) int16 blocks -> (re, im, re_n, mag, mag_n, speech), the
    shapes of ``enhance_fwd_pallas``'s outputs.  T a multiple of 8.

    C: constants from ``ops.enhance.enhance_constants``, on blocks' device.
    CUDA tensors launch ``jb_enhance_fwd``; CPU tensors run
    :func:`enhance_fwd_plain`.
    """
    if check_blocks(blocks, C, CONSTS).type == "cpu":
        return enhance_fwd_plain(blocks, C)
    outs = empty_forward_outputs(blocks.shape[0], blocks.device)
    _build.launch("jb_enhance_fwd", blocks.device, blocks.data_ptr(), blocks.shape[0],
                  *(C[k].data_ptr() for k in CONSTS), *(o.data_ptr() for o in outs))
    enhance_fwd.launches += 1
    return outs


enhance_fwd.launches = 0
