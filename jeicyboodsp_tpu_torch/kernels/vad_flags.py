"""The VAD in one read of the blocks ("K14"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
vad_flags_pallas`` (``_vad_kernel``, ``_vad_rows``): (T, 512) int16 blocks
and the second Hamming half w2 (512,) -> speech flags, with the semantics
of ``WienerFilter_final.cpp:261-296``.  It returns them as (T,) bool, as
``ops.enhance.vad_flags`` does, where the TPU kernel returns (T, 1) f32
0.0 / 1.0.

- :func:`vad_flags` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/vad.cu`` (counted in
  ``vad_flags.launches``); on a CPU tensor it runs the plain version
  :func:`~jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8.vad_rows`; anything
  else raises.  The flags are exact either way: the kernel sums integers,
  the plain version f32 values whose sums are exact where they decide.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N
from jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8 import vad_rows


def vad_flags(cur, w2):
    """(T, 512) int16 blocks, w2 (512,) f32 -> (T,) bool speech flags.

    CUDA tensors launch ``jb_vad_flags`` (16-byte loads when the blocks and
    w2 start on a 16-byte boundary, scalar loads otherwise); CPU tensors run
    :func:`vad_rows`.  The checks are ``_common.check``'s, written out: the
    engines mxu8f and mxu8t call this wrapper once a call, and its host
    time is most of its time.
    """
    shape = cur.shape
    if cur.dtype != torch.int16 or len(shape) != 2 or shape[1] != N or not shape[0]:
        raise ValueError(f"cur must be (T, {N}) torch.int16 with T >= 1, "
                         f"got {tuple(shape)} {cur.dtype}")
    if w2.dtype != torch.float32 or w2.shape != (N,):
        raise ValueError(f"w2 must be ({N},) torch.float32, got {tuple(w2.shape)} {w2.dtype}")
    if not (cur.is_contiguous() and w2.is_contiguous()):
        raise ValueError("cur and w2 must be contiguous")
    dev = cur.device
    if w2.device != dev:
        raise ValueError(f"w2 is on {w2.device}, cur on {dev}")
    if not cur.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"no kernel for device {dev}")
        return vad_rows(cur, w2)
    flags = cur.new_empty(shape[0], dtype=torch.bool)
    _build.launch("jb_vad_flags", dev, cur.data_ptr(), w2.data_ptr(), shape[0], flags.data_ptr())
    vad_flags.launches += 1
    return flags


vad_flags.launches = 0
