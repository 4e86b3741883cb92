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
from jeicyboodsp_tpu_torch.kernels._common import N, check, check_rows
from jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8 import vad_rows


def vad_flags(cur, w2):
    """(T, 512) int16 blocks, w2 (512,) f32 -> (T,) bool speech flags.

    CUDA tensors launch ``jb_vad_flags`` (16-byte loads when the blocks
    start on a 16-byte boundary, 2-byte loads otherwise); CPU tensors run
    :func:`vad_rows`.
    """
    T = cur.shape[0] if cur.dim() == 2 else -1
    dev = check({"cur": (cur, torch.int16, (T, N)), "w2": (w2, torch.float32, (N,))})
    check_rows(T, 1)
    if dev.type == "cpu":
        return vad_rows(cur, w2)
    flags = torch.empty(T, dtype=torch.bool, device=dev)
    _build.launch("jb_vad_flags", dev, cur.data_ptr(), w2.data_ptr(), T, flags.data_ptr())
    vad_flags.launches += 1
    return flags


vad_flags.launches = 0
