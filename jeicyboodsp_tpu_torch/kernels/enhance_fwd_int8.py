"""The forward half of engine mxu8 ("K2"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_fwd_int8_pallas`` (``_fwd8_kernel``): raw (T, 512) int16 blocks ->
re, im, |X| (T, 512) and re_n, |X_n|, speech flags (T, 1), through the
16-dot int8-split forward rDFT (the hq form), the Nyquist bin as an f32
dot and the in-kernel VAD with ``_vad_rows`` semantics, and the frame
flags nz (T, 1) that the back kernel's gain takes (the TPU kernel has no
such output).

- :func:`enhance_fwd_int8` is the wrapper: on a CUDA tensor it launches the
  hand-written kernels of ``csrc/enhance_mxu8.cu`` (counted in
  ``enhance_fwd_int8.launches``); on a CPU tensor it runs the plain
  version; anything else raises.
- :func:`enhance_fwd_int8_plain` is the plain PyTorch version: K1's
  :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.forward8_plain` plus
  the epilogue :func:`forward_outputs`, which K4's plain version shares.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N, aligned16, check, check_rows
from jeicyboodsp_tpu_torch.kernels.enhance_full8 import forward8_plain, frame_nonzero
from jeicyboodsp_tpu_torch.utils.cnum import c_short

CONSTS = ("fwd8", "fscales", "fcrows", "nyq", "w2")


def vad_rows(blocks, w2):
    """(T, 512) int16 blocks -> (T,) bool speech flags, in f32
    (WienerFilter_final.cpp:261-296; enhance_pallas.py:_vad_rows): the
    int16 window truncation s = c_short(x * w2), energy = sum(s^2)/1024 >
    700, ZCR = #{s[i] * x[i+1] < 0} (the last sample pairs with 0) < 200."""
    x = blocks.to(torch.float32)
    s = c_short(x * w2).to(torch.float32)  # truncated windowed samples
    energy = torch.sum(s * s, dim=-1) / 1024
    nxt = torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)
    zcr = torch.sum((s * nxt) < 0, dim=-1)
    return (energy > 700.0) | (zcr < 200.0)


def forward_outputs(blocks, re, im, ren, C):
    """The seven outputs of the forward kernels K2 / K4 from the re, im
    planes and the Nyquist bin ren (T,): re, im, re_n (T, 1), |X|, |X_n|
    (T, 1), speech flags (T, 1) as 0.0 / 1.0 and the frame flags nz (T, 1)
    as 0.0 / 1.0 (:func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.
    frame_nonzero`), which the back kernels' gain takes."""
    mag = torch.sqrt(re * re + im * im)
    sp = vad_rows(blocks, C["w2"]).to(torch.float32)[:, None]
    nz = frame_nonzero(blocks).to(torch.float32)[:, None]
    return re, im, ren[:, None], mag, ren.abs()[:, None], sp, nz


def enhance_fwd_int8_plain(blocks, C):
    """Plain PyTorch version of :func:`enhance_fwd_int8` (any device)."""
    re, im, ren = forward8_plain(blocks, C)
    return forward_outputs(blocks, re, im, ren, C)


def empty_forward_outputs(T, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(T, N, **f32), torch.empty(T, N, **f32), torch.empty(T, 1, **f32),
            torch.empty(T, N, **f32), torch.empty(T, 1, **f32), torch.empty(T, 1, **f32),
            torch.empty(T, 1, **f32))


def check_blocks(blocks, C, consts):
    T = blocks.shape[0] if blocks.dim() == 2 else -1
    dev = check({"blocks": (blocks, torch.int16, (T, N))}, C, consts)
    check_rows(T, 8)
    return dev


def enhance_fwd_int8(blocks, C):
    """(T, 512) int16 blocks -> (re, im, re_n, mag, mag_n, speech), the
    shapes of ``enhance_fwd_int8_pallas``'s outputs, and the frame flags
    nz (T, 1) for the back kernel K3.  T a multiple of 8.

    C: constants from ``ops.enhance.enhance_constants``, on blocks' device.
    CUDA tensors launch ``jb_enhance_fwd_int8`` (on a copy where the blocks
    do not start on a 16-byte boundary); CPU tensors run
    :func:`enhance_fwd_int8_plain`.
    """
    if check_blocks(blocks, C, CONSTS).type == "cpu":
        return enhance_fwd_int8_plain(blocks, C)
    outs = empty_forward_outputs(blocks.shape[0], blocks.device)
    blocks = aligned16(blocks)
    _build.launch("jb_enhance_fwd_int8", blocks.device, blocks.data_ptr(), blocks.shape[0],
                  *(C[k].data_ptr() for k in CONSTS), *(o.data_ptr() for o in outs))
    enhance_fwd_int8.launches += 1
    return outs


enhance_fwd_int8.launches = 0
