"""The back half of engine mxu8 ("K3"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_back_ola8_pallas`` (``_make_back_ola8_kernel``): re, im, the
latched noise estimate ns (T, 512) and the Nyquist columns re_n, ns_n
(T, 1) -> (T, 512) int16, through the Wiener / spectral-subtraction gain,
per-row two-level int8 quantization, the int8 inverse, the flip, the OLA
with row t-1's tail and ``c_short``, with the t < 2 warm-up mask.  The
gain takes the forward kernel K2's frame flags nz (T, 1): a bin at 0 with
its estimate at 0 passes with gain 1 in a frame that holds a nonzero
sample, the reference's value, where the TPU kernel computes 0/0 = NaN
(:func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.bin_gain`).

- :func:`enhance_back_ola8` is the wrapper: on a CUDA tensor it launches
  the hand-written kernels of ``csrc/enhance_mxu8.cu`` (counted in
  ``enhance_back_ola8.launches``); on a CPU tensor it runs the plain
  version; anything else raises.
- :func:`enhance_back_ola8_plain` is the plain PyTorch version, K1's back
  half :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.inverse8_plain`.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N, check, check_mode, check_rows
from jeicyboodsp_tpu_torch.kernels.enhance_full8 import back8_scratch, inverse8_plain

CONSTS = ("back8", "bscales", "bcrows", "u_nyq", "y512col")


def enhance_back_ola8_plain(re, im, re_n, ns, ns_n, nz, C, mode="wiener", hq=True,
                            emit_all=False, return_planes=False):
    """Plain PyTorch version of :func:`enhance_back_ola8` (any device)."""
    return inverse8_plain(re, im, re_n[:, 0], ns, ns_n[:, 0], nz[:, 0], C, mode, hq, emit_all,
                          return_planes)


def check_planes(re, im, re_n, ns, ns_n, nz, C, consts):
    """The checks of the back-half wrappers K3, K5 and K13; returns the device."""
    f32 = torch.float32
    T = re.shape[0] if re.dim() == 2 else -1
    dev = check({"re": (re, f32, (T, N)), "im": (im, f32, (T, N)),
                 "re_n": (re_n, f32, (T, 1)), "ns": (ns, f32, (T, N)),
                 "ns_n": (ns_n, f32, (T, 1)), "nz": (nz, f32, (T, 1))}, C, consts)
    check_rows(T, 8)
    return dev


def enhance_back_ola8(re, im, re_n, ns, ns_n, nz, C, mode="wiener", hq=True,
                      emit_all=False, return_planes=False):
    """Spectra + latched noise -> (T, 512) int16, rows t < 2 zero unless
    ``emit_all``.  T a multiple of 8; ``nz`` the frame flags (T, 1) of
    :func:`~jeicyboodsp_tpu_torch.kernels.enhance_fwd_int8.enhance_fwd_int8`;
    ``hq=False`` is the turbo inverse.

    C: constants from ``ops.enhance.enhance_constants``, on re's device.
    CUDA tensors launch ``jb_enhance_back_ola8``; CPU tensors run
    :func:`enhance_back_ola8_plain`.  ``return_planes`` also returns the
    scratch q8 (6, T, 512), rowsc (T, 8) and uv (2, T, 512), laid out as
    :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.quant8_plain` and
    :func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.inv8_plain` lay them.
    """
    check_mode(mode)
    dev = check_planes(re, im, re_n, ns, ns_n, nz, C, CONSTS)
    if dev.type == "cpu":
        return enhance_back_ola8_plain(re, im, re_n, ns, ns_n, nz, C, mode, hq, emit_all,
                                       return_planes)
    T = re.shape[0]
    q8, rowsc, uv = back8_scratch(T, dev, return_planes)
    out = torch.empty(T, N, dtype=torch.int16, device=dev)
    p = lambda x: x.data_ptr()  # noqa: E731
    _build.launch("jb_enhance_back_ola8", dev, p(re), p(im), p(re_n), p(ns), p(ns_n), p(nz), T,
                  int(mode == "wiener"), int(hq), int(emit_all), *(p(C[k]) for k in CONSTS),
                  p(q8), p(rowsc), p(uv), p(out))
    enhance_back_ola8.launches += 1
    return (out, {"q8": q8, "rowsc": rowsc, "uv": uv}) if return_planes else out


enhance_back_ola8.launches = 0
