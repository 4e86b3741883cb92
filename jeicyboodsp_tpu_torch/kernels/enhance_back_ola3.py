"""The back half of engine mxu3 ("K5"): wrapper, plain version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_back_ola3_pallas`` (``_make_back_ola3_kernel``): the inputs of K3
-> (T, 512) int16, through the gain, the f32 inverse u = Yre @ UC512 +
Yren*u_nyq, v = Yim @ VS512, the y512 column, the flip, the OLA with row
t-1's tail and ``c_short``.  The TPU kernel returns the f32 ``c_short``
values and its caller casts them and applies the t < 2 mask
(``jeicyboodsp_tpu/ops/enhance.py:_enhance_fused3``); those values are
exact integers, so this kernel writes int16 with the mask folded in, which
equals the cast.

- :func:`enhance_back_ola3` is the wrapper: on a CUDA tensor it launches
  the hand-written kernels of ``csrc/enhance_mxu3.cu`` (counted in
  ``enhance_back_ola3.launches``): K13's tensor-core pass (the gain on the
  way in, 3xTF32 GEMMs, head and w2 out), then the flip and OLA; on a CPU
  tensor it runs the plain version; anything else raises.
- :func:`enhance_back_ola3_plain` is the plain PyTorch version: f32 matmuls
  and K1's gain and flip/OLA.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N, check_mode
from jeicyboodsp_tpu_torch.kernels.enhance_back_ola8 import check_planes
from jeicyboodsp_tpu_torch.kernels.enhance_full8 import bin_gain, flip_ola, y512_col

CONSTS = ("back32", "u_nyq", "y512col")  # what the kernel reads
CHECKED = ("UC512", "VS512", *CONSTS)  # with what the plain version reads


def enhance_back_ola3_plain(re, im, re_n, ns, ns_n, nz, C, mode="wiener", emit_all=False):
    """Plain PyTorch version of :func:`enhance_back_ola3` (any device)."""
    ren = re_n[:, 0]
    g, gn = bin_gain(re, im, ren, ns, ns_n[:, 0], nz[:, 0], mode)
    Yre, Yim, Yren = re * g, im * g, ren * gn
    u = Yre @ C["UC512"] + Yren[:, None] * C["u_nyq"]
    v = Yim @ C["VS512"]
    return flip_ola(u, v, y512_col(Yre, Yren, C), emit_all)


def enhance_back_ola3(re, im, re_n, ns, ns_n, nz, C, mode="wiener", emit_all=False):
    """Spectra + latched noise -> (T, 512) int16, rows t < 2 zero unless
    ``emit_all``.  T a multiple of 8; ``nz`` the frame flags (T, 1) of
    :func:`~jeicyboodsp_tpu_torch.kernels.enhance_fwd.enhance_fwd`, which
    the gain takes (:func:`~jeicyboodsp_tpu_torch.kernels.enhance_full8.
    bin_gain`).

    C: constants from ``ops.enhance.enhance_constants``, on re's device.
    CUDA tensors launch ``jb_enhance_back_ola3``; CPU tensors run
    :func:`enhance_back_ola3_plain`.
    """
    check_mode(mode)
    dev = check_planes(re, im, re_n, ns, ns_n, nz, C, CHECKED)
    if dev.type == "cpu":
        return enhance_back_ola3_plain(re, im, re_n, ns, ns_n, nz, C, mode, emit_all)
    T = re.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    hw = torch.empty(2, T, N, **f32)  # head, w2
    y512 = torch.empty(T, **f32)
    out = torch.empty(T, N, dtype=torch.int16, device=dev)
    p = lambda x: x.data_ptr()  # noqa: E731
    _build.launch("jb_enhance_back_ola3", dev, p(re), p(im), p(re_n), p(ns), p(ns_n), p(nz), T,
                  int(mode == "wiener"), int(emit_all), *(p(C[k]) for k in CONSTS),
                  p(hw), p(y512), p(out))
    enhance_back_ola3.launches += 1
    return out


enhance_back_ola3.launches = 0
