"""The back half of the two-kernel f32 engine ("K13"): wrapper, plain
version, count.

Replaces the Pallas kernel ``jeicyboodsp_tpu/kernels/enhance_pallas.py:
enhance_back_pallas`` (``_make_back_kernel``): re, im, the latched noise
estimate ns (T, 512) and the Nyquist columns re_n, ns_n (T, 1) -> head =
u - v, w2 = u + v (T, 512) and y512 (T, 1), through the Wiener /
spectral-subtraction gain (with K4's frame flags nz: a zero bin of a
frame that holds a nonzero sample passes with gain 1 where the TPU kernel
makes it 0/0 = NaN, ``enhance_full8.bin_gain``) and the
symmetry-halved inverse u = Yre @ UC512 + Yren*u_nyq, v = Yim @ VS512, with
y512 = Yre @ y512col[:512] + Yren*y512col[512].  Its caller assembles the
OLA (``ops.enhance._enhance_fused``).  The TPU kernel runs the two GEMMs as
bf16x3 only because Mosaic has no ``Precision.HIGH``; here they are
3xTF32 (about 2^-22 of each product), the plain version's cuBLAS f32.

- :func:`enhance_back` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/enhance_mxu3.cu`` (counted in
  ``enhance_back.launches``): the gain applied as the spectra land in
  shared memory and both GEMMs on the tensor cores as 3xTF32
  (``csrc/tf32x3.cuh``), head and w2 written by its epilogue; on a CPU
  tensor it runs the plain version; anything else raises.
- :func:`enhance_back_plain` is the plain PyTorch version: K1's gain and
  f32 matmuls.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels._common import N, check_mode
from jeicyboodsp_tpu_torch.kernels.enhance_back_ola8 import check_planes
from jeicyboodsp_tpu_torch.kernels.enhance_full8 import bin_gain, y512_col

CONSTS = ("back32", "u_nyq", "y512col")  # what the kernel reads
CHECKED = ("UC512", "VS512", *CONSTS)  # with what the plain version reads


def enhance_back_plain(re, im, re_n, ns, ns_n, nz, C, mode="wiener"):
    """Plain PyTorch version of :func:`enhance_back` (any device)."""
    ren = re_n[:, 0]
    g, gn = bin_gain(re, im, ren, ns, ns_n[:, 0], nz[:, 0], mode)
    Yre, Yim, Yren = re * g, im * g, ren * gn
    u = Yre @ C["UC512"] + Yren[:, None] * C["u_nyq"]
    v = Yim @ C["VS512"]
    return u - v, u + v, y512_col(Yre, Yren, C)[:, None]


def enhance_back(re, im, re_n, ns, ns_n, nz, C, mode="wiener"):
    """Spectra + latched noise -> (head, w2, y512), the shapes of
    ``enhance_back_pallas``'s outputs.  T a multiple of 8; ``nz`` the frame
    flags (T, 1) of :func:`~jeicyboodsp_tpu_torch.kernels.enhance_fwd.
    enhance_fwd`.

    C: constants from ``ops.enhance.enhance_constants``, on re's device.
    CUDA tensors launch ``jb_enhance_back``; CPU tensors run
    :func:`enhance_back_plain`.
    """
    check_mode(mode)
    dev = check_planes(re, im, re_n, ns, ns_n, nz, C, CHECKED)
    if dev.type == "cpu":
        return enhance_back_plain(re, im, re_n, ns, ns_n, nz, C, mode)
    T = re.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    hw = torch.empty(2, T, N, **f32)
    y512 = torch.empty(T, 1, **f32)
    p = lambda x: x.data_ptr()  # noqa: E731
    _build.launch("jb_enhance_back", dev, p(re), p(im), p(re_n), p(ns), p(ns_n), p(nz), T,
                  int(mode == "wiener"), *(p(C[k]) for k in CONSTS), p(hw), p(y512))
    enhance_back.launches += 1
    return hw[0], hw[1], y512


enhance_back.launches = 0
