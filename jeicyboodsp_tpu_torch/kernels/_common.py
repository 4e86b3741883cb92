"""What the kernel wrappers share: the checks every wrapper makes before it
hands pointers to a kernel, and the constant tensors the enhancement chain's
kernels read (built by ``ops.enhance.enhance_constants``)."""

from __future__ import annotations

import torch

N = 512
NB = N + 1  # bins with the Nyquist one
MODES = ("wiener", "specsub")

_F32, _I8 = torch.float32, torch.int8
CONST_SPECS = {
    # int8 splits of the window-folded forward bases, [n, k]:
    # WhCp WlCp WhCc WlCc WhSp WlSp WhSc WlSc
    "fwd8": (_I8, (8, N, N)),
    "fscales": (_F32, (8, N)),
    "fcrows": (_F32, (2, N)),
    "nyq": (_F32, (2 * N,)),
    "w2": (_F32, (N,)),           # second Hamming half, for the VAD
    "WC": (_F32, (2 * N, N)),     # f32 window-folded forward bases
    "WS": (_F32, (2 * N, N)),
    "rfft": (_F32, (2560,)),      # K4's real-FFT twiddles, split and window (csrc/rfft1024.cuh)
    "back8": (_I8, (4, N, N)),    # int8 splits of UC512 / VS512, [s, k]: Uh Ul Vh Vl
    "bscales": (_F32, (4, N)),
    "bcrows": (_F32, (2, N)),
    "UC512": (_F32, (N, N)),      # f32 symmetry-halved inverse bases
    "VS512": (_F32, (N, N)),
    "back32": (_F32, (4, N, N)),  # TF32 hi/lo of UC512 / VS512, [s, k]: Uh Ul Vh Vl
    "u_nyq": (_F32, (N,)),
    "y512col": (_F32, (NB,)),
}


def check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def check_rows(T, multiple):
    if T == 0 or T % multiple:
        raise ValueError(f"T={T} must be a positive multiple of {multiple}")


def check_2d(x, name):
    """The (streams, samples) shape of ``x``; raises unless ``x`` is 2-D."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D (streams, samples), got {tuple(x.shape)}")
    return tuple(x.shape)


def check(specs, C=None, consts=()):
    """Check tensors before their pointers reach a kernel.

    specs: {name: (tensor, dtype, shape)}; consts: names of constants in
    ``C``, checked against :data:`CONST_SPECS`.  Every tensor must have its
    dtype and shape, be contiguous and lie on one device, a CPU or a CUDA
    one.  Returns that device.
    """
    named = dict(specs)
    for name in consts:
        if C is None or name not in C:
            raise ValueError(f"constant {name!r} missing")
        named[name] = (C[name], *CONST_SPECS[name])
    device = None
    for name, (x, dtype, shape) in named.items():
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, "
                             f"got {tuple(x.shape)} {x.dtype}")
        device = x.device if device is None else device
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the first input on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


def aligned16(x):
    """``x``, or a copy of it that starts on a 16-byte boundary: the int8
    forward pass (K1, K2) reads its rows with 16-byte asynchronous copies."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
