"""AWGN analysis harness: noise generation and the whiteness check
(counterpart of ``jeicyboodsp_tpu/ops/awgn.py``).

Reference: ``AnalysisAdditiveWhiteGaussianNoise.cpp``.  The reference draws
sigma = 10 Gaussian noise per 512-sample block from a time-seeded
``std::default_random_engine`` (``:86-96``), so its contract is
distributional: N(0, 10) noise truncated to int16 and added with C's short
wrap (``:140-142``), and the FFT autocorrelation whiteness check
(``:98-133``).  The draws come from a ``torch.Generator`` (JAX's come from a
PRNG key, so the two packages draw different noise); the int16 arithmetic
given a draw is :func:`add_noise`, the same as JAX's to the bit.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.utils.cnum import c_short

BLOCK = 512
SIGMA = 10.0


def add_noise(blocks, noise):
    """int16 blocks + a float noise draw (already scaled by sigma) ->
    (noisy int16, noise int16): the noise truncated to short (``:94``), then
    short + short stored through a short, which wraps (``:141``)."""
    noise_s = c_short(noise)
    out = c_short((noise_s.to(torch.int32) + blocks.to(torch.int32)).to(noise.dtype))
    return out, noise_s


def add_awgn(generator, blocks, sigma=SIGMA, dtype=torch.float64):
    """(T, 512) int16 + fresh N(0, sigma) noise per block -> (noisy int16,
    noise int16), drawn from ``generator`` on the blocks' device."""
    noise = torch.randn(blocks.shape, generator=generator, dtype=dtype,
                        device=blocks.device) * sigma
    return add_noise(blocks, noise)


def autocorrelation_blocks(blocks, dtype=torch.float64):
    """Whiteness check: each block's autocorrelation over [previous block,
    block] by FFT (``:106-124``), lags 0..511."""
    prev = torch.cat([torch.zeros(1, BLOCK, dtype=blocks.dtype, device=blocks.device), blocks[:-1]])
    frames = torch.cat([prev, blocks], 1).to(dtype)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    X = torch.fft.fft(frames.to(ctype))
    P = X.real ** 2 + X.imag ** 2
    return torch.fft.ifft(P.to(ctype)).real[:, :BLOCK]


def whiteness_ratio(blocks, dtype=torch.float64):
    """max |R(k > 0)| / R(0) per block: near 0 for white noise."""
    ac = autocorrelation_blocks(blocks, dtype)
    return ac[:, 1:].abs().amax(1) / ac[:, 0].clamp_min(1e-30)
