"""The arithmetic K11 (csrc/amdf.cu) computes in place of its plain
version's int64 sums, held bit for bit against them on the CPU, where no
card is needed.

The kernel sums sum_{i<n} |u_i - u_{i+k}| (n = 1024 - k) as
P[n] + (P[1024] - P[k]) - 2 sum_{i<n} min(u_i, u_{i+k}) in int32, P the
frame's prefix sums.  It takes the minima two pairs at a time on packed
int16 words (DPX ``__vmins2``; odd lags pair a word with b's words shifted
by one sample, ``__byte_perm(w, w', 0x5432)``) and adds both halves with one
``__dp2a_lo(min, 0x0101, acc)``, over lag groups of 8 lags and chunks of 8
samples; the last chunk of a group reads 32767s staged past the frame, whose
min is a[j], and those terms are taken off again.  :func:`kernel_sums` is a
numpy model of that, word for word; it must equal the int64 masked sums on
frames of full-scale extremes, whose sums pass 2^24 (where an f32 sum would
round), and every partial sum must stay inside int32.
"""

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.kernels import amdf as K11

PROC, KEEP, R = 1024, 512, 8
PAD = 32767  # staged past the frame: min(a, 32767) = a


def _words(u):
    """(T, n) int16 -> (T, n / 2) uint32 packed pairs, the first sample low."""
    v = u.astype(np.uint16).astype(np.uint32)
    return v[:, 0::2] | (v[:, 1::2] << 16)


def _halves(w):
    """Both int16 halves of packed words, sign-extended, as int64 (lo, hi)."""
    return ((w & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int64),
            (w >> 16).astype(np.uint16).view(np.int16).astype(np.int64))


def _vmins2(x, y):
    (xl, xh), (yl, yh) = _halves(x), _halves(y)
    return (np.minimum(xl, yl).astype(np.uint16).astype(np.uint32)
            | (np.minimum(xh, yh).astype(np.uint16).astype(np.uint32) << 16))


def _dp2a_lo_ones(w):
    """__dp2a_lo(w, 0x0101, 0): the sum of w's two signed halves."""
    lo, hi = _halves(w)
    return lo + hi


def kernel_sums(u, lo, pad=PAD):
    """csrc/amdf.cu's lag sums of the int16 frames u (T, 1024), int64 (T, 512 - lo).

    Per group k0 = lo, lo + 8, ... and lag r: acc = the chunks' dp2a sums of
    vmins2(a word, b word) over its c = (1024 - k0) / 8 chunks, b's words
    shifted by one sample for odd r; then the triangle's a[j], j >= 8 - r, off
    acc; then P[n] + (P[1024] - P[k]) - 2 acc.  Asserts that every partial sum
    (running along the chunks in order) fits int32.
    """
    T = len(u)
    staged = np.concatenate([u, np.full((T, 2 * R), pad, np.int16)], 1)
    W = _words(staged)  # the staged words: the frame, then 8 of two pads
    P = np.concatenate([np.zeros((T, 1), np.int64), np.cumsum(u.astype(np.int64), 1)], 1)
    assert np.abs(P).max() < 2 ** 31
    out = np.zeros((T, KEEP - lo), np.int64)
    for k0 in range(lo, KEEP, R):
        c = (PROC - k0) // R
        aw = W[:, :4 * c]  # chunk q's words 4q .. 4q+3
        for r in range(R):
            base = k0 // 2 + r // 2 + np.arange(4 * c)
            if r % 2:  # __byte_perm(b[w], b[w + 1], 0x5432): samples 2w+1, 2w+2
                bw = (W[:, base] >> 16) | ((W[:, base + 1] & 0xFFFF) << 16)
            else:
                bw = W[:, base]
            terms = _dp2a_lo_ones(_vmins2(aw, bw)).reshape(T, c, 4).sum(2)
            run = np.cumsum(terms, 1)
            assert np.abs(run).max() < 2 ** 31
            acc = run[:, -1]
            a_last = staged[:, 8 * c - R:8 * c].astype(np.int64)
            acc = acc - a_last[:, R - r:].sum(1)  # the triangle's min(a[j], pad) = a[j]
            k = k0 + r
            s = P[:, PROC - k] + (P[:, PROC] - P[:, k]) - 2 * acc
            assert np.abs(s).max() < 2 ** 31
            out[:, k - lo] = s
    return out


def masked_sums(u, lo):
    """The plain version's sums: int64 over the masked range itself."""
    v = u.astype(np.int64)
    return np.stack([np.abs(v[:, :PROC - k] - v[:, k:]).sum(1) for k in range(lo, KEEP)], 1)


def _frames(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "extremes":  # random full-scale extremes: many sums pass 2^24
        u = np.where(rng.random((3, PROC)) < 0.5, -32768, 32767)
        u[2] = 0  # a silent frame
    elif kind == "alternating":  # every odd lag's every term is 65535
        u = np.tile(np.array([-32768, 32767]), (2, PROC // 2))
        u[1] = -u[1] - 1
    elif kind == "constant":  # every sum 0: the pads and the prefix sums cancel exactly
        u = np.full((2, PROC), 32767)
        u[1] = -32768
    else:  # tests/test_torch_features.py's frames
        u = rng.integers(-3000, 3000, (3, PROC))
    return u.astype(np.int16)


@pytest.mark.parametrize("lo", [0, 8, 96, 504])
@pytest.mark.parametrize("kind", ["extremes", "alternating", "constant", "speech-scale"])
def test_kernel_int32_sums_equal_int64_sums(kind, lo):
    u = _frames(kind, lo)
    want = masked_sums(u, lo)
    if kind in ("extremes", "alternating"):
        assert want.max() >= 2 ** 24  # an f32 sum over a whole lag would round
    assert np.array_equal(kernel_sums(u, lo), want)
    # and the wrapper's CPU path, the plain version, divides those sums once
    got = K11.amdf(torch.from_numpy(u), lo).numpy()
    assert np.array_equal(got, want / (PROC - np.arange(lo, KEEP, dtype=np.float64)))


def test_triangle_reads_the_pads():
    """The last chunk of each lag group runs whole: with zeros in place of
    the 32767s past the frame (min(a, 0) is not a) the sums go wrong, so the
    model does run the triangle through the pads, as the kernel does."""
    u = _frames("speech-scale", 1)
    assert not np.array_equal(kernel_sums(u, 96, pad=0), masked_sums(u, 96))
