"""The real FFT that K4 and K10 run on the card (``csrc/rfft1024.cuh``),
modelled on the CPU.

``kernels.enhance_fwd.rfft_frames_model`` repeats the kernels' arithmetic
with their own f32 constants: the window (and K10's pre-emphasis) on the
samples, even and odd samples packed into a 512-point complex transform
(``torch.fft.fft`` here), the split with W_1024^k.  Seeded numpy frames --
the chain's signal with a digital-silence stretch and a quiet row beside a
loud one -- go through the model, the port's plain versions and the JAX
package's Pallas kernels in interpret mode.  A sign or split error shows
here without a card; the CUDA kernels are held against the plain versions
in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.kernels import enhance_pallas as EP
from jeicyboodsp_tpu.kernels import mfcc_pallas as jmk
from jeicyboodsp_tpu.ops import enhance as JE
from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
from jeicyboodsp_tpu_torch.kernels import fft_four_step as K12
from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10
from jeicyboodsp_tpu_torch.ops import enhance as TE
from jeicyboodsp_tpu_torch.ops.features import PRE_EMPHASIS
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI
from jeicyboodsp_tpu_torch.utils.metrics import snr_db
from test_torch_enhance import _signal

F_JAX = 64            # the JAX kernel's row tile: one grid step per 64-block probe
K4_TOL = 2.0 ** -16   # of the row's largest sum of |a*b| (tests/test_torch_cuda.py)
K10_DB = 90.0         # the kernel-vs-plain floor of K10
TWIDDLE_TOL = 2.0 ** -24
CONSTS = K4.rfft_constants()
SPLIT = K4.SPLIT


def _quiet_loud(x, rng, quiet, loud):
    """Row ``quiet`` of (rows, 512) int16 x set to samples in -3..3, row
    ``loud`` to full-scale random ones."""
    x[quiet] = rng.integers(-3, 4, 512)
    x[loud] = rng.integers(-32768, 32768, 512)
    return x


def _blocks(T, seed):
    """(T, 512) int16 blocks of the chain's signal: rows 20 and 21 digital
    silence (frame 21 all zero), a quiet row 30 beside a loud row 31."""
    x = _signal(T, seed).reshape(T, 512)
    x[20:22] = 0
    return _quiet_loud(x, np.random.default_rng(seed), 30, 31)


def _row_scale(frames):
    """(T, 1) f64: the row's largest sum of |a*b| over K4's contraction."""
    M = TE._dft_mats_aligned()
    a = frames.abs().double()
    return torch.maximum(a @ torch.from_numpy(M["WC"]).double().abs(),
                         a @ torch.from_numpy(M["WS"]).double().abs()).amax(1, keepdim=True)


@pytest.mark.parametrize("seed", [11, 12])
def test_model_matches_k4_plain_and_jax(seed):
    """The model's re, im and |X| within 2^-16 of the row's largest sum of
    |a*b| of the plain version and of JAX's enhance_fwd_pallas (interpret);
    the all-zero frame gives exactly zero."""
    b = _blocks(F_JAX, seed)
    blocks = torch.from_numpy(b)
    frames = K4.frames_f32(blocks)
    re, im = K4.rfft_frames_model(frames, CONSTS)
    got = (re, im, torch.sqrt(re * re + im * im))
    plain = K4.enhance_fwd_plain(blocks, TE.enhance_constants("cpu"))
    M = JE._dft_mats_aligned()
    jb = jnp.asarray(b)
    prev = jnp.concatenate([jnp.zeros((1, 512), jb.dtype), jb[:-1]])
    jax_out = EP.enhance_fwd_pallas(prev, jb, M["WC"], M["WS"], M["nyq"], M["w2"], F=F_JAX,
                                    interpret=True)
    tol = K4_TOL * _row_scale(frames)
    for i, g in zip((0, 1, 3), got):
        for what, w in (("plain", plain[i]), ("jax", torch.from_numpy(np.array(jax_out[i])))):
            err = (g.double() - w.double()).abs()
            assert (err <= tol).all(), (what, i, float((err / tol.clamp_min(1e-30)).max()))
    assert got[0][21].eq(0).all() and got[1][21].eq(0).all()
    assert not got[2][30].eq(0).all()  # the quiet frame stays its own size


def _mfcc_rows(n_blocks, seed):
    """(2T + 1, 512) int16 rows of K10's frames (frame f = rows[f] ++
    rows[f + 1]): a speech-like signal with rows 4-7 digital silence, a
    quiet row 12 beside a loud row 13."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * 1024) / 16000.0
    x = 8000 * np.sin(2 * np.pi * 140 * t) + 2000 * np.sin(2 * np.pi * 420 * t)
    x = np.clip(x + rng.normal(0, 300, x.size), -32768, 32767).astype(np.int16)
    rows = np.concatenate([np.zeros(512, np.int16), x]).reshape(-1, 512)
    rows[4:8] = 0
    return _quiet_loud(rows, rng, 12, 13)


def _masks_and_db(got, want):
    """SNR over the finite values, with equal NaN and infinity masks."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    return snr_db(w[fin], g[fin])


@pytest.mark.parametrize("n_blocks", [12, 24])
def test_model_matches_k10_plain_and_jax(n_blocks):
    """The model's MFCC (pre-emphasis in f32, window, real FFT, then |X|, mel,
    log and DCT) >= 90 dB of the plain version and of JAX's
    mfcc_fused_pallas (interpret) over the finite features, NaN and infinity
    masks equal: silent frames give NaN, the quiet frame does not."""
    rows = _mfcc_rows(n_blocks, n_blocks)
    prev, cur = torch.from_numpy(rows[:-1].copy()), torch.from_numpy(rows[1:].copy())
    re, im = K4.rfft_frames_model(torch.cat([prev, cur], 1), CONSTS, PRE_EMPHASIS)
    _, _, mel, dct = (torch.from_numpy(a) for a in K10.mfcc_consts())
    got = (torch.log(torch.sqrt(re * re + im * im) @ mel) @ dct).numpy()
    assert np.isnan(got[4:7]).all() and np.isfinite(got[11:13]).all()
    plain = K10.mfcc_fused_plain(prev, cur).numpy()
    jk = np.asarray(jmk.mfcc_fused_pallas(jnp.asarray(rows[:-1]), jnp.asarray(rows[1:]), F=8,
                                          interpret=True))
    db_plain, db_jax = _masks_and_db(got, plain), _masks_and_db(got, jk)
    print(f"model vs plain {db_plain:.2f} dB, vs JAX interpret {db_jax:.2f} dB")
    assert db_plain >= K10_DB and db_jax >= K10_DB


@pytest.mark.parametrize("k", [0, 1, 255, 256, 257, 511])
def test_model_split_against_f64(k):
    """A windowed cosine and sine at bin k (and full-scale noise beside
    them) through the model against numpy's f64 real FFT, within 2^-20 of
    the row's sum of |x w|: the split's ends k = 0 and 256 and its sign
    convention show here."""
    n = np.arange(1024)
    rng = np.random.default_rng(k)
    x = np.stack([20000 * np.cos(2 * np.pi * k * n / 1024), 20000 * np.sin(2 * np.pi * k * n / 1024),
                  rng.integers(-32768, 32768, 1024)]).round()
    re, im = K4.rfft_frames_model(torch.from_numpy(x), CONSTS)
    w = CONSTS[K4.WINDOW:].astype(np.float64)
    X = np.fft.rfft(x * w)[:, :512]
    tol = 2.0 ** -20 * np.abs(x * w).sum(1, keepdims=True)
    assert (np.abs(re.numpy() - X.real) <= tol).all() and (np.abs(im.numpy() - X.imag) <= tol).all()


def test_constants_against_their_definitions():
    """Each twiddle within 2^-24 of exp(-2 pi i k / n); the 512-point tables
    equal K12's; the window within 2^-24 of the f64 Hamming window, its
    second half bit-equal to w2 (the port's and the JAX package's); K4 and
    K10 carry the same array."""
    c = CONSTS.astype(np.float64)
    assert CONSTS.dtype == np.float32 and CONSTS.shape == (SPLIT + 2048,)
    e = np.arange(128)
    for vals, ang in ((c[:128] + 1j * c[128:256], e / 512), (c[256:384] + 1j * c[384:512], 128 * e / 512),
                      (c[SPLIT:SPLIT + 512] + 1j * c[SPLIT + 512:SPLIT + 1024], np.arange(512) / 1024)):
        want = np.exp(-2j * np.pi * ang)
        assert np.abs(vals.real - want.real).max() <= TWIDDLE_TOL
        assert np.abs(vals.imag - want.imag).max() <= TWIDDLE_TOL
    assert np.array_equal(CONSTS[:SPLIT], K12._kernel_consts(512, True, torch.device("cpu")).numpy())
    win = CONSTS[K4.WINDOW:]
    ham = 0.54 - 0.46 * np.cos(2.0 * REF_PI * np.arange(1024) / 1023)
    assert np.abs(win - ham).max() <= TWIDDLE_TOL
    assert win[512:].tobytes() == TE._dft_mats_aligned()["w2"].tobytes()
    assert win[512:].tobytes() == np.asarray(JE._dft_mats_aligned()["w2"], np.float32).tobytes()
    assert np.array_equal(TE.enhance_constants("cpu")["rfft"].numpy(), CONSTS)
    assert np.array_equal(K10.kernel_constants(torch.device("cpu"))["rfft"].numpy(), CONSTS)
