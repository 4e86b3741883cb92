"""CPU parity of the port's speech features (``jeicyboodsp_tpu_torch.ops.
features``, kernels K10 and K11, the GMM scorer and ``speech_classify``) with
the JAX package and the f64 oracles.

On CPU tensors the kernel wrappers run their plain PyTorch versions, so these
tests hold the plain versions' arithmetic; the CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py and by chip_smoke.py.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.kernels import mfcc_pallas as jmk
from jeicyboodsp_tpu.kernels.amdf_pallas import amdf_pallas
from jeicyboodsp_tpu.oracle import gmm as ogmm
from jeicyboodsp_tpu.oracle import mfcc as omfcc
from jeicyboodsp_tpu.oracle import pitch as opitch
from jeicyboodsp_tpu.ops import dft as jdft
from jeicyboodsp_tpu.ops import features as jf
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.kernels import amdf as K11
from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10
from jeicyboodsp_tpu_torch.models import gmm as TG
from jeicyboodsp_tpu_torch.ops import dft as tdft
from jeicyboodsp_tpu_torch.ops import features as tf
from jeicyboodsp_tpu_torch.oracle import gmm as port_ogmm
from jeicyboodsp_tpu_torch.oracle import mfcc as port_omfcc
from jeicyboodsp_tpu_torch.oracle import pitch as port_opitch
from jeicyboodsp_tpu_torch.pipelines.speech import speech_classify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _speech(n, seed=0, f0=123.0):
    """tests/test_features.py's probe: a tone and its third harmonic over N(0, 300)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 8000 * np.sin(2 * np.pi * f0 * t) + 2000 * np.sin(2 * np.pi * 3 * f0 * t)
    return np.clip(x + rng.normal(0, 300, n), -32768, 32767).astype(np.int16)


def _rows(x):
    """The zero-prefixed (2T + 1, 512) rows whose [:-1] and [1:] are the
    frame halves of mfcc_blocks."""
    return np.concatenate([np.zeros(512, np.int16), x]).reshape(-1, 512)


def _finite_equal_masks(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    return g[fin], w[fin]


# ---- constants ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["MFCC_LEN", "BLOCK_LEN", "WINDOW_LEN", "KEEP_LEN", "CHANNEL",
                                  "LIFTER_LEN", "HALF_SAMPLING_RATE", "PRE_EMPHASIS"])
def test_mfcc_constants_equal_the_oracle(name):
    assert getattr(tf, name) == getattr(omfcc, name)


def test_pitch_constants_equal_the_oracle():
    assert (tf.BLOCK, tf.PROC, tf.FS) == (opitch.BLOCK, opitch.PROC, opitch.FS)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mel_and_dct_byte_identical(dtype):
    for w, g in zip(omfcc.mel_filterbank_init(), tf.mel_filterbank_init()):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    for fn in ("mel_matrix", "dct_lifter_matrix"):
        w, g = getattr(jf, fn)(dtype), getattr(tf, fn)(dtype)
        assert w.dtype == g.dtype and w.shape == g.shape and w.tobytes() == g.tobytes(), fn


def test_mfcc_consts_byte_identical():
    """K10's folded bases equal _mfcc_consts'; its mel and DCT are the JAX
    kernel's without the 128-lane padding (ones and zeros)."""
    Cf, Sf, mel, dct = jmk._mfcc_consts()
    tC, tS, tmel, tdct = K10.mfcc_consts()
    assert tC.tobytes() == Cf.tobytes() and tS.tobytes() == Sf.tobytes()
    assert tmel.tobytes() == np.ascontiguousarray(mel[:, :38]).tobytes()
    assert tdct.tobytes() == np.ascontiguousarray(dct[:38, :12]).tobytes()
    assert (mel[:, 38:] == 1).all() and (dct[38:] == 0).all() and (dct[:, 12:] == 0).all()


@pytest.mark.parametrize("n", [1024, 2048])
def test_rdft_mats_byte_identical(n):
    for w, g in zip(jdft._rdft_mats(n), tdft._rdft_mats(n)):
        assert w.dtype == g.dtype == np.float32 and w.tobytes() == g.tobytes()


def test_autocorr_mats_byte_identical():
    for n, keep in ((1024, 512), (2048, 512)):
        w, g = jdft._autocorr_mats(n, keep), tdft._autocorr_mats(n, keep)
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()


def test_rdft_and_autocorr_match_jax_in_f64():
    """In f64 the bases are the f32 values cast up, as JAX's f64 x f32 dot."""
    x = np.random.default_rng(1).normal(0, 1000, (3, 1024))
    re, im = tdft.rdft(torch.from_numpy(x))
    jre, jim = jdft.rdft(jnp.asarray(x))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=1e-12, atol=1e-6)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=1e-12, atol=1e-6)
    p = re ** 2 + im ** 2
    ac = tdft.autocorr_from_half_power(p, 1024, 512).numpy()
    jac = np.asarray(jdft.autocorr_from_half_power(jnp.asarray(p.numpy()), 1024, 512))
    np.testing.assert_allclose(ac, jac, rtol=1e-9, atol=1e-3)


def test_mel_table_rebuilds_the_mel_matrix():
    """K10's per-channel runs hold every non-zero of the mel matrix."""
    mel = K10.mfcc_consts()[2]
    runs, w = K10.mel_table(mel)
    dense = np.zeros_like(mel)
    for c, (lo, hi, off) in enumerate(runs):
        dense[lo:hi, c] = w[off:off + hi - lo]
    assert np.array_equal(dense, mel) and len(w) <= K10.MEL_TABLE_MAX


# ---- K10 and the MFCC paths ----------------------------------------------------


@pytest.mark.parametrize("T", [8, 16])
def test_k10_plain_vs_jax_kernel_and_oracle(T):
    """The plain version against the JAX kernel in interpret mode (bf16x3,
    the less accurate side: >= 80 dB) and the f64 oracle (>= 100 dB)."""
    x = _speech(T * 1024, seed=T)
    rows = _rows(x)
    got = K10.mfcc_fused(torch.from_numpy(rows[:-1].copy()), torch.from_numpy(rows[1:].copy()))
    assert got.dtype == torch.float32 and got.shape == (2 * T, 12)
    got = got.numpy()
    jk = np.asarray(jmk.mfcc_fused_pallas(jnp.asarray(rows[:-1]), jnp.asarray(rows[1:]), F=8,
                                          interpret=True))
    oref = omfcc.run(x, skip_first=False)
    print(f"T={T}: plain vs JAX kernel {snr_db(jk, got):.2f} dB, plain vs oracle "
          f"{snr_db(oref, got):.2f} dB, JAX kernel vs oracle {snr_db(oref, jk):.2f} dB")
    assert snr_db(jk, got) >= 80.0
    assert snr_db(oref, got) >= 100.0


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_k10_plain_steady_across_threads(threads):
    """The plain version sums its DFT in f64, so the BLAS threading cannot
    move it: under each torch thread count it reads >= 100 dB against the
    f64 oracle and >= 80 dB against the JAX kernel (interpret), and it
    equals its own result under one thread to f32 rounding."""
    x = _speech(8 * 1024, seed=8)
    rows = _rows(x)
    prev, cur = torch.from_numpy(rows[:-1].copy()), torch.from_numpy(rows[1:].copy())
    jk = np.asarray(jmk.mfcc_fused_pallas(jnp.asarray(rows[:-1]), jnp.asarray(rows[1:]), F=8,
                                          interpret=True))
    oref = omfcc.run(x, skip_first=False)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = K10.mfcc_fused(prev, cur).numpy()
        torch.set_num_threads(threads)
        got = K10.mfcc_fused(prev, cur).numpy()
    finally:
        torch.set_num_threads(before)
    print(f"threads={threads}: plain vs oracle {snr_db(oref, got):.2f} dB, plain vs JAX kernel "
          f"{snr_db(jk, got):.2f} dB, vs one thread {snr_db(one, got):.2f} dB")
    assert snr_db(oref, got) >= 100.0
    assert snr_db(jk, got) >= 80.0
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("engine", ["mxu3", "mxu8"])
def test_mfcc_blocks_mxu_vs_jax(engine):
    """mfcc_blocks(mxu3) runs K10's plain version on the CPU (JAX's takes
    mfcc_frames there): >= 95 dB of each other; mxu8 aliases mxu3."""
    x = _speech(12 * 1024, seed=3)
    blocks = x.reshape(-1, 1024)
    want = np.asarray(jf.mfcc_blocks(jnp.asarray(blocks), jnp.asarray(jf.mel_matrix(np.float32)),
                                     jnp.asarray(jf.dct_lifter_matrix(np.float32)),
                                     dtype=jnp.float32, fft_engine=engine))
    got = tf.mfcc_blocks(torch.from_numpy(blocks), *tf.mel_dct(torch.float32, "cpu"),
                         dtype=torch.float32, fft_engine=engine)
    assert got.dtype == torch.float32 and got.shape == want.shape == (24, 12)
    print(f"{engine}: port vs JAX {snr_db(want, got.numpy()):.2f} dB")
    assert snr_db(want, got.numpy()) >= 95.0


@pytest.mark.parametrize("engine,dtype", [("xla", torch.float32), ("xla", torch.float64),
                                          ("mxu3", torch.float64), ("mxu", torch.float32)])
def test_mfcc_blocks_other_routes_vs_jax(engine, dtype):
    """The routes through mfcc_frames, with leading dims: (2, T, 1024) gives
    (2, 2T, 12), each stream framed on its own."""
    x = np.stack([_speech(6 * 1024, seed=4), _speech(6 * 1024, seed=5, f0=200.0)])
    blocks = x.reshape(2, -1, 1024)
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    npd = np.float32 if dtype == torch.float32 else np.float64
    want = np.asarray(jf.mfcc_blocks(jnp.asarray(blocks), jnp.asarray(jf.mel_matrix(npd)),
                                     jnp.asarray(jf.dct_lifter_matrix(npd)), dtype=jd,
                                     fft_engine=engine))
    got = tf.mfcc_blocks(torch.from_numpy(blocks), *tf.mel_dct(dtype, "cpu"), dtype=dtype,
                         fft_engine=engine).numpy()
    assert got.shape == want.shape == (2, 12, 12) and got.dtype == npd
    assert snr_db(want, got) >= (250.0 if (engine, dtype) == ("xla", torch.float64) else 95.0)
    one = tf.mfcc_blocks(torch.from_numpy(blocks[1]), *tf.mel_dct(dtype, "cpu"), dtype=dtype,
                         fft_engine=engine).numpy()
    # a batched matmul may block its sums otherwise: equal to the dtype's rounding
    np.testing.assert_allclose(got[1], one, rtol=1e-5 if dtype == torch.float32 else 1e-12,
                               atol=1e-4 if dtype == torch.float32 else 1e-12)


def test_mfcc_blocks_k10_leading_dims():
    x = np.stack([_speech(4 * 1024, seed=6), _speech(4 * 1024, seed=7, f0=180.0)])
    blocks = torch.from_numpy(x.reshape(2, 4, 1024))
    md = tf.mel_dct(torch.float32, "cpu")
    got = tf.mfcc_blocks(blocks, *md, fft_engine="mxu3")
    assert got.shape == (2, 8, 12)
    for i in range(2):
        assert torch.equal(got[i], tf.mfcc_blocks(blocks[i], *md, fft_engine="mxu3"))


@pytest.mark.parametrize("engine", ["xla", "mxu3"])
def test_silent_frames_give_the_oracles_nan(engine):
    """Digital silence: every mel channel log 0 = -inf, the DCT's mixed signs
    make the frame's features NaN, in the oracle and in the port alike."""
    x = _speech(6 * 1024, seed=8)
    x[1024:3 * 1024] = 0
    want = omfcc.run(x, skip_first=False)
    assert np.isnan(want).any()
    rows = _rows(x)
    k10 = K10.mfcc_fused(torch.from_numpy(rows[:-1].copy()), torch.from_numpy(rows[1:].copy()))
    for got in (k10.numpy(), tf.mfcc_run(x, torch.float32, skip_first=False, fft_engine=engine,
                                         device="cpu")):
        g, w = _finite_equal_masks(got, want)
        assert snr_db(w, g) >= 100.0


@pytest.mark.parametrize("n", [0, 100, 1024 * 5 + 100, 1024 * 3])
def test_mfcc_run_f64_matches_oracle(n):
    """rtol 1e-9, as tests/test_features.py holds the JAX op; an empty
    payload gives no frames, a partial block the stale tail."""
    x = _speech(n, seed=9)
    want = omfcc.run(x)
    got = tf.mfcc_run(x, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, jf.mfcc_run(x), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("engine", ["xla", "mxu3"])
def test_mfcc_run_f32_snr(engine):
    x = _speech(5 * 1024, seed=10)
    got = tf.mfcc_run(x, torch.float32, fft_engine=engine, device="cpu")
    assert got.dtype == np.float32
    assert snr_db(omfcc.run(x), got) >= 100.0  # config.ENGINE_FIDELITY["mfcc", "mxu3"]


# ---- K11 and pitch -------------------------------------------------------------


def _frames(T, seed):
    return np.random.default_rng(seed).integers(-3000, 3000, (T, 1024)).astype(np.int16)


@pytest.mark.parametrize("lo", [0, 96])
def test_k11_plain_vs_jax_kernel(lo):
    """Within the JAX test's rtol=1e-6, atol=1e-3: its f32 sums round."""
    u = _frames(5, lo)
    got = K11.amdf(torch.from_numpy(u), lo)
    assert got.dtype == torch.float64 and got.shape == (5, 512 - lo)
    want = np.asarray(amdf_pallas(jnp.asarray(u.astype(np.float32)), lo=lo, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("lo", [0, 8, 96, 504])
def test_k11_plain_bit_equal_to_masked_int64_loop(lo):
    u = np.random.default_rng(lo).integers(-32768, 32768, (3, 1024)).astype(np.int16)
    u[2] = 0
    got = K11.amdf(torch.from_numpy(u), lo).numpy()
    v = u.astype(np.int64)
    want = np.stack([np.abs(v[:, :1024 - k] - v[:, k:]).sum(1) / (1024 - k)
                     for k in range(lo, 512)], 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lo", [4, -8, 512, 100, 1000])
def test_k11_rejects_the_lo_jax_rejects(lo):
    with pytest.raises(ValueError):
        amdf_pallas(jnp.zeros((1, 1024), jnp.float32), lo=lo)
    with pytest.raises(ValueError):
        K11.amdf(torch.zeros(1, 1024, dtype=torch.int16), lo)


@pytest.mark.parametrize("method", [1, 2, 3])
def test_pitch_run_f64_matches_oracle_and_jax(method):
    x = _speech(512 * 8 + 30, seed=11)
    want = opitch.run(x, method)
    args, vals, f0s = tf.pitch_run(x, method, device="cpu")
    assert len(args) == len(want) and args.dtype == np.int64
    for i, (wa, wv, wf) in enumerate(want):
        assert args[i] == wa, (method, i)
        np.testing.assert_allclose(vals[i], wv, rtol=1e-9)
        np.testing.assert_allclose(f0s[i], wf, rtol=1e-9)
    ja = jf.pitch_run(x, method)
    np.testing.assert_array_equal(args, np.asarray(ja[0]))
    np.testing.assert_array_equal(f0s, np.asarray(ja[2]))
    if method != 1:  # exact integer sums: the values too (method 1's FFTs differ in last bits)
        np.testing.assert_array_equal(vals, np.asarray(ja[1]))


@pytest.mark.parametrize("method", [2, 3])
def test_pitch_mxu_f64_equals_oracle(method):
    """pitch2 through K11 in f64 is the oracle bit for bit (exact sums, one
    IEEE division); method 3's matmul DFT keeps the lags."""
    x = _speech(512 * 9 + 7, seed=12, f0=140.0)
    want = opitch.run(x, method)
    args, vals, f0s = tf.pitch_run(x, method, fft_engine="mxu", device="cpu")
    assert [int(a) for a in args] == [w[0] for w in want]
    if method == 2:
        assert [float(v) for v in vals] == [w[1] for w in want]
        assert [float(f) for f in f0s] == [w[2] for w in want]
    else:
        np.testing.assert_allclose(vals, [w[1] for w in want], rtol=1e-6)


@pytest.mark.parametrize("method,engine", [(1, "mxu"), (1, "mxu3"), (2, "mxu"), (3, "mxu"),
                                           (2, "xla"), (3, "xla")])
def test_pitch_f32_lags_vs_oracle(method, engine):
    """f32 engines keep the oracle's lags on >= 95% of blocks, as
    tests/test_features.py asks of the JAX ones; differing blocks printed."""
    x = _speech(512 * 16, seed=13)
    want = opitch.run(x, method)
    args, vals, _ = tf.pitch_run(x, method, torch.float32, fft_engine=engine, device="cpu")
    assert vals.dtype == np.float32
    differ = [(i, int(args[i]), w[0], float(vals[i]), w[1]) for i, w in enumerate(want)
              if args[i] != w[0]]
    print(f"method {method} {engine}: blocks differing (block, lag, oracle lag, value, oracle "
          f"value) {differ}")
    assert 1 - len(differ) / len(want) >= 0.95


def test_pitch_empty_and_partial_block():
    assert all(len(a) == 0 for a in tf.pitch_run(np.zeros(0, np.int16), 2, device="cpu"))
    for n in (300, 512 + 300):
        x = _speech(n, seed=n)
        want = opitch.run(x, 2)
        args, vals, _ = tf.pitch_run(x, 2, fft_engine="mxu", device="cpu")
        assert [int(a) for a in args] == [w[0] for w in want]
        assert [float(v) for v in vals] == [w[1] for w in want]


def test_silent_frame_picks_lag_101():
    x = np.zeros(2048, np.int16)
    for method in (1, 2, 3):
        args, vals, _ = tf.pitch_run(x, method, fft_engine="mxu", device="cpu")
        assert (args == 101).all() and (vals == 0).all()


# ---- the GMM scorer and speech_classify ----------------------------------------


@pytest.fixture(scope="module")
def trained():
    """Three classes trained by the JAX package's speech_train in f64, as
    tests/test_pipelines.py trains them (C = 3, T = 24)."""
    from jeicyboodsp_tpu.pipelines.speech import speech_train

    rng = np.random.default_rng(5)
    fs, T, C = 16000, 24, 3
    audio = np.zeros((C, T, 1024), np.int16)
    for c in range(C):
        t = np.arange(T * 1024) / fs
        f = 250.0 * (c + 1) * (1 + 0.2 * np.sin(2 * np.pi * 1.3 * t))
        amp = 6000 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t) ** 2)
        x = np.clip(amp * np.sin(2 * np.pi * np.cumsum(f) / fs) + rng.normal(0, 400, len(t)),
                    -32768, 32767)
        audio[c] = x.astype(np.int16).reshape(T, 1024)
    alpha, mean, cov, e8 = speech_train(jnp.asarray(audio), dtype=jnp.float64)
    return audio, (alpha, mean, cov, e8[:, :, :, :4])


@pytest.mark.parametrize("dtype,engine", [(torch.float64, "xla"), (torch.float32, "mxu3"),
                                          (torch.float32, "xla")])
def test_speech_classify_with_a_jax_trained_model(trained, dtype, engine):
    """JAX's models carried across by model_to_port: f64 xla scores within
    rtol 1e-9 of JAX's, f32 within 1e-4 relative; every argmax the class."""
    from jeicyboodsp_tpu.pipelines.speech import speech_classify as jax_classify

    audio, model = trained
    tmodel = TG.model_to_port(*model, "cpu")
    assert tmodel[0].dtype == torch.float64 and tmodel[3].shape == (3, 4, 12, 4)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    for c in range(3):
        want = np.asarray(jax_classify(jnp.asarray(audio[c]), *model, dtype=jd, fft_engine=engine))
        got = speech_classify(torch.from_numpy(audio[c]), *tmodel, dtype=dtype, fft_engine=engine)
        assert got.dtype == torch.float64 and got.shape == (3,)
        got = got.numpy()
        if dtype == torch.float64:
            np.testing.assert_allclose(got, want, rtol=1e-9)
        else:
            assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-4
        assert int(np.argmax(got)) == int(np.argmax(want)) == c


def test_score_frames_matches_oracle_and_jax(trained):
    from jeicyboodsp_tpu.models import gmm as jgmm

    _, (alpha, mean, cov, e4) = trained
    feats = omfcc.run(_speech(8 * 1024, seed=14))
    a, m, cv, e = (np.array(v) for v in (alpha, mean, cov, e4))  # writable copies
    for c in range(3):
        got = float(TG.score_frames(torch.from_numpy(feats), *(torch.from_numpy(v[c])
                                                                for v in (a, m, cv, e))))
        diag = np.stack([np.diagonal(cv[c][k])[:4] for k in range(4)])
        np.testing.assert_allclose(got, ogmm.score_file(feats, a[c], m[c], diag, e[c]), rtol=1e-9)
        np.testing.assert_allclose(got, float(jgmm.score_frames(jnp.asarray(feats), a[c], m[c],
                                                                cv[c], e[c])), rtol=1e-9)


# ---- pipelines and CLI ---------------------------------------------------------


def _wav(tmp_path, name, x):
    path = tmp_path / f"{name}.wav"
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(path)  # 44 bytes that are not samples
    return str(path)


@pytest.mark.parametrize("method", [1, 2, 3])
def test_pitch_pipeline_prints_what_jax_prints(tmp_path, capsys, method):
    """Byte-identical stdout for methods 2 and 3 (exact integer sums); for
    method 1 the same lags and f0, values to 1e-12 (the FFTs' last bits)."""
    from jeicyboodsp_tpu.pipelines import registry as jreg
    from jeicyboodsp_tpu_torch.pipelines import registry as treg

    inp = _wav(tmp_path, "p", _speech(512 * 6 + 200, seed=15))
    jreg.pitch(inp, method)
    want = capsys.readouterr().out
    treg.pitch(inp, method, dtype=torch.float64, device="cpu")
    got = capsys.readouterr().out
    assert len(got.splitlines()) == len(want.splitlines()) == 7
    if method != 1:
        assert got == want
    else:
        for g, w in zip(got.splitlines(), want.splitlines()):
            g, w = g.split(), w.split()
            assert g[:5] == w[:5] and g[6:] == w[6:]
            np.testing.assert_allclose(float(g[5]), float(w[5]), rtol=1e-12)


def test_mfcc_pipeline_matches_jax(tmp_path):
    """The list file's outputs: the first file's first frame skipped, headers
    skipped, f64 little-endian; equal to JAX's to 1e-9 and to the oracle."""
    from jeicyboodsp_tpu.pipelines import registry as jreg
    from jeicyboodsp_tpu_torch.pipelines import registry as treg

    xs = {"a": _speech(3 * 1024 + 100, seed=16), "b": _speech(2 * 1024, seed=17, f0=200.0),
          "e": np.zeros(0, np.int16)}
    ins = {k: _wav(tmp_path, k, x) for k, x in xs.items()}
    for side, reg in (("jax", jreg), ("port", treg)):
        lst = tmp_path / f"{side}.list"
        lst.write_text("".join(f"{ins[k]} {tmp_path / f'{side}_{k}.mfc'}\n" for k in xs)
                       + "malformed line with four\n")
        reg.mfcc(str(lst), **({} if side == "jax" else {"device": "cpu"}))
    for i, k in enumerate(xs):
        got = np.fromfile(tmp_path / f"port_{k}.mfc", "<f8")
        want = np.fromfile(tmp_path / f"jax_{k}.mfc", "<f8")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got, omfcc.run(xs[k], skip_first=i == 0).reshape(-1),
                                   rtol=1e-9, atol=1e-9)


def test_cli_features_on_cpu(tmp_path, capsys):
    from jeicyboodsp_tpu_torch.cli import main

    x = _speech(512 * 5, seed=18)
    inp = _wav(tmp_path, "p", x)
    assert main(["pitch2", inp, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [int(line.split()[2]) for line in lines] == [w[0] for w in opitch.run(x, 2)]
    assert main(["pitch2", inp, "--fast", "--engine", "mxu", "--device", "cpu"]) == 0
    fast = capsys.readouterr().out.splitlines()
    assert [int(line.split()[2]) for line in fast] == [w[0] for w in opitch.run(x, 2)]
    lst = tmp_path / "l.txt"
    lst.write_text(f"{inp} {tmp_path / 'o.mfc'}\n")
    assert main(["mfcc", str(lst), "--fast", "--engine", "mxu8", "--device", "cpu"]) == 0
    got = np.fromfile(tmp_path / "o.mfc", "<f8").reshape(-1, 12)
    assert snr_db(omfcc.run(x), got) >= 100.0


@pytest.mark.parametrize("argv", [
    ["geq", "a", "b", "--fast", "--engine", "xla"],   # geq's --fast takes no engine
    ["pitch1", "a", "--engine", "mxu"],               # an engine needs --fast
    ["pitch2", "a", "--fast", "--engine", "mxu8"],    # not an engine of pitch
    ["mfcc", "a", "--fast", "--engine", "mxu8f"],     # an enhancement engine
    ["wiener", "a", "b", "--engine", "xla"],          # an engine needs --fast
    ["nlms", "a", "b", "c", "d", "--engine", "mxu"],  # nlms takes no engine
    ["pitch3", "a", "b"],                             # one file argument
])
def test_cli_refusals(argv):
    from jeicyboodsp_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2


def test_features_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.pitch_run(np.zeros(600, np.int16), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.mfcc_run(np.zeros(600, np.int16))


# ---- the port's own references (jeicyboodsp_tpu_torch.oracle) and chip_smoke.py's data ----


@pytest.mark.parametrize("skip_first", [True, False])
def test_chip_smoke_mfcc_reference_matches_oracle(skip_first):
    """The port carries its own float64 MFCC reference (chip_smoke.py may not
    import the JAX package); it equals the oracle to 1e-9 with the oracle's
    NaN frames, partial blocks and empty payloads."""
    rng = np.random.default_rng(19)
    x = chip_smoke.speech_signal(6 * 1024 + 300, rng, silent=(1024, 3072))
    M, D = port_omfcc.mfcc_tables()
    assert np.array_equal(M, tf.mel_matrix()) and np.allclose(D, tf.dct_lifter_matrix(), rtol=1e-14)
    for n in (0, 100, 1024, len(x)):
        want = omfcc.run(x[:n], skip_first=skip_first)
        got = port_omfcc.reference_mfcc(x[:n], skip_first=skip_first)
        g, w = _finite_equal_masks(got, want)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", [1, 2, 3])
def test_chip_smoke_pitch_reference_matches_oracle(method):
    rng = np.random.default_rng(20)
    x = chip_smoke.speech_signal(512 * 10 + 77, rng, silent=(1024, 2048))
    for n in (0, 300, len(x)):
        want = opitch.run(x[:n], method)
        lag, val, f0 = port_opitch.reference_pitch(x[:n], method)
        assert [int(v) for v in lag] == [w[0] for w in want]
        np.testing.assert_allclose(val, [w[1] for w in want], rtol=1e-12)
        assert [float(v) for v in f0] == [w[2] for w in want]
        if method != 1:
            assert [float(v) for v in val] == [w[1] for w in want]


def test_chip_smoke_score_reference_and_class_models():
    """The script's scorer equals oracle.gmm.score_file; its class models,
    scored by the port and by the reference, pick every utterance's class."""
    rng = np.random.default_rng(21)
    C = 4
    feats = [port_omfcc.reference_mfcc(chip_smoke.class_signal(c, 16 * 1024, rng), False)
             for c in range(C)]
    model = chip_smoke.class_models(feats)
    utt = [chip_smoke.class_signal(c, 8 * 1024, rng) for c in range(C)]
    tmodel = TG.model_to_port(*model, "cpu")
    for c in range(C):
        f = port_omfcc.reference_mfcc(utt[c], False)
        ref = [port_ogmm.reference_score(f, *(m[j] for m in model)) for j in range(C)]
        for j in range(C):
            diag = np.stack([np.diagonal(model[2][j][k])[:4] for k in range(4)])
            np.testing.assert_allclose(ref[j], ogmm.score_file(f, model[0][j], model[1][j], diag,
                                                               model[3][j]), rtol=1e-12)
        got = speech_classify(torch.from_numpy(utt[c].reshape(-1, 1024)), *tmodel,
                              fft_engine="mxu3").numpy()
        assert int(np.argmax(ref)) == int(np.argmax(got)) == c
        assert np.max(np.abs(got - ref) / np.abs(ref)) <= chip_smoke.SCORE_RTOL
