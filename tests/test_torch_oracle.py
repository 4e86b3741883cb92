"""The port's float64 references, ``jeicyboodsp_tpu_torch.oracle``, against
the JAX package's ``jeicyboodsp_tpu.oracle``: one module per JAX module,
numpy only, and each program's ``run`` equal to JAX's byte for byte (MFCC
and pitch method 1's values to 1e-9 and 1e-12: their FFTs and sums run
vectorized, in another order than the oracles' block loops)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from jeicyboodsp_tpu import oracle as JO
from jeicyboodsp_tpu.oracle import enhance as je, fastconv as jfc, fftprog as jfft, geq as jgeq
from jeicyboodsp_tpu.oracle import gmm as jgmm, lpc as jlpc, mfcc as jmfcc, mvdr as jmvdr
from jeicyboodsp_tpu.oracle import nlms as jnlms, pitch as jpitch, viterbi as jvit
from jeicyboodsp_tpu_torch.oracle import enhance as te, fastconv as tfc, fftprog as tfft
from jeicyboodsp_tpu_torch.oracle import geq as tgeq, gmm as tgmm, lpc as tlpc, mfcc as tmfcc
from jeicyboodsp_tpu_torch.oracle import mvdr as tmvdr, nlms as tnlms, pitch as tpitch
from jeicyboodsp_tpu_torch.oracle import viterbi as tvit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("enhance", "geq", "nlms", "mvdr", "fastconv", "pitch", "mfcc", "lpc", "fftprog",
           "gmm", "viterbi")


def _signal(n, seed, silent=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = (6000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.9 * t) > 0.1)
         + 2000 * np.sin(2 * np.pi * 127 * t) + rng.normal(0, 200, n))
    x = np.clip(x, -32768, 32767).astype(np.int16)
    if silent:
        x[silent[0]:silent[1]] = 0
    return x


def _same_bytes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_one_module_per_jax_module_numpy_only():
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.dirname(JO.__file__))
                       if f.endswith(".py") and f != "__init__.py")
    assert jax_names == sorted(MODULES)
    code = ("import sys\n" + "".join(f"import jeicyboodsp_tpu_torch.oracle.{m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', "
              "'jeicyboodsp_tpu') or m.startswith('jeicyboodsp_tpu_torch.') and not "
              "m.startswith('jeicyboodsp_tpu_torch.oracle')]\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("n", [0, 100, 1024, 2500])
def test_stale_blocks_matches_jax(n, block):
    from jeicyboodsp_tpu.ops.nlms import _blockify
    from jeicyboodsp_tpu_torch.oracle.cnum import stale_blocks

    x = np.arange(1, n + 1, dtype=np.int16)
    _same_bytes(stale_blocks(x, block), np.asarray(_blockify(x, block)))


@pytest.mark.parametrize("mode", ["wiener", "specsub"])
@pytest.mark.parametrize("n", [0, 300, 512 * 30 + 77])
def test_enhance_run(mode, n):
    x = _signal(n, 1, silent=(1024, 8192))
    _same_bytes(te.run(x, mode), je.run(x, mode))


@pytest.mark.parametrize("gains,compat", [(jgeq.GAINS_DB, True), (jgeq.GAINS_DB, False),
                                          ((-6.0, 3.0, -3.0, 6.0, -12.0, 12.0, 1.0), True)])
def test_geq_run(gains, compat):
    x = np.concatenate([_signal(1500, 2),
                        np.random.default_rng(2).integers(-32768, 32768, 700).astype(np.int16)])
    _same_bytes(tgeq.run(x, gains, compat), jgeq.run(x, gains, compat))
    for got, want in zip(tgeq.calc_coefficients(gains, compat=compat),
                         jgeq.calc_coefficients(gains, compat=compat)):
        _same_bytes(got, want)


@pytest.mark.parametrize("n", [0, 1024, 3 * 1024 + 200])
def test_nlms_runs(n):
    x = _signal(n, 3)
    echo = np.convolve(np.concatenate([x, [0]]).astype(np.float64), [0.5, 0.2, -0.1])[:n]
    ref = np.clip(echo + np.random.default_rng(3).normal(0, 50, n),
                  -32768, 32767).astype(np.int16)
    for got, want in ((tnlms.run_nlms(x, ref), jnlms.run_nlms(x, ref)),
                      (tnlms.run_bnlms(x, ref), jnlms.run_bnlms(x, ref))):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_bytes(g, w)


@pytest.mark.parametrize("d_time", [0.0, 0.3 * 800.0 / 34000.0])
def test_mvdr_run(d_time):
    xl = _signal(512 * 14 + 100, 4)
    xr = np.clip(0.8 * xl + np.random.default_rng(4).normal(0, 15, len(xl)),
                 -32768, 32767).astype(np.int16)
    _same_bytes(tmvdr.run(xl, xr, d_time), jmvdr.run(xl, xr, d_time))


@pytest.mark.parametrize("n", [0, 7 * 1024, 11 * 1024 + 33])
def test_fastconv_run(n):
    x = _signal(n, 5)
    _same_bytes(tfc.run(x), jfc.run(x))
    h = np.random.default_rng(5).normal(0, 0.1, 300)
    _same_bytes(tfc.run(x, h), jfc.run(x, h))
    _same_bytes(tfc.load_rir(), jfc.load_rir())


@pytest.mark.parametrize("method", [1, 2, 3])
def test_pitch_run(method):
    x = _signal(512 * 9 + 41, 6, silent=(1024, 2048))
    got, want = tpitch.run(x, method), jpitch.run(x, method)
    assert [g[0] for g in got] == [int(w[0]) for w in want]
    assert [g[2] for g in got] == [float(w[2]) for w in want]
    if method == 1:
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-12)
    else:
        assert [g[1] for g in got] == [float(w[1]) for w in want]
    assert tpitch.run(x[:0], method) == jpitch.run(x[:0], method) == []


@pytest.mark.parametrize("skip_first", [True, False])
def test_mfcc_run(skip_first):
    x = _signal(1024 * 6 + 300, 7, silent=(2048, 4096))
    got, want = tmfcc.run(x, skip_first), jmfcc.run(x, skip_first)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [0, 256 * 9 + 10])
def test_lpc_run(n):
    x = _signal(n, 8)
    _same_bytes(tlpc.run(x), jlpc.run(x))


@pytest.mark.parametrize("n", [0, 512 * 5 + 3])
def test_fftprog_run(n):
    x = _signal(n, 9)
    _same_bytes(tfft.run(x), jfft.run(x))
    _same_bytes(tfft._bitrev(256), jfft.bitrev_indices(256))


def _frames(seed, n=96):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (4, 12))
    return centers[(np.arange(n) // 4) % 4] + rng.normal(0, 0.5, (n, 12))


def test_gmm_steps():
    f1, f2 = _frames(10), _frames(11, 64)
    for got, want in zip(tgmm.reference_kmeans(f1, f1[0:16:4].copy()),
                         jgmm.kmeans(f1, f1[0:16:4].copy())):
        _same_bytes(got, want)
    got, want = tgmm.reference_train_class([f1, f2]), jgmm.train_class([f1, f2])
    for k in ("alpha", "mean", "cov", "eigvec"):
        _same_bytes(getattr(got, k), getattr(want, k))
    d4 = np.stack([np.diag(c)[:4] for c in want.cov])
    _same_bytes(tgmm.reference_score_file(f2, want.alpha, want.mean, d4, want.eigvec[..., :4]),
                jgmm.score_file(f2, want.alpha, want.mean, d4, want.eigvec[..., :4]))


def test_viterbi_decode():
    p = jgmm.train_class([_frames(12)])
    d4 = np.stack([np.diag(c)[:4] for c in p.cov])
    states = [(p.alpha, p.mean, d4 * (1 + 0.1 * m), p.eigvec[..., :4]) for m in range(6)]
    trans = np.full((6, 6), 0.1) + 0.4 * np.eye(6)
    obs = _frames(13, 40)
    _same_bytes(tvit.reference_gmm_emission(obs[3], *states[2]),
                jvit.gmm_emission(obs[3], *states[2]))
    gp, gs = tvit.reference_hmm_decode(obs, states, trans)
    wp, ws = jvit.hmm_decode(obs, states, trans)
    _same_bytes(gp, wp)
    _same_bytes(np.float64(gs), np.float64(ws))
