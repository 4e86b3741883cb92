"""CPU parity of the port's MVDR beamformer (``jeicyboodsp_tpu_torch.ops.mvdr``,
the inverse matmul DFTs of ``ops.dft``, the ``mvdr`` pipeline and CLI) with
the f64 oracle and the JAX package.

tests/test_mvdr.py's cases run on the port with that file's bounds against
``oracle/mvdr.run``; the port is also held against JAX's ``mvdr_blocks``
per dtype and engine (f64 within one step on under 1% of the samples, f32
>= 60 dB).  No kernel runs on this path: its transforms are ``torch.fft`` or
matmuls, as they are plain XLA in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.oracle import mvdr as omv
from jeicyboodsp_tpu.ops import dft as jdft
from jeicyboodsp_tpu.ops import mvdr as jmv
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.ops import dft as tdft
from jeicyboodsp_tpu_torch.ops import mvdr as tmv
from jeicyboodsp_tpu_torch.oracle import mvdr as port_omv


F64_FLIPS = 0.01  # one int16 step, on under 1% of the samples (tests/test_mvdr.py)


def _stereo(n=512 * 14 + 100, seed=0):
    """tests/test_mvdr.py's pair: a gated 400 Hz tone, 0.8x on the right,
    over N(0, 15) on each channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    speech = 6000 * np.sin(2 * np.pi * 400 * t) * (((t > 0.12) & (t < 0.2)) | (t > 0.3))
    xl = np.clip(speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    xr = np.clip(0.8 * speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    return xl, xr


def _within_one(want, got, share=F64_FLIPS, what=""):
    assert want.shape == got.shape and got.dtype == np.int16
    d = want.astype(np.int64) - got.astype(np.int64)
    print(f"{what}: {int((d != 0).sum())} of {d.size} samples differ, max |diff| "
          f"{np.abs(d).max(initial=0)}")
    assert np.abs(d).max(initial=0) <= 1 and (d != 0).mean() < share


def test_constants_equal_the_oracle():
    for k in ("BLOCK_LEN", "KEEP_LEN", "FFT_LEN", "THRESHOLD_OF_ENERGY", "SAMPLING_RATE",
              "SPEED_OF_SOUND", "DISTANCE_OF_MIC"):
        assert getattr(tmv, k) == getattr(omv, k) and type(getattr(tmv, k)) is type(
            getattr(omv, k)), k
    for a in (0.0, 0.3, -1.1):
        assert tmv.steering_delay(a) == jmv.steering_delay(a)


@pytest.mark.parametrize("n", [512, 1024])
def test_inverse_dft_mats_byte_identical(n):
    for fn in ("_irdft_mats", "_icdft_real_mats"):
        for w, g in zip(getattr(jdft, fn)(n), getattr(tdft, fn)(n)):
            assert w.dtype == g.dtype == np.float32 and w.tobytes() == g.tobytes(), fn


def test_matmul_dfts_against_numpy():
    x = np.random.default_rng(2).normal(0, 1e3, (3, 1024))
    re, im = tdft.cdft_of_real_full(torch.from_numpy(x))
    X = np.fft.fft(x)
    scale = np.abs(X).max()
    assert np.abs(re.numpy() - X.real).max() < 1e-6 * scale
    assert np.abs(im.numpy() - X.imag).max() < 1e-6 * scale
    Y = X * np.exp(1j * np.random.default_rng(3).uniform(0, 6, 1024))  # not Hermitian
    y = tdft.icdft_real(torch.from_numpy(Y.real.copy()), torch.from_numpy(Y.imag.copy()))
    assert np.abs(y.numpy() - np.fft.ifft(Y).real).max() < 1e-6 * np.abs(x).max()
    h = np.fft.rfft(x)
    back = tdft.irdft(torch.from_numpy(h.real.copy()), torch.from_numpy(h.imag.copy()), 1024)
    assert np.abs(back.numpy() - x).max() < 1e-6 * np.abs(x).max()
    jre, jim = jdft.full_from_half(*jdft.rdft(jnp.asarray(x), precision=None))
    tre, tim = tdft.full_from_half(*tdft.rdft(torch.from_numpy(x)))
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), rtol=1e-12, atol=1e-6)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), rtol=1e-12, atol=1e-6)


def test_f64_within_one_step_of_oracle():
    xl, xr = _stereo()
    _within_one(omv.run(xl, xr), tmv.run_stream(xl, xr, device="cpu"), what="f64 xla vs oracle")


@pytest.mark.parametrize("engine,collapse", [("xla", True), ("mxu3", True), ("mxu3", False),
                                             ("mxu", False)])
def test_f32_snr(engine, collapse):
    """f32 xla, and the matmul engines through the collapse and the spectral
    path, >= 60 dB of the oracle (tests/test_mvdr.py:29-42)."""
    xl, xr = _stereo()
    want = omv.run(xl, xr)
    got = tmv.run_stream(xl, xr, dtype=torch.float32, fft_engine=engine, collapse=collapse,
                         device="cpu")
    print(f"f32 {engine} collapse={collapse}: {snr_db(want, got):.2f} dB")
    assert snr_db(want, got) >= 60.0


def test_all_speech_input_is_zero_output():
    """Without noise frames R stays singular -> NaN weights -> zeros."""
    t = np.arange(512 * 6) / 16000
    loud = np.clip(20000 * np.sin(2 * np.pi * 500 * t), -32768, 32767).astype(np.int16)
    for kw in ({}, {"dtype": torch.float32, "fft_engine": "mxu3"}):
        out = tmv.run_stream(loud, loud, device="cpu", **kw)
        assert len(out) == 5 * 512 and np.all(out == 0)


def test_collapse_matches_oracle_lsb():
    """The theta = 0 structural collapse against the oracle's full spectral
    round trip: one step on under 1% of the samples and >= 90 dB (the TPU
    check mvdr_collapse_lsb_exact, utils/tpu_checks.py:150-166)."""
    xl, xr = _stereo(512 * 40 + 256)
    want = omv.run(xl, xr)
    got = tmv.run_stream(xl, xr, dtype=torch.float32, fft_engine="mxu3", device="cpu")
    _within_one(want, got, what="mxu3 collapse vs oracle")
    assert snr_db(want, got) >= 90.0


def test_collapse_equals_spectral_mxu3():
    xl, xr = _stereo(512 * 24)
    a = tmv.run_stream(xl, xr, dtype=torch.float32, fft_engine="mxu3", collapse=True, device="cpu")
    b = tmv.run_stream(xl, xr, dtype=torch.float32, fft_engine="mxu3", collapse=False,
                       device="cpu")
    _within_one(b, a, share=0.05, what="collapse vs spectral mxu3")


def test_off_diagonal_correlation_is_roundoff():
    """The Parseval argument on the port's transforms: the broadband r01 of
    real blocks is roundoff beside the channel energies."""
    xl, xr = _stereo(512 * 16)
    bl, br = (torch.from_numpy(x.reshape(-1, 512)) for x in (xl, xr))
    L = tmv._spectrum(tmv._pairs(bl, torch.float64), torch.complex128, "xla")
    R = tmv._spectrum(tmv._pairs(br, torch.float64), torch.complex128, "xla")
    r00 = (L[0] ** 2 + L[1] ** 2).sum(1)
    r11 = (R[0] ** 2 + R[1] ** 2).sum(1)
    r01 = (-L[0] * R[1] + L[1] * R[0]).sum(1)
    assert float((r01.abs() / ((r00 * r11).sqrt() + 1e-30)).max()) < 1e-10


def test_nonzero_steering_delay_matches_oracle():
    xl, xr = _stereo(512 * 10)
    dt = tmv.steering_delay(0.3)
    _within_one(omv.run(xl, xr, d_time=dt), tmv.run_stream(xl, xr, d_time=dt, device="cpu"),
                what="steering 0.3 vs oracle")


@pytest.mark.parametrize("dtype,engine,collapse,d_time", [
    (torch.float64, "xla", True, 0.0),
    (torch.float64, "mxu3", False, 0.0),
    (torch.float64, "xla", True, 0.3),
    (torch.float32, "xla", True, 0.0),
    (torch.float32, "mxu3", True, 0.0),
    (torch.float32, "mxu3", False, 0.0),
    (torch.float32, "mxu", True, 0.3),
])
def test_mvdr_blocks_vs_jax(dtype, engine, collapse, d_time):
    """The port's mvdr_blocks against JAX's on the same blocks (its mxu
    engines at their TPU precision tiers there, full f32 here)."""
    xl, xr = _stereo(512 * 20, seed=4)
    bl, br = xl.reshape(-1, 512), xr.reshape(-1, 512)
    dt = tmv.steering_delay(d_time)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    want, wmask = jmv.mvdr_blocks(jnp.asarray(bl), jnp.asarray(br), dt, dtype=jd,
                                  fft_engine=engine, collapse=collapse)
    got, mask = tmv.mvdr_blocks(torch.from_numpy(bl), torch.from_numpy(br), dt, dtype=dtype,
                                fft_engine=engine, collapse=collapse)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    want, got = np.asarray(want)[1:].reshape(-1), got.numpy()[1:].reshape(-1)
    if dtype == torch.float64:
        _within_one(want, got, what=f"f64 {engine} vs JAX")
    else:
        print(f"f32 {engine} collapse={collapse} vs JAX: {snr_db(want, got):.2f} dB")
        assert snr_db(want, got) >= 60.0


def test_reference_mvdr_byte_equal_to_oracle():
    """The port's own f64 copy of the oracle (``jeicyboodsp_tpu_torch.oracle``),
    which the card's run holds the port to."""
    xl, xr = _stereo(512 * 12 + 77, seed=5)
    for dt in (0.0, tmv.steering_delay(0.3)):
        want = omv.run(xl, xr, d_time=dt)
        got = port_omv.reference_mvdr(xl, xr, d_time=dt)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert port_omv.reference_mvdr(xl[:0], xr).size == 0


def test_pipeline_and_cli(tmp_path):
    """Both headers skipped; a partial last block keeps the stale tail; the
    shorter channel sets the length, and both are cut to it before they are
    blocked, as JAX's run_stream cuts them (the oracle reads the longer
    channel's own samples into its last block: ROADMAP R13); the CLI runs
    f64 xla unless --fast."""
    xl, xr = _stereo(512 * 9 + 200, seed=6)
    xr = xr[:-50]
    hdr = np.arange(22, dtype=np.int16)
    for name, x in (("l", xl), ("r", xr)):
        np.concatenate([hdr, x]).tofile(tmp_path / f"{name}.wav")
    args = [str(tmp_path / "l.wav"), str(tmp_path / "r.wav")]
    assert main(["mvdr", *args, str(tmp_path / "o.pcm"), "--device", "cpu"]) == 0
    got = np.fromfile(tmp_path / "o.pcm", "<i2")
    want = omv.run(xl[: len(xr)], xr)
    _within_one(want, got, what="mvdr CLI vs oracle")
    want = np.asarray(jmv.run_stream(xl, xr))
    _within_one(want, got, what="mvdr CLI vs JAX")
    assert main(["mvdr", *args, str(tmp_path / "f.pcm"), "--fast", "--engine", "mxu3",
                 "--device", "cpu"]) == 0
    fast = np.fromfile(tmp_path / "f.pcm", "<i2")
    np.testing.assert_array_equal(fast, tmv.run_stream(xl, xr, dtype=torch.float32,
                                                       fft_engine="mxu3", device="cpu"))
    assert tmv.run_stream(xl[:0], xr, device="cpu").size == 0
    with pytest.raises(SystemExit):
        main(["mvdr", *args, str(tmp_path / "x.pcm"), "--engine", "mxu3"])  # needs --fast
