"""CPU parity of the port's enhancement compat path with the JAX package.

The compat contract of the CLI: ``wiener``/``specsub`` without ``--fast``
run the generic chain in float64 with engine ``xla`` (the framed windowed
FFT, the VAD, the sequential noise scan, trig resynthesis, the OLA), and
the output is the reference's, byte for byte in the JAX package
(tests/test_enhance.py).  The port runs ``torch.fft`` where JAX runs its
own FFT, so it is held to at most one int16 step on under 0.1% of the
samples, and the count is printed.  ``--fast`` runs float32 with engine
``xla`` by default and takes every engine of the JAX CLI.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.oracle import enhance as oenh
from jeicyboodsp_tpu.ops import enhance as JE
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.ops import enhance as TE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("wiener", "specsub")
FLIP_SHARE = 1e-3  # at most one int16 step, on under 0.1% of the samples


def _matrix_probe():
    """The engine matrix's 64-block probe (tests/test_engine_matrix.py:32-37)."""
    rng = np.random.default_rng(11)
    t = np.arange(64 * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(sp + rng.normal(0, 20, 64 * 512), -32768, 32767).astype(np.int16)


def _enhance_signal(seconds=1.5, fs=16000):
    """tests/test_enhance.py's signal, drawn from the suite's seed."""
    rng = np.random.default_rng(20260817)
    n = int(seconds * fs) + 137
    noise = rng.normal(0, 20, n)
    t = np.arange(n) / fs
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (((t > 0.6) & (t < 1.0)) | (t > 1.2))
    return np.clip(noise + speech, -32768, 32767).astype(np.int16)


def _latch_probe():
    """64 blocks whose first 16 are N(0, 50) noise: the VAD calls them noise
    block after block, so the run reaches the 10-frame latch and the noise
    estimate is not zero (N(0, 20) alone truncates to zero runs that read
    as speech)."""
    rng = np.random.default_rng(11)
    t = np.arange(64 * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    noise = rng.normal(0, 20, 64 * 512)
    sp[: 16 * 512] = 0.0
    noise[: 16 * 512] *= 2.5
    return np.clip(sp + noise, -32768, 32767).astype(np.int16)


SIGNALS = {"matrix": _matrix_probe, "enhance": _enhance_signal, "latch": _latch_probe}


@pytest.fixture(scope="module", params=sorted(SIGNALS))
def signal(request):
    return request.param, SIGNALS[request.param]()


def _flips(got, want, what):
    assert got.dtype == np.int16 and got.shape == want.shape, what
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{what}: {int((d > 0).sum())} of {d.size} samples flipped, max |diff| {d.max()}")
    assert d.max() <= 1 and np.mean(d > 0) < FLIP_SHARE, what


@pytest.mark.parametrize("mode", MODES)
def test_f64_xla_vs_oracle(signal, mode):
    name, x = signal
    _flips(TE.run_stream(x, mode, device="cpu"), oenh.run(x, mode), f"{name} {mode} f64 xla")


def test_latch_probe_latches():
    """The latch probe reaches the 10-frame latch, so the scan is exercised."""
    x = _latch_probe()
    speech = TE.vad_flags(torch.from_numpy(x.reshape(-1, 512)), torch.float64)
    cnt, run = TE._run_counts(speech)
    assert int((run & (cnt == TE.NOISE_FRAMES)).sum()) >= 1


@pytest.mark.parametrize("mode,engine,floor", [
    ("wiener", "xla", 95.0), ("wiener", "mxu", 90.0),
    ("specsub", "xla", 95.0), ("specsub", "mxu", 90.0),
])
def test_f32_engine_floor(signal, mode, engine, floor):
    """As the engine matrix asks (tests/test_engine_matrix.py:39-55)."""
    name, x = signal
    want = oenh.run(x, mode)
    got = TE.run_stream(x, mode, dtype=torch.float32, use_assoc_scan=True, fft_engine=engine,
                        device="cpu")
    snr = snr_db(want, got)
    print(f"{name} {mode} f32 {engine}: {snr:.2f} dB")
    assert snr >= floor


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", MODES)
def test_assoc_scan_equals_scan(signal, mode, dtype):
    """Equal in f64, as tests/test_enhance.py:28-32 asks of JAX; in f32 the
    other grouping of the sums may flip a truncation (one step, rarely)."""
    name, x = signal
    a = TE.run_stream(x, mode, dtype=dtype, device="cpu")
    b = TE.run_stream(x, mode, dtype=dtype, use_assoc_scan=True, device="cpu")
    if dtype == torch.float64:
        np.testing.assert_array_equal(a, b)
    else:
        _flips(b, a, f"{name} {mode} f32 assoc vs scan")


def test_noise_scans_match_jax():
    """The sequential scan is JAX's ``_noise_scan`` to the last bit; the
    log-depth one groups its sums otherwise, so it is held within 1e-12."""
    x = _latch_probe()
    blocks = x.reshape(-1, 512)
    speech = np.array(JE.vad_flags(jnp.asarray(blocks)))
    mags = np.abs(np.fft.rfft(np.random.default_rng(3).normal(0, 1e3, (len(blocks), 1024))))
    want = np.array(JE._noise_scan(jnp.asarray(speech), jnp.asarray(mags)))
    sp, m = torch.from_numpy(speech), torch.from_numpy(mags)
    np.testing.assert_array_equal(TE._noise_scan(sp, m).numpy(), want)
    np.testing.assert_allclose(TE._noise_assoc_scan(sp, m).numpy(), want, rtol=1e-12, atol=0)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vad_flags_match_jax(signal, dtype):
    name, x = signal
    blocks = x[: len(x) // 512 * 512].reshape(-1, 512)
    want = np.asarray(JE.vad_flags(jnp.asarray(blocks),
                                   jnp.float64 if dtype == torch.float64 else jnp.float32))
    np.testing.assert_array_equal(TE.vad_flags(torch.from_numpy(blocks), dtype).numpy(), want)


@pytest.mark.parametrize("kw", [
    {},
    {"use_assoc_scan": True},
    {"real_fft": True},
    {"resynth": "ratio", "emit_all": True},
    {"real_fft": True, "resynth": "ratio"},
    {"fft_engine": "mxu3"},
    {"fft_engine": "mxu", "resynth": "ratio"},
], ids=["default", "assoc", "rfft", "ratio_emit_all", "rfft_ratio", "mxu3_trig", "mxu_ratio"])
@pytest.mark.parametrize("mode", MODES)
def test_enhance_blocks_vs_jax_f64(mode, kw):
    """The port's ``enhance_blocks`` against JAX's on the same blocks, in
    float64 (JAX's defaults): within one int16 step on under 0.1%."""
    blocks = _latch_probe().reshape(-1, 512)
    oj, mj = JE.enhance_blocks(jnp.asarray(blocks), mode, **kw)
    ot, mt = TE.enhance_blocks(torch.from_numpy(blocks), mode, **kw)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _flips(ot.numpy(), np.asarray(oj), f"{mode} {kw}")


def test_dft_matrices_byte_identical():
    for got, want in zip(TE._dft_matrices(), JE._dft_matrices()):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_enhance_blocks_signature_is_jax():
    import inspect

    port = inspect.signature(TE.enhance_blocks).parameters
    jax_ = inspect.signature(JE.enhance_blocks).parameters
    assert list(port) == list(jax_)
    for name in ("mode", "use_assoc_scan", "emit_all", "real_fft", "resynth", "fft_engine"):
        assert port[name].default == jax_[name].default, name
    assert port["dtype"].default == torch.float64


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    x = _latch_probe()[: 40 * 512 + 300]  # a partial last block
    x.tofile(work / "in.pcm")
    return work, x


@pytest.mark.parametrize("mode", MODES)
def test_cli_default_is_f64_xla(cli_files, mode):
    """The port's default command against the oracle and against the JAX
    CLI's default command, run in a subprocess: the JAX CLI turns x64 on
    globally, which must not leak into this worker."""
    work, x = cli_files
    out = work / f"port_{mode}.pcm"
    assert main([mode, str(work / "in.pcm"), str(out), "--device", "cpu"]) == 0
    got = np.fromfile(out, "<i2")
    _flips(got, oenh.run(x, mode), f"CLI {mode} vs oracle")
    jout = work / f"jax_{mode}.pcm"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-m", "jeicyboodsp_tpu.cli", mode, str(work / "in.pcm"),
                    str(jout)], cwd=ROOT, env=env, check=True, capture_output=True, timeout=600)
    _flips(got, np.fromfile(jout, "<i2"), f"CLI {mode} vs the JAX CLI")


@pytest.mark.parametrize("engine", ["mxu8f", "xla"])
def test_cli_fast_engine(cli_files, engine):
    """``--fast --engine E`` runs float32 with engine E (``xla`` the default),
    as ``enhance_blocks`` with ratio resynthesis and the real FFT for an
    ``mxu*`` engine."""
    from jeicyboodsp_tpu_torch.io.wav import stale_blocks

    work, x = cli_files
    out = work / f"fast_{engine}.pcm"
    argv = ["wiener", str(work / "in.pcm"), str(out), "--fast", "--device", "cpu"]
    assert main(argv + (["--engine", engine] if engine != "xla" else [])) == 0
    mxu = engine.startswith("mxu")
    want, mask = TE.enhance_blocks(torch.from_numpy(stale_blocks(x, 512)), "wiener",
                                   dtype=torch.float32, real_fft=mxu,
                                   resynth="ratio" if mxu else "trig", fft_engine=engine)
    np.testing.assert_array_equal(np.fromfile(out, "<i2"), want[mask].reshape(-1).numpy())


@pytest.mark.parametrize("argv", [
    ["wiener", "a", "b", "--engine", "mxu8f"],      # an engine needs --fast
    ["specsub", "a", "b", "--engine", "xla"],
    ["wiener", "a", "b", "--fast", "--engine", "gemm8"],  # a fastconv engine
])
def test_cli_engine_refusals(argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
