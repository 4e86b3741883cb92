"""CPU parity of the port's four-step FFT (K12's plain version) and FFT
program (``jeicyboodsp_tpu_torch.ops.fft``) with the JAX package and the
oracle.

Seeded numpy inputs go through the JAX function and its port; the JAX
Pallas kernel runs in interpret mode.  On CPU tensors the K12 wrapper runs
its plain version, so these tests hold the plain version's arithmetic; the
CUDA kernel is held against it in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import contextlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.kernels import fft_pallas as JK
from jeicyboodsp_tpu.oracle import fftprog
from jeicyboodsp_tpu.ops import fft as JF
from jeicyboodsp_tpu.pipelines import registry as jreg
from jeicyboodsp_tpu.utils.cnum import FFT_PI as J_FFT_PI
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.kernels import fft_four_step as K12
from jeicyboodsp_tpu_torch.ops import fft as TF
from jeicyboodsp_tpu_torch.utils.cnum import FFT_PI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (512, 1024, 8192)
FFT_RTOL = 1e-5  # of max |X|, as the JAX package's own test (test_pallas_kernels.py:78-81)
# f32 against the oracle (tests/test_engine_matrix.py:166-176)
FLOORS = {"xla": 68.0, "radix2": 65.0, "fourstep": 65.0}


def _probe(n_blocks):
    """The engine-matrix probe (tests/test_engine_matrix.py:32-37), cut."""
    rng = np.random.default_rng(11)
    t = np.arange(64 * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    x = np.clip(sp + rng.normal(0, 20, 64 * 512), -32768, 32767).astype(np.int16)
    return x[: n_blocks * 512]


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 8000, n), -32768, 32767).astype(np.int16)


def test_constants_copied():
    assert FFT_PI == J_FFT_PI
    assert TF.BLOCK_LEN == fftprog.BLOCK_LEN
    for n in (8, 512, 1024):
        np.testing.assert_array_equal(TF.bitrev_indices(n), fftprog.bitrev_indices(n))


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", SIZES + (96,))
def test_plan_byte_identical(n, forward):
    """_factor and _plan, copies of the JAX package's, in f32 and f64."""
    assert K12._factor(n) == JK._factor(n)
    for dtype in (np.float32, np.float64):
        got, want = K12._plan(n, forward, dtype), JK._plan(n, forward, dtype)
        assert got[:2] == want[:2]
        for g, w in zip(got[2:], want[2:]):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("forward", [True, False], ids=["forward_real", "inverse_complex"])
@pytest.mark.parametrize("n", SIZES)
def test_four_step_vs_jax_and_numpy(n, forward):
    """K12's plain version in f32 against JAX's fft_four_step, the Pallas
    kernel in interpret mode and numpy, each within 1e-5 of max |X|:
    forward on a real input (the zero products skipped), inverse on a
    complex one."""
    rng = np.random.default_rng(n)
    xr = rng.normal(0, 100, (3, n)).astype(np.float32)
    xi = None if forward else rng.normal(0, 100, (3, n)).astype(np.float32)
    jim = jnp.zeros((3, n), jnp.float32) if forward else jnp.asarray(xi)
    z = xr if forward else xr + 1j * xi
    want = {"numpy": np.fft.fft(z) if forward else np.fft.ifft(z) * n}
    r, i = JK.fft_four_step(jnp.asarray(xr), jim, n, forward=forward)
    want["jax four-step"] = np.asarray(r) + 1j * np.asarray(i)
    r, i = JK.fft_pallas(jnp.asarray(xr), jim, n, forward=forward, interpret=True)
    want["jax kernel"] = np.asarray(r) + 1j * np.asarray(i)
    before = K12.fft_pallas.launches
    r, i = K12.fft_pallas(torch.from_numpy(xr), None if forward else torch.from_numpy(xi), n,
                          forward)
    assert K12.fft_pallas.launches == before  # CPU: the plain version, not counted
    assert r.dtype == i.dtype == torch.float32 and r.shape == (3, n)
    got = r.numpy() + 1j * i.numpy()
    for what, w in want.items():
        rel = np.abs(got - w).max() / np.abs(w).max()
        print(f"n={n} forward={forward} vs {what}: {rel:.2e} of max |X|")
        assert rel <= FFT_RTOL, what


def test_four_step_f64_and_roundtrip():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 100, (2, 4, 512)))  # extra batch axes
    Xr, Xi = K12.fft_four_step(x, None, 512, dtype=torch.float64)
    want = np.fft.fft(x.numpy())
    assert Xr.dtype == torch.float64
    assert np.abs(Xr.numpy() + 1j * Xi.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    yr, yi = K12.fft_four_step(Xr, Xi, 512, forward=False, dtype=torch.float64)
    np.testing.assert_allclose(yr.numpy() / 512, x.numpy(), atol=1e-9)


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "im", "device"])
def test_fft_pallas_rejects(bad):
    x = torch.zeros(4, 512)
    im = None
    if bad == "dtype":
        x = x.double()
    elif bad == "width":
        x = x[:, :256]
    elif bad == "rows":
        x = x[:0]
    elif bad == "im":
        im = torch.zeros(3, 512)
    elif bad == "device":
        x = x.to("meta")
    with pytest.raises(ValueError):
        K12.fft_pallas(x, im, 512)


def test_radix2_f64_and_run_stream_vs_oracle():
    """fft_radix2 in f64 and run_stream against oracle/fftprog.run: at most
    one int16 step and >= 70 dB (test_fft_awgn.py:12-24); the integer
    inputs sit on the truncation boundary, so a step's sign is the last
    bits' rounding."""
    x = _noise(512 * 6 + 200, 3)  # a partial last block
    want = fftprog.run(x)
    got = TF.run_stream(x, device="cpu")
    d = want.astype(int) - got.astype(int)
    print(f"run_stream f64 radix2: {int((d != 0).sum())} of {len(d)} samples flipped")
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(d).max() <= 1 and snr_db(want, got) >= 70.0
    b = np.stack([x[:512], x[512:1024]]).astype(np.float64)
    Xr, Xi = TF.fft_radix2(torch.from_numpy(b), torch.zeros(2, 512, dtype=torch.float64))
    for k in range(2):
        np.testing.assert_allclose(Xr[k].numpy() + 1j * Xi[k].numpy(),
                                   fftprog.fft_ref(b[k].astype(np.complex128), True),
                                   rtol=0, atol=1e-9 * np.abs(b[k]).sum())


@pytest.mark.parametrize("engine", sorted(FLOORS))
def test_roundtrip_blocks_f32_floors(engine):
    x = _probe(16)
    want = fftprog.run(x)
    got = TF.roundtrip_blocks(torch.from_numpy(x.reshape(-1, 512)), dtype=torch.float32,
                              engine=engine)
    assert got.dtype == torch.int16 and got.shape == (16, 512)
    snr = snr_db(want, got.reshape(-1).numpy())
    print(f"roundtrip_blocks f32 {engine}: {snr:.2f} dB vs the oracle")
    assert snr >= FLOORS[engine]
    if engine == "radix2":  # JAX's own f32 floor on the same probe
        jgot = np.asarray(JF.roundtrip_blocks(jnp.asarray(x.reshape(-1, 512)), dtype=jnp.float32,
                                              engine=engine)).reshape(-1)
        assert snr_db(want, jgot) >= FLOORS[engine]


@pytest.mark.parametrize("n", [8, 512, 1024])
def test_op_counts(n):
    assert TF.fft_op_counts(n) == JF.fft_op_counts(n)


def _run_pipeline(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        y = fn(*args, **kw)
    return y, out.getvalue()


@pytest.mark.parametrize("n", [512 * 5 + 300, 512, 100, 0])
def test_pipeline_and_cli_vs_jax_registry(tmp_path, n):
    """The ``fft`` pipeline and CLI in f64 (the header skipped) against the
    JAX registry on the same file: the same --verbose lines, and outputs
    within one step (both within one of the oracle; the port's f64 radix2
    equals it here)."""
    from jeicyboodsp_tpu_torch.cli import main
    from jeicyboodsp_tpu_torch.pipelines import registry

    x = _noise(n, n)
    inp = tmp_path / "in.wav"
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(inp)
    yj, sj = _run_pipeline(jreg.fft_roundtrip, str(inp), str(tmp_path / "j.pcm"), verbose=True)
    yt, st = _run_pipeline(registry.fft_roundtrip, str(inp), str(tmp_path / "t.pcm"),
                           verbose=True, device="cpu")
    assert st == sj and st.count("512-point FFT Calculation add 2304 multiply 2048") == 2 * (
        len(yt) // 512)
    got = np.fromfile(tmp_path / "t.pcm", "<i2")
    np.testing.assert_array_equal(got, yt)
    np.testing.assert_array_equal(got, fftprog.run(x))
    assert got.shape == np.asarray(yj).shape
    assert np.abs(got.astype(int) - np.asarray(yj).astype(int)).max(initial=0) <= 1
    _, sc = _run_pipeline(main, ["fft", str(inp), str(tmp_path / "c.pcm"), "--verbose",
                                 "--device", "cpu"])
    assert sc == st
    np.testing.assert_array_equal(np.fromfile(tmp_path / "c.pcm", "<i2"), got)


def test_cli_fast_and_errors(tmp_path):
    """``fft --fast`` is the radix-2 program in f32, held to its floor (as
    the JAX CLI, it has no engine choice); an ``--engine`` is refused."""
    from jeicyboodsp_tpu_torch.cli import main

    x = _probe(6)
    inp = tmp_path / "in.wav"
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(inp)
    out = tmp_path / "fast.pcm"
    assert main(["fft", str(inp), str(out), "--fast", "--device", "cpu"]) == 0
    got = np.fromfile(out, "<i2")
    np.testing.assert_array_equal(got, TF.run_stream(x, torch.float32, device="cpu"))
    assert snr_db(fftprog.run(x), got) >= FLOORS["radix2"]
    for extra in ([], ["--fast"]):  # fft takes no --engine, with or without --fast
        with pytest.raises(SystemExit):
            main(["fft", str(inp), str(tmp_path / "e.pcm"), *extra, "--engine", "xla",
                  "--device", "cpu"])
    with pytest.raises(SystemExit):  # --verbose is fft's only
        main(["geq", str(inp), str(tmp_path / "e.pcm"), "--verbose"])
    with pytest.raises(ValueError):
        TF.roundtrip_blocks(torch.zeros(2, 512, dtype=torch.int16), engine="mxu")


def test_run_stream_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.run_stream(_noise(600, 1))


def test_chip_smoke_reference_matches_oracle():
    """The port's own float64 copy of the FFT program
    (``jeicyboodsp_tpu_torch.oracle``, which chip_smoke.py holds the port to)
    equals oracle/fftprog.run byte for byte."""
    from jeicyboodsp_tpu_torch.oracle import fftprog as port_oracle

    np.testing.assert_array_equal(port_oracle._bitrev(512), fftprog.bitrev_indices(512))
    for n in (0, 100, 512, 512 * 7 + 77):
        x = _noise(n, n + 1)
        np.testing.assert_array_equal(port_oracle.reference_fft_roundtrip(x), fftprog.run(x))
