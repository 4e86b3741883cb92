"""CPU parity of the port's fast convolution (``jeicyboodsp_tpu_torch.ops.
fastconv``) with the JAX package and the oracle.

Seeded numpy inputs of 12-16 blocks of 1024 go through the JAX op and its
port.  On CPU tensors the four-step engines run K12's plain version; the
CUDA kernel is held against it in tests/test_torch_cuda.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.oracle import fastconv as ofc
from jeicyboodsp_tpu.ops import fastconv as JFC
from jeicyboodsp_tpu.pipelines import registry as jreg
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.ops import fastconv as FC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 engines against the oracle: the floors of tests/test_engine_matrix.py:134-163; mxu, like
# mxu3, is the same f32 four-step transform here
FLOORS = {"xla": 88.0, "gemm": 95.0, "gemm8": 70.0, "gemm8hq": 85.0, "mxu": 88.0,
          "mxu3": 88.0, "auto": 85.0}
F64_FLIPPED = 3e-3  # f64 engines: FFT rounding flips of one step (test_fastconv.py:16-25)


def _signal(n=1024 * 12 + 77, seed=7):
    """tests/test_fastconv.py's probe: a 440 Hz tone over N(0, 1000)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 4000 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 1000, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _probe(n_blocks=16):
    """The engine-matrix probe (tests/test_engine_matrix.py:32-37), cut."""
    rng = np.random.default_rng(11)
    t = np.arange(64 * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    x = np.clip(sp + rng.normal(0, 20, 64 * 512), -32768, 32767).astype(np.int16)
    return x[: n_blocks * 1024]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_constants_and_rir_copied():
    for k in ("BLOCK_SIZE", "FFT_SIZE", "FILTER_LENGTH", "WARMUP_BLOCKS"):
        assert getattr(FC, k) == getattr(ofc, k)
    assert _same(FC.load_rir(), ofc.load_rir())
    assert FC._sparse_taps() == JFC._sparse_taps()
    for real_fft in (False, True):
        for td, jd in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
            for g, w in zip(FC.filter_spectrum(dtype=td, real_fft=real_fft),
                            JFC.filter_spectrum(dtype=jd, real_fft=real_fft)):
                assert _same(g, w)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_toeplitz_matrix_byte_identical(name):
    assert _same(FC._toeplitz_matrix(name), JFC._toeplitz_matrix(name))


def test_toeplitz_int8_byte_identical():
    for g, w in zip(FC._toeplitz_int8(), JFC._toeplitz_int8()):
        assert _same(g, w)


@pytest.mark.parametrize("engine", ["xla", "sparse", "gemm"])
def test_f64_engines_vs_oracle(engine):
    """f64: one int16 step at most, on under 0.3% of the samples: the
    FFTs' and sums' last bits decide truncations (test_fastconv.py)."""
    x = _signal()
    want = ofc.run(x)
    if engine == "sparse":
        got = FC.fastconv_blocks_sparse(torch.from_numpy(x[: 12 * 1024].reshape(-1, 1024)),
                                        dtype=torch.float64).reshape(-1).numpy()
        want = ofc.run(x[: 12 * 1024])
    else:
        got = FC.run_stream(x, dtype=torch.float64, fft_engine=engine, device="cpu")
    d = want.astype(int) - got.astype(int)
    print(f"f64 {engine}: {int((d != 0).sum())} of {len(d)} flipped, {snr_db(want, got):.2f} dB")
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(d).max() <= 1 and (d != 0).mean() < F64_FLIPPED


@pytest.mark.parametrize("engine", sorted(FLOORS))
def test_f32_engine_floors(engine):
    x = _probe()
    want = ofc.run(x)
    got = FC.run_stream(x, dtype=torch.float32, real_fft=True, fft_engine=engine, device="cpu")
    snr = snr_db(want, got)
    print(f"f32 {engine}: {snr:.2f} dB vs the oracle (floor {FLOORS[engine]})")
    assert got.shape == want.shape and snr >= FLOORS[engine]


def test_sparse_f32_floor():
    x = _probe()
    got = FC.fastconv_blocks_sparse(torch.from_numpy(x.reshape(-1, 1024)), dtype=torch.float32)
    assert got.dtype == torch.int16 and got.shape == (9, 1024)
    assert snr_db(ofc.run(x), got.reshape(-1).numpy()) >= 95.0


@pytest.mark.parametrize("terms", [2, 3])
def test_int8_dot_planes_exact(terms):
    """The int32 dot planes of gemm8 / gemm8hq equal the same dots in numpy
    int64, the data split x = 256h + l + 128 is exact, and no dot passes
    int32."""
    x = _signal(seed=3)[: 12 * 1024]
    x[9 * 1024: 9 * 1024 + 8] = [-32768, 32767, -32768, 32767, -1, 0, 1, -129]
    blocks = x.reshape(-1, 1024)
    got = FC.int8_dots(torch.from_numpy(blocks), terms)
    assert len(got) == 2 + terms and all(g.dtype == torch.int32 for g in got)
    xe = blocks.astype(np.int64)
    xe[:7] = 0
    h = xe >> 8
    lo = xe - 256 * h - 128
    assert h.min() >= -128 and h.max() <= 127 and lo.min() >= -128 and lo.max() <= 127
    seg = lambda v: np.concatenate([v[i: i + 5] for i in range(8)], axis=1)  # noqa: E731
    Mh, Ml, Mm = (m.astype(np.int64) for m in FC._toeplitz_int8()[:3])
    pairs = [(h, Mh), (lo, Mh), (h, Ml), (lo, Ml), (h, Mm)][: 2 + terms]
    for g, (a, m) in zip(got, pairs):
        want = seg(a) @ m
        assert np.abs(want).max() < 2 ** 31
        np.testing.assert_array_equal(g.numpy(), want)


def test_mxu_close_to_f64_xla():
    """The four-step engine against JAX's f64 FFT route: >= 60 dB and one
    step at most (test_fastconv.py:65-82)."""
    rng = np.random.default_rng(4)
    x = np.clip(rng.normal(0, 1500, 1024 * 12), -32768, 32767).astype(np.int16)
    b = x.reshape(-1, 1024)
    want = np.asarray(JFC.fastconv_blocks(jnp.asarray(b), *JFC.filter_spectrum(dtype=jnp.float64),
                                          dtype=jnp.float64))
    got = FC.fastconv_blocks_mxu(torch.from_numpy(b), *FC.filter_spectrum(dtype=torch.float32))
    got = got.numpy()
    assert snr_db(want.reshape(-1), got.reshape(-1)) >= 60.0
    assert np.abs(want.astype(np.int64) - got.astype(np.int64)).max() <= 1


def test_warmup_empty_partial_and_short():
    """The warm-up blocks never reach the output, an empty payload and T <= 7
    give nothing, a partial final block keeps the stale tail: as the oracle."""
    x = _signal()
    x2 = x.copy()
    x2[: 7 * 1024] = 1234
    for engine in ("xla", "gemm8hq"):
        dtype = torch.float64 if engine == "xla" else torch.float32
        run = lambda v: FC.run_stream(v, dtype=dtype, fft_engine=engine, device="cpu")  # noqa: E731
        np.testing.assert_array_equal(run(x), run(x2))
        for n in (0, 300, 7 * 1024, 6 * 1024 + 5):
            assert run(x[:n]).shape == ofc.run(x[:n]).shape == (0,)
        for n in (7 * 1024 + 1, 9 * 1024 + 300):
            want, got = ofc.run(x[:n]), run(x[:n])
            assert got.shape == want.shape == (-(-n // 1024) * 1024 - 7 * 1024,)
            assert np.abs(want.astype(int) - got.astype(int)).max() <= 1


@pytest.mark.parametrize("fast", [None, "gemm8hq", "mxu"])
def test_pipeline_and_cli_vs_jax_registry(tmp_path, fast):
    """The ``fastconv`` pipeline (the header skipped) and the CLI against the
    JAX registry on the same file: f64 compat within one step on under 0.3%
    of the samples (two FFT libraries), the f32 engines at their floors
    against the oracle, as JAX's."""
    from jeicyboodsp_tpu_torch.cli import main
    from jeicyboodsp_tpu_torch.pipelines import registry

    x = _signal()
    inp = tmp_path / "in.wav"
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(inp)
    kw_t = {"dtype": torch.float32, "fft_engine": fast} if fast else {}
    kw_j = {"dtype": jnp.float32, "fft_engine": fast} if fast else {}
    yj = np.asarray(jreg.fastconv(str(inp), str(tmp_path / "j.pcm"), **kw_j))
    yt = registry.fastconv(str(inp), str(tmp_path / "t.pcm"), device="cpu", **kw_t)
    got = np.fromfile(tmp_path / "t.pcm", "<i2")
    np.testing.assert_array_equal(got, yt)
    assert got.shape == yj.shape
    want = ofc.run(x)
    if fast:
        assert snr_db(want, got) >= FLOORS[fast] and snr_db(want, yj) >= FLOORS[fast]
    else:
        d = got.astype(int) - yj.astype(int)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < F64_FLIPPED
    args = ["fastconv", str(inp), str(tmp_path / "c.pcm"), "--device", "cpu"]
    assert main(args + (["--fast", "--engine", fast] if fast else [])) == 0
    np.testing.assert_array_equal(np.fromfile(tmp_path / "c.pcm", "<i2"), got)


def test_cli_default_fast_engine_and_errors(tmp_path):
    from jeicyboodsp_tpu_torch.cli import main

    x = _probe()
    inp = tmp_path / "in.wav"
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(inp)
    assert main(["fastconv", str(inp), str(tmp_path / "a.pcm"), "--fast", "--device", "cpu"]) == 0
    want = FC.run_stream(x, dtype=torch.float32, fft_engine="gemm8hq", device="cpu")
    np.testing.assert_array_equal(np.fromfile(tmp_path / "a.pcm", "<i2"), want)
    with pytest.raises(SystemExit):  # --engine needs --fast
        main(["fastconv", str(inp), str(tmp_path / "e.pcm"), "--engine", "gemm"])
    with pytest.raises(SystemExit):  # not a fastconv engine
        main(["fastconv", str(inp), str(tmp_path / "e.pcm"), "--fast", "--engine", "mxu8"])
    with pytest.raises(ValueError):
        FC.run_stream(x, fft_engine="sparse", device="cpu")


def test_run_stream_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FC.run_stream(_signal())


def test_port_fastconv_reference_matches_oracle():
    """The port's own float64 overlap-save (``jeicyboodsp_tpu_torch.oracle``,
    which the card tests hold the port to) equals oracle/fastconv.run byte
    for byte."""
    from jeicyboodsp_tpu_torch.oracle import fastconv as port_oracle

    for n in (0, 7 * 1024, 7 * 1024 + 1, 12 * 1024 + 77, 16 * 1024):
        x = _signal(n, seed=n + 1)
        np.testing.assert_array_equal(port_oracle.reference_fastconv(x), ofc.run(x))
