"""CPU parity of the port's AWGN harness (``jeicyboodsp_tpu_torch.ops.awgn``,
the ``awgn`` pipeline and CLI) with the JAX package (x64).

The two packages draw their noise from different generators (a
``torch.Generator``, a JAX PRNG key), so the noise itself is held to
tests/test_fft_awgn.py's distributional bounds; the int16 arithmetic given a
draw (``add_noise``) is fed JAX's own draws and must equal JAX's
``add_awgn`` to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.ops import awgn as ja
from jeicyboodsp_tpu.pipelines import registry as jreg
from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.ops import awgn as ta

DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def _blocks(seed=0):
    """Full-scale int16 blocks with a near-edge stretch (the wrap)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-32768, 32768, (12, 512)).astype(np.int16)
    b[:4] = 32760
    b[4:6] = -32765
    return b


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("sigma", [10.0, 3000.0])
def test_add_noise_bit_equal_given_jax_draws(dt, sigma):
    """JAX's normal draws (scaled in JAX) through the port's int16
    arithmetic give JAX's add_awgn outputs to the bit, noisy and noise; at
    sigma 3000 the truncation and the short wrap are exercised."""
    tdt, jdt = DTYPES[dt]
    blocks = _blocks()
    key = jax.random.PRNGKey(7)
    draws = np.array(jax.random.normal(key, blocks.shape, jdt) * sigma)
    want_noisy, want_noise = (np.asarray(a) for a in ja.add_awgn(key, jnp.asarray(blocks),
                                                                  sigma=sigma, dtype=jdt))
    noisy, noise = ta.add_noise(torch.from_numpy(blocks), torch.from_numpy(draws))
    assert noisy.dtype == noise.dtype == torch.int16
    assert noisy.numpy().tobytes() == want_noisy.tobytes()
    assert noise.numpy().tobytes() == want_noise.tobytes()
    if sigma > 100:
        assert ((blocks.astype(np.int32) + want_noise) != want_noisy).any()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_autocorrelation_against_jax(dt):
    """autocorrelation_blocks within 1e-9 (f64; 1e-5 in f32) of each row's
    largest |value| of JAX's, and whiteness_ratio likewise."""
    tdt, jdt = DTYPES[dt]
    tol = 1e-9 if dt == "f64" else 1e-5
    blocks = np.random.default_rng(3).normal(0, 1000, (9, 512)).astype(np.int16)
    want = np.asarray(ja.autocorrelation_blocks(jnp.asarray(blocks), dtype=jdt))
    got = ta.autocorrelation_blocks(torch.from_numpy(blocks), dtype=tdt).numpy()
    assert got.shape == want.shape == (9, 512) and got.dtype == want.dtype
    assert (np.abs(got - want) <= tol * np.abs(want).max(1, keepdims=True)).all()
    np.testing.assert_allclose(ta.whiteness_ratio(torch.from_numpy(blocks), tdt).numpy(),
                               np.asarray(ja.whiteness_ratio(jnp.asarray(blocks), jdt)),
                               rtol=tol * 10)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_awgn_statistics_and_wrap(dt):
    """tests/test_fft_awgn.py:38-48 on the port from a seeded generator:
    |mean| < 0.5, 8.5 < std < 11.5, and 32760 + noise > 32767 wraps
    negative; the same seed draws the same noise."""
    tdt, _ = DTYPES[dt]
    blocks = torch.full((20, 512), 32760, dtype=torch.int16)
    noisy, noise = ta.add_awgn(torch.Generator().manual_seed(0), blocks, dtype=tdt)
    n = noise.numpy().astype(np.float64)
    assert abs(n.mean()) < 0.5 and 8.5 < n.std() < 11.5
    assert np.all(noisy.numpy()[n > 7] < 0)
    again, _ = ta.add_awgn(torch.Generator().manual_seed(0), blocks, dtype=tdt)
    assert torch.equal(again, noisy)


def test_awgn_whiteness():
    """tests/test_fft_awgn.py:51-55 on the port: the noise's off-peak
    autocorrelation below 0.25 of its peak for every block after the first."""
    _, noise = ta.add_awgn(torch.Generator().manual_seed(1), torch.zeros(8, 512, dtype=torch.int16))
    ratios = ta.whiteness_ratio(noise).numpy()
    assert ratios[1:].max() < 0.25, ratios


def _wav(path, x):
    with open(path, "wb") as f:
        f.write(b"\0" * 44 + np.asarray(x, "<i2").tobytes())


@pytest.mark.parametrize("fast", [False, True], ids=["f64", "fast-f32"])
def test_awgn_pipeline_and_cli(tmp_path, fast):
    """The awgn CLI: header skipped, whole blocks kept (the partial last one
    dropped, as JAX's pipeline drops it: same output length), the noise
    recovered from the wrap (output - input mod 2^16) within the bounds
    above, seed 0 reproducible; JAX's pipeline writes as many bytes."""
    x = np.random.default_rng(2).normal(0, 3000, 512 * 30 + 77).astype(np.int16)
    x[:512] = 32767
    inp = str(tmp_path / "in.wav")
    _wav(inp, x)
    outs = []
    for k in range(2):
        outs.append(str(tmp_path / f"out{k}.pcm"))
        main(["awgn", inp, outs[-1], "--device", "cpu"] + (["--fast"] if fast else []))
    jout = str(tmp_path / "jax.pcm")
    jreg.awgn(inp, jout)
    got = np.fromfile(outs[0], "<i2")
    assert np.array_equal(got, np.fromfile(outs[1], "<i2"))
    assert len(got) == len(np.fromfile(jout, "<i2")) == 512 * 30
    noise = (got.astype(np.int32) - x[:512 * 30]).astype(np.int16).astype(np.float64)
    assert abs(noise.mean()) < 0.5 and 8.5 < noise.std() < 11.5
    assert (got[:512][noise[:512] > 0] < 0).all()  # 32767 + positive noise wraps
    for bad in (["--verbose"], ["--engine", "xla", "--fast"]):
        with pytest.raises(SystemExit):
            main(["awgn", inp, outs[0], "--device", "cpu"] + bad)


def test_the_port_runs_every_jax_pipeline():
    """With awgn, gmm-train, gmm-test and viterbi the port's registry has
    all 17 of the JAX registry's names, and the CLI knows each one's file
    arguments."""
    from jeicyboodsp_tpu_torch import cli
    from jeicyboodsp_tpu_torch.pipelines import PIPELINES

    assert sorted(PIPELINES) == sorted(jreg.PIPELINES) and len(PIPELINES) == 17
    assert sorted(cli.FILES) == sorted(PIPELINES)
