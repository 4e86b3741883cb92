"""The port's LPC (``jeicyboodsp_tpu_torch.ops.features``: ``hamming``,
``lpc_frames``, ``lpc_run``) against ``oracle/lpc.py`` and the JAX op, and
the port's float64 copy of the oracle (``jeicyboodsp_tpu_torch.oracle.lpc``,
which the card tests hold the port to)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.oracle import lpc as olpc
from jeicyboodsp_tpu.ops import features as JF
from jeicyboodsp_tpu_torch.ops import features as TF
from jeicyboodsp_tpu_torch.oracle import lpc as port_olpc

import torch_inputs as TI


def _speech(n, seed, f0=123.0):
    """tests/test_features.py:_speech."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 8000 * np.sin(2 * np.pi * f0 * t) + 2000 * np.sin(2 * np.pi * 3 * f0 * t)
    return np.clip(x + rng.normal(0, 300, n), -32768, 32767).astype(np.int16)


def _rel(got, want):
    return float(np.abs(got - want).max(initial=0) / max(np.abs(want).max(initial=0), 1e-300))


@pytest.mark.parametrize("n", [0, 100, 256, 256 * 12, 256 * 12 + 77])
def test_lpc_run_matches_oracle(n):
    """lpc_run within 1e-9 relative of oracle/lpc.run (tests/test_features.py:
    25-30), with an empty input and a partial last block; both solvers."""
    x = _speech(n, n)
    want = olpc.run(x)
    got = TF.lpc_run(x, device="cpu")
    assert got.shape == want.shape == (max(-(-n // 256) - 1, 0), 12)
    assert _rel(got, want) <= 1e-9, _rel(got, want)


@pytest.mark.parametrize("n", [256 * 12 + 77])
def test_lpc_levinson_as_close_as_jax(n):
    """The Levinson-Durbin solver is another algorithm than the oracle's LU:
    within 1e-8 of the largest coefficient (tests/test_features.py holds
    JAX's op at rtol 1e-7), JAX's own Levinson error printed beside.  The
    autocorrelations of the two sides differ in their last bit (5e-16, the
    order of their sums), which this input's systems amplify to ~1e-10."""
    x = _speech(n, n)
    want = olpc.run(x)
    got = TF.lpc_run(x, solver="levinson", device="cpu")
    whole = len(x) // 256 * 256
    tail = np.concatenate([x[whole:], x[whole - 256 + n % 256:whole]])  # the stale tail
    blocks = np.concatenate([np.zeros((1, 256), np.int16), x[:whole].reshape(-1, 256), tail[None]])
    frames = np.concatenate([blocks[:-1], blocks[1:]], 1)
    jax_frames = np.asarray(JF.lpc_frames(jnp.asarray(frames), solver="levinson"))[1:]
    jerr = _rel(jax_frames, want)
    print(f"levinson against the oracle: port {_rel(got, want):.2e}, JAX {jerr:.2e}")
    assert _rel(got, want) <= 1e-8


def _frames(F, seed):
    x = _speech(256 * (F + 1), seed)
    blocks = x.reshape(-1, 256)
    return np.concatenate([blocks[:-1], blocks[1:]], 1)


def test_lpc_frames_against_jax():
    """lpc_frames against JAX's: f64 within 1e-9 of the largest coefficient
    for both solvers (the 12x12 systems' condition amplifies the
    autocorrelations' last bits, summed in another order).  f32 within the
    f32 spread: each frame's error against JAX's f64 solution over its
    largest coefficient, the port's worst frame within 4x JAX's worst for
    the LU solve; for Levinson in f32 a few ill-conditioned frames lose
    every digit on either side (the recursion's error term e shrinks
    toward its rounding), so the port's median frame is held within 4x
    JAX's median frame.  All printed."""
    fr = _frames(40, 3)
    for solver in ("solve", "levinson"):
        want64 = np.asarray(JF.lpc_frames(jnp.asarray(fr), dtype=jnp.float64, solver=solver))
        got64 = TF.lpc_frames(torch.from_numpy(fr), dtype=torch.float64, solver=solver).numpy()
        assert _rel(got64, want64) <= 1e-9, (solver, _rel(got64, want64))
        want32 = np.asarray(JF.lpc_frames(jnp.asarray(fr), dtype=jnp.float32, solver=solver))
        got32 = TF.lpc_frames(torch.from_numpy(fr), dtype=torch.float32, solver=solver).numpy()
        scale = np.abs(want64).max(1)
        ej = np.abs(want32 - want64).max(1) / scale
        ep = np.abs(got32 - want64).max(1) / scale
        print(f"lpc_frames {solver} f32 per-frame error: port median {np.median(ep):.2e} worst "
              f"{ep.max():.2e}, JAX median {np.median(ej):.2e} worst {ej.max():.2e}")
        assert got32.dtype == np.float32
        if solver == "solve":
            assert ep.max() <= 4 * ej.max()
        else:
            assert np.median(ep) <= 4 * np.median(ej)


def test_hamming_and_empty_frames():
    np.testing.assert_array_equal(TF.hamming(512).numpy(), np.asarray(JF.hamming(512)))
    out = TF.lpc_frames(torch.zeros(0, 512, dtype=torch.int16))
    assert out.shape == (0, 12)
    with pytest.raises(ValueError):
        TF.lpc_frames(torch.zeros(2, 512, dtype=torch.int16), solver="qr")


def test_port_lpc_reference_equals_oracle():
    for n in (0, 100, 256 * 9 + 5):
        x = _speech(n, 9)
        assert port_olpc.reference_lpc(x).tobytes() == olpc.run(x).tobytes()


def test_card_levinson_f32_limits_follow_jax():
    """tests/test_torch_cuda.py holds the card's f32 Levinson over the
    LPC_T frames of torch_inputs.lpc_signal() to 4x JAX's f32 op on the same
    frames: the median frame error and the count of frames above 1e-2
    against reference_lpc.  JAX's reading (jitted, CPU) is taken anew here
    and the recorded one (torch_inputs.LPC_F32_JAX) must match it, so the
    limits stay derived from JAX; the port's f32 Levinson on the CPU meets
    the same limits.  Both readings printed."""
    import jax

    x = TI.lpc_signal()  # the card test's input
    want = port_olpc.reference_lpc(x)
    scale = np.abs(want).max(1)
    blocks = x.reshape(-1, 256)
    frames = np.concatenate([np.concatenate([np.zeros_like(blocks[:1]), blocks[:-1]]), blocks], 1)
    jax32 = jax.jit(lambda f: JF.lpc_frames(f, dtype=jnp.float32, solver="levinson"))
    readings = {}
    for name, got in (("JAX", np.asarray(jax32(jnp.asarray(frames)))[1:]),
                      ("port", TF.lpc_run(x, dtype=torch.float32, solver="levinson",
                                          device="cpu"))):
        e = np.abs(got - want).max(1) / scale
        readings[name] = (float(np.median(e)), int((e > 1e-2).sum()))
        print(f"levinson f32 over {len(e)} frames: {name} median {readings[name][0]:.3e}, "
              f"{readings[name][1]} frames above 1e-2, worst {e.max():.3e}")
    jm, jn = readings["JAX"]
    assert abs(TI.LPC_F32_JAX[0] - jm) <= 0.01 * jm and TI.LPC_F32_JAX[1] == jn, readings
    assert (TI.LPC_F32_MEDIAN, TI.LPC_F32_LOST) == (4 * TI.LPC_F32_JAX[0], 4 * TI.LPC_F32_JAX[1])
    pm, pn = readings["port"]
    assert pm <= TI.LPC_F32_MEDIAN and pn <= TI.LPC_F32_LOST, readings
