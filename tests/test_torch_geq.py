"""CPU parity of the port's 7-band GEQ (``jeicyboodsp_tpu_torch.ops.geq``,
kernels K6 and K7) with the JAX package and the f64 oracle.

On CPU tensors the kernel wrappers run their plain PyTorch versions, so these
tests hold the plain versions' arithmetic; the CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py and by chip_smoke.py.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.kernels import biquad_pallas as bq
from jeicyboodsp_tpu.oracle import geq as ogeq
from jeicyboodsp_tpu.ops import geq as jgeq
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.kernels import geq_cascade as K7
from jeicyboodsp_tpu_torch.kernels import geq_cascade_quant as K6
from jeicyboodsp_tpu_torch.ops import geq as TG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (gains) sets that reach every coefficient branch: the reference's gains
# (bass boost, treble cut, boost and flat peaks), and their mirror (bass cut
# with the V/K quirk, treble boost, cut peaks)
GAIN_SETS = {"reference": ogeq.GAINS_DB, "mirror": (-6.0, -3.0, 6.0, -12.0, 0.0, 9.0, 6.0)}


def _tone(n, seed=0):
    """440 Hz + 3 kHz over N(0, 500), as tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    sig = 8000 * np.sin(2 * np.pi * 440 * t) + 4000 * np.sin(2 * np.pi * 3000 * t)
    return np.clip(sig + rng.normal(0, 500, n), -32768, 32767).astype(np.int16)


def _stress(n, seed=1):
    """Full-scale random int16: the +12 dB bands overflow and wrap."""
    return np.random.default_rng(seed).integers(-32768, 32768, n).astype(np.int16)


def _coef(compat=True, gains=ogeq.GAINS_DB):
    b, a = TG.geq_coefficients(gains_db=gains, compat=compat)
    return torch.from_numpy(K7.pack_coefficients(b, a, np.float64))


@pytest.mark.parametrize("gains", sorted(GAIN_SETS))
@pytest.mark.parametrize("compat", [True, False])
def test_coefficients_byte_identical(compat, gains):
    want = jgeq.geq_coefficients(gains_db=GAIN_SETS[gains], compat=compat)
    got = TG.geq_coefficients(gains_db=GAIN_SETS[gains], compat=compat)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype == np.float64 and w.shape == g.shape == (7, 3)
        assert w.tobytes() == g.tobytes()
    wc = ogeq.calc_coefficients(gains_db=GAIN_SETS[gains], compat=compat)
    assert all(w.tobytes() == g.tobytes() for w, g in zip(wc, got))


def test_constants_equal_the_oracle():
    for name in ("SAMPLING_RATE", "TOTAL_BANDS", "BLOCK_LEN", "Q", "CENTER_FREQS", "GAINS_DB"):
        assert getattr(TG, name) == getattr(ogeq, name), name


@pytest.mark.parametrize("signal", ["tone", "stress"])
def test_k6_plain_bit_exact_vs_oracle_and_jax(signal):
    x = (_tone if signal == "tone" else _stress)(2048)
    want = ogeq.run(x)
    y, state = K6.geq_cascade_quant(torch.from_numpy(x[None]), _coef())
    assert y.dtype == torch.int16 and state.shape == (1, 7, 4)
    np.testing.assert_array_equal(y[0].numpy(), want)
    b, a = jgeq.geq_coefficients()
    yj, _ = bq.geq_cascade_pallas_quant(jnp.asarray(x[None]), bq.pack_coefficients_df(b, a),
                                        interpret=True)
    np.testing.assert_array_equal(np.asarray(yj)[0].astype(np.int16), y[0].numpy())


def test_k6_plain_state_threading_matches_jax_state():
    """Two chained calls == one call == the oracle; the carried state equals
    the JAX kernel's (x1, x2, y1, y2 rows per band) after the first call."""
    x = _stress(1024, seed=5)
    coef = _coef()
    y1, s1 = K6.geq_cascade_quant(torch.from_numpy(x[None, :512]), coef)
    y2, s2 = K6.geq_cascade_quant(torch.from_numpy(x[None, 512:]), coef, s1)
    yw, sw = K6.geq_cascade_quant(torch.from_numpy(x[None]), coef)
    np.testing.assert_array_equal(torch.cat([y1, y2], 1).numpy(), yw.numpy())
    assert torch.equal(s2, sw)
    np.testing.assert_array_equal(yw[0].numpy(), ogeq.run(x))
    b, a = jgeq.geq_coefficients()
    _, sj = bq.geq_cascade_pallas_quant(jnp.asarray(x[None, :512]), bq.pack_coefficients_df(b, a),
                                        interpret=True)
    sj = np.asarray(sj)[0].reshape(7, 4, -1)[:, :, 0]  # stream 0: (band, [x1 x2 y1 y2])
    np.testing.assert_array_equal(s1[0].numpy(), sj.astype(np.int16))


def test_k6_plain_batch_3072_vs_oracle():
    """B = 3072, where the JAX op raises (ROADMAP R2): every stream against
    the oracle's block function, state carried across two calls."""
    B, n = 3072, 48
    rng = np.random.default_rng(7)
    x = rng.integers(-32768, 32768, (B, n)).astype(np.int16)
    x[: B // 2] //= 8  # half the streams quiet, half wrapping
    coef = _coef()
    y1, s = K6.geq_cascade_quant(torch.from_numpy(x[:, : n // 2].copy()), coef)
    y2, _ = K6.geq_cascade_quant(torch.from_numpy(x[:, n // 2:].copy()), coef, s)
    got = torch.cat([y1, y2], 1).numpy()
    b, a = ogeq.calc_coefficients()
    for i in range(B):
        np.testing.assert_array_equal(got[i], ogeq.process_block(ogeq.GEQState(), x[i], b, a))


@pytest.mark.parametrize("n", [0, 100, 512, 1200, 2 * 512 + 511])
def test_run_quant_matches_oracle(n):
    """run_quant is the JAX stream_blocks / run_pallas_quant: partial last
    blocks keep the previous block's stale tail; an empty payload gives 0
    samples."""
    x = _stress(n, seed=n) // 2
    got = TG.run_quant(x, device="cpu")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ogeq.run(x))


def test_run_quant_compat_false_and_other_gains_match_oracle():
    x = _tone(1100, seed=3)
    for compat in (True, False):
        for gains in GAIN_SETS.values():
            np.testing.assert_array_equal(
                TG.run_quant(x, gains_db=gains, compat=compat, device="cpu"),
                ogeq.run(x, gains_db=gains, compat=compat))


def test_k7_plain_vs_jax_interpret_and_f64_scan():
    """The linear f32 cascade against JAX's Pallas kernel in interpret mode:
    the same f32 op order, but XLA:CPU may contract a product and a sum into
    an FMA (ROADMAP R7), so the two agree to f32 rounding, not bit for bit
    (measured: max |diff| 1.14e-5 of the signal's peak, 98.8 dB).  Against the f64
    associative scan >= 55 dB, as tests/test_pallas_kernels.py holds the JAX
    kernel."""
    rng = np.random.default_rng(20260817)
    x = rng.normal(0, 1000, (4, 1024)).astype(np.float32)
    b, a = jgeq.geq_coefficients()
    got = K7.geq_cascade(torch.from_numpy(x), torch.from_numpy(K7.pack_coefficients(b, a)))
    assert got.dtype == torch.float32 and got.shape == (4, 1024)
    got = got.numpy()
    want = np.asarray(bq.geq_cascade_pallas(jnp.asarray(x), bq.pack_coefficients(b, a),
                                            interpret=True))
    peak = np.abs(want).max()
    d = np.abs(got - want).max()
    print(f"K7 plain vs JAX interpret: max |diff| {d:.3e} = {d / peak:.3e} of peak, "
          f"{snr_db(want, got):.1f} dB")
    assert d <= 1e-4 * peak
    assert snr_db(want, got) >= 90.0
    f64 = np.asarray(jgeq.geq_apply_fast(jnp.asarray(x), b, a, dtype=jnp.float64))
    assert snr_db(f64, got) >= 55.0


def test_pack_coefficients_matches_jax():
    b, a = jgeq.geq_coefficients()
    want = bq.pack_coefficients(b, a)
    got = K7.pack_coefficients(b, a)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert K7.pack_coefficients(b, a, np.float64).tobytes() == np.concatenate(
        [b, a[:, 1:]], 1).tobytes()


def test_k7_plain_rows_independent_and_vs_jax_f64():
    """K7's rows are independent streams: a batch equals its rows run alone,
    a negated stream gives the negated output bit for bit (every rounding is
    sign-symmetric), and a tone stays >= 55 dB of JAX geq_apply_fast in f64."""
    x = _tone(1536, seed=2).astype(np.float32)
    b, a = jgeq.geq_coefficients()
    coef = torch.from_numpy(K7.pack_coefficients(b, a))
    got = K7.geq_cascade(torch.from_numpy(x[None]), coef)[0].numpy()
    got2 = K7.geq_cascade(torch.from_numpy(np.stack([x, -x])), coef).numpy()
    np.testing.assert_array_equal(got2[0], got)
    np.testing.assert_array_equal(got2[1], -got)
    want = np.asarray(jgeq.geq_apply_fast(jnp.asarray(x.astype(np.float64)), b, a,
                                          dtype=jnp.float64))
    assert snr_db(want, got) >= 55.0


def test_geq_apply_chunked_equals_whole_and_state_round_trips():
    """geq_apply with the JAX state dict: chunked == whole == oracle, and the
    state converts to the kernel's form and back without loss."""
    x = _stress(1536, seed=9) // 3
    b, a = TG.geq_coefficients()
    st = TG.init_state()
    outs = []
    for s in range(0, len(x), 500):
        y, st = TG.geq_apply(torch.from_numpy(x[s:s + 500]), b, a, st)
        outs.append(y.numpy())
    whole, st_w = TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state())
    np.testing.assert_array_equal(np.concatenate(outs), whole.numpy())
    np.testing.assert_array_equal(whole.numpy(), ogeq.run(x)[: len(x)])
    for k in ("xh", "yh"):
        assert torch.equal(st[k], st_w[k])
    # the port's state dict after 700 samples holds the oracle's keep buffers
    # in the JAX op's layout (oldest first), and a JAX state round-trips
    _, sp = TG.geq_apply(torch.from_numpy(x[:700]), b, a, TG.init_state())
    so = ogeq.GEQState()
    ogeq.process_block(so, x[:700], b, a)
    np.testing.assert_array_equal(sp["xh"].numpy(), so.keep_in[0])
    np.testing.assert_array_equal(sp["yh"].numpy(), so.keep_out)
    _, sj = jgeq.geq_apply(jnp.asarray(x[:700]), b, a, jgeq.init_state(), dtype=jnp.float64)
    back = TG.state_to_jax(TG.state_to_port(sj))
    for k in ("xh", "yh"):
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(sj[k]))


def test_geq_apply_batched_state():
    x = _stress(2 * 300, seed=4).reshape(2, 300) // 2
    b, a = TG.geq_coefficients()
    st = {"xh": torch.zeros(2, 2, dtype=torch.int32), "yh": torch.zeros(2, 7, 2, dtype=torch.int32)}
    y, st = TG.geq_apply(torch.from_numpy(x), b, a, st)
    for i in range(2):
        yi, sti = TG.geq_apply(torch.from_numpy(x[i]), b, a, TG.init_state())
        assert torch.equal(y[i], yi)
        assert torch.equal(st["yh"][i], sti["yh"]) and torch.equal(st["xh"][i], sti["xh"])


def test_geq_apply_rejects_mismatched_state():
    """A state dict whose batch is not x's is refused, not broadcast."""
    b, a = TG.geq_coefficients()
    st3 = {"xh": torch.zeros(3, 2, dtype=torch.int32), "yh": torch.zeros(3, 7, 2, dtype=torch.int32)}
    with pytest.raises(ValueError):
        TG.geq_apply(torch.zeros(2, 8, dtype=torch.int16), b, a, st3)
    with pytest.raises(ValueError):
        TG.geq_apply(torch.zeros(8, dtype=torch.int16), b, a, st3)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 16, dtype=torch.int16)
    coef = _coef()
    for bad in (x.to(torch.int32), x[0], x.t().contiguous().t()[:, ::2], x.to("meta")):
        with pytest.raises(ValueError):
            K6.geq_cascade_quant(bad, coef)
    with pytest.raises(ValueError):
        K6.geq_cascade_quant(x, coef.float())
    with pytest.raises(ValueError):
        K6.geq_cascade_quant(x, coef, K6.init_state(3))
    with pytest.raises(ValueError):
        K7.geq_cascade(x.float(), coef)  # K7 takes f32 coefficients


def test_pipeline_geq_file_end_to_end(tmp_path):
    """The geq pipeline skips the 44-byte header and equals the oracle's
    bytes: full blocks, a wrap-stress section, a partial block, header only."""
    from jeicyboodsp_tpu_torch.cli import main
    from jeicyboodsp_tpu_torch.pipelines import registry

    hdr = np.arange(22, dtype=np.int16)  # 44 bytes that are not samples
    x = np.concatenate([_tone(1024), _stress(512)])
    cases = {"full": x, "partial": x[: 1024 + 300], "empty": x[:0]}
    for name, data in cases.items():
        inp = tmp_path / f"{name}.wav"
        np.concatenate([hdr, data]).tofile(inp)
        out = tmp_path / f"{name}.pcm"
        y = registry.PIPELINES["geq"](str(inp), str(out), device="cpu")
        got = np.fromfile(out, "<i2")
        np.testing.assert_array_equal(got, y)
        np.testing.assert_array_equal(got, ogeq.run(data))
    out_cli = tmp_path / "cli.pcm"
    assert main(["geq", str(tmp_path / "full.wav"), str(out_cli), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(out_cli, "<i2"), ogeq.run(x))


def test_chip_smoke_geq_references_match_oracle():
    """chip_smoke.py carries its own float64 GEQ reference (it may not import
    the JAX package); it must equal the oracle byte for byte, including the
    wrap stress, partial blocks and an empty payload, and its linear form
    must agree with the JAX f64 scan."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    b, a = TG.geq_coefficients()
    x = np.concatenate([_tone(1024, seed=4), _stress(512, seed=4)])
    for n in (0, 100, 512, 1100, len(x)):
        np.testing.assert_array_equal(chip_smoke.reference_geq(x[:n], b, a), ogeq.run(x[:n]))
    tone = _tone(1024, seed=5)
    lin = np.asarray(jgeq.geq_apply_fast(jnp.asarray(tone.astype(np.float64)), b, a,
                                         dtype=jnp.float64))
    got = chip_smoke.reference_geq_linear(tone, b, a)
    assert np.abs(got.astype(np.float64) - np.trunc(lin)).max() <= 1
