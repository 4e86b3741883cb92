"""CPU parity of the port's 7-band GEQ (``jeicyboodsp_tpu_torch.ops.geq``,
kernels K6 and K7) with the JAX package and the f64 oracle.

On CPU tensors the kernel wrappers run their plain PyTorch versions, so these
tests hold the plain versions' arithmetic; the CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py and by chip_smoke.py.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import os
import subprocess
import sys

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
        y, st = TG.geq_apply(torch.from_numpy(x[s:s + 500]), b, a, st, dtype=torch.float64)
        outs.append(y.numpy())
    whole, st_w = TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state(), dtype=torch.float64)
    np.testing.assert_array_equal(np.concatenate(outs), whole.numpy())
    np.testing.assert_array_equal(whole.numpy(), ogeq.run(x)[: len(x)])
    for k in ("xh", "yh"):
        assert torch.equal(st[k], st_w[k])
    # the port's state dict after 700 samples holds the oracle's keep buffers
    # in the JAX op's layout (oldest first), and a JAX state round-trips
    _, sp = TG.geq_apply(torch.from_numpy(x[:700]), b, a, TG.init_state(), dtype=torch.float64)
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
    y, st = TG.geq_apply(torch.from_numpy(x), b, a, st, dtype=torch.float64)
    for i in range(2):
        yi, sti = TG.geq_apply(torch.from_numpy(x[i]), b, a, TG.init_state(), dtype=torch.float64)
        assert torch.equal(y[i], yi)
        assert torch.equal(st["yh"][i], sti["yh"]) and torch.equal(st["xh"][i], sti["xh"])


def test_geq_apply_rejects_mismatched_state():
    """A state dict whose batch is not x's is refused, not broadcast."""
    b, a = TG.geq_coefficients()
    st3 = {"xh": torch.zeros(3, 2, dtype=torch.int32), "yh": torch.zeros(3, 7, 2, dtype=torch.int32)}
    with pytest.raises(ValueError):
        TG.geq_apply(torch.zeros(2, 8, dtype=torch.int16), b, a, st3, dtype=torch.float64)
    with pytest.raises(ValueError):
        TG.geq_apply(torch.zeros(8, dtype=torch.int16), b, a, st3, dtype=torch.float64)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 16, dtype=torch.int16)
    coef = _coef()
    for bad in (x.to(torch.int32), x[0], x.t().contiguous().t()[:, ::2], x.to("meta")):
        with pytest.raises(ValueError):
            K6.geq_cascade_quant(bad, coef)
    with pytest.raises(ValueError):
        K6.geq_cascade_quant(x, coef.half())  # K6 takes f64 or f32 coefficients
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
    wrap stress, partial blocks and an empty payload, its float32 copy must
    equal the port's f32 route, and its linear form must agree with the JAX
    f64 scan."""
    from jeicyboodsp_tpu_torch.oracle import geq as port_oracle

    b, a = TG.geq_coefficients()
    x = np.concatenate([_tone(1024, seed=4), _stress(512, seed=4)])
    for n in (0, 100, 512, 1100, len(x)):
        np.testing.assert_array_equal(port_oracle.reference_geq(x[:n], b, a), ogeq.run(x[:n]))
        # its float32 copy (geq --fast) against the port's f32 route, itself held to JAX's
        np.testing.assert_array_equal(port_oracle.reference_geq_f32(x[:n], b, a),
                                      TG.run_quant(x[:n], device="cpu", dtype=torch.float32))
    tone = _tone(1024, seed=5)
    lin = np.asarray(jgeq.geq_apply_fast(jnp.asarray(tone.astype(np.float64)), b, a,
                                         dtype=jnp.float64))
    got = port_oracle.reference_geq_linear(tone, b, a)
    assert np.abs(got.astype(np.float64) - np.trunc(lin)).max() <= 1


# ---- the f32 compat route: geq_apply(dtype=float32), run_quant, geq --fast ----

# JAX's f32 geq_apply and stream_blocks, run in a process of their own whose
# XLA:CPU may not use FMA instructions.  The op pins every product with
# optimization_barrier so that each is rounded on its own (jeicyboodsp_tpu/
# ops/geq.py:57-80), but the barriers are gone by the time LLVM compiles the
# fused loop, which on a host with FMA contracts products into the adds
# (ROADMAP R11).  With the ISA held below FMA, XLA computes what the op writes.
_JAX_F32 = """
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.ops import geq as jgeq

d = dict(np.load(sys.argv[1]))
b, a = jgeq.geq_coefficients()
out = {}


def apply(name, x, st):
    y, st = jgeq.geq_apply(jnp.asarray(x), b, a, st, dtype=jnp.float32)
    out[name] = np.asarray(y)
    out[name + "_xh"], out[name + "_yh"] = np.asarray(st["xh"]), np.asarray(st["yh"])
    return st


for name in ("tone", "stress"):
    apply(name, d[name], jgeq.init_state())
apply("chained", d["stress"][700:], apply("chained_first", d["stress"][:700], jgeq.init_state()))
out["stream"] = jgeq.stream_blocks(d["probe"], dtype=jnp.float32)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    work = tmp_path_factory.mktemp("geq_f32")
    probe = np.concatenate([_tone(1024, seed=6), _stress(512, seed=6)])[: 1024 + 300]
    inputs = {"tone": _tone(2048), "stress": _stress(2048), "probe": probe}
    np.savez(work / "in.npz", **inputs)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_cpu_max_isa=AVX"}
    subprocess.run([sys.executable, "-c", _JAX_F32, str(work / "in.npz"), str(work / "out.npz")],
                   cwd=ROOT, env=env, check=True, capture_output=True, timeout=600)
    return work, inputs, dict(np.load(work / "out.npz"))


def _port_f32(x, st=None):
    b, a = TG.geq_coefficients()
    return TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state() if st is None else st)


@pytest.mark.parametrize("case", ["tone", "stress", "chained"])
def test_geq_apply_f32_bit_equal_to_jax(jax_f32, case):
    """The port's f32 geq_apply on the CPU (K6's f32 plain version, every op
    rounded as written) equals JAX's f32 geq_apply bit for bit, output and
    state: a tone, full-scale random int16 through the +12 dB bands (wrap
    stress), and two chained calls with state.  Its distance from the
    reference is printed, with no floor: f32 rounding changes where the
    int16 feedback wraps."""
    _, inputs, want = jax_f32
    x = inputs["stress" if case == "chained" else case]
    if case == "chained":
        y1, st = _port_f32(x[:700])
        y2, st = _port_f32(x[700:], st)
        y = np.concatenate([y1.numpy(), y2.numpy()])
        want_y = np.concatenate([want["chained_first"], want["chained"]])
    else:
        y, st = _port_f32(x)
        y, want_y = y.numpy(), want[case]
    assert y.dtype == np.int16
    np.testing.assert_array_equal(y, want_y)
    for k in ("xh", "yh"):
        np.testing.assert_array_equal(st[k].numpy(), want[f"{case}_{k}"])
    ref = ogeq.run(x)[: len(x)]
    print(f"f32 geq_apply {case} vs the reference: {snr_db(ref, y):.2f} dB, "
          f"{int((y != ref).sum())} of {len(x)} samples differ")
    if case == "tone":  # this process's XLA:CPU, FMA allowed (ROADMAP R11)
        b, a = TG.geq_coefficients()
        yj, _ = jgeq.geq_apply(jnp.asarray(x), b, a, jgeq.init_state(), dtype=jnp.float32)
        print(f"JAX f32 geq_apply with this host's ISA: {int((np.asarray(yj) != y).sum())} of "
              f"{len(x)} samples differ from the port's")


def test_run_quant_f32_and_cli_fast_equal_jax_stream_blocks(jax_f32, tmp_path):
    """run_quant(dtype=float32) and ``geq --fast`` from the port's CLI equal
    JAX's stream_blocks(dtype=float32) on a probe with a partial last block
    (one K6 call over the stale-tail signal is the block-by-block stream)."""
    from jeicyboodsp_tpu_torch.cli import main

    _, inputs, want = jax_f32
    probe = inputs["probe"]
    got = TG.run_quant(probe, device="cpu", dtype=torch.float32)
    assert len(got) == 3 * 512 and got.dtype == np.int16
    np.testing.assert_array_equal(got, want["stream"])
    inp, out = tmp_path / "in.wav", tmp_path / "out.pcm"
    np.concatenate([np.arange(22, dtype=np.int16), probe]).tofile(inp)
    assert main(["geq", str(inp), str(out), "--fast", "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(out, "<i2"), want["stream"])
    ref = ogeq.run(probe)
    print(f"geq --fast vs the reference: {snr_db(ref, got):.2f} dB, "
          f"{int((got != ref).sum())} of {len(got)} samples differ")


def test_geq_apply_default_is_f32_and_dtype_is_checked():
    """geq_apply's default dtype is float32, as JAX's; float64 is the
    reference's arithmetic; any other dtype raises."""
    x = _stress(600, seed=8)
    b, a = TG.geq_coefficients()
    y, _ = TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state())
    y32, _ = TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state(), dtype=torch.float32)
    y64, _ = TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state(), dtype=torch.float64)
    assert torch.equal(y, y32) and not torch.equal(y, y64)
    np.testing.assert_array_equal(y64.numpy(), ogeq.run(x)[: len(x)])
    for bad in (torch.float16, torch.int16):
        with pytest.raises(ValueError):
            TG.geq_apply(torch.from_numpy(x), b, a, TG.init_state(), dtype=bad)
        with pytest.raises(ValueError):
            TG.run_quant(x, device="cpu", dtype=bad)
