"""CPU parity of the PyTorch port (``jeicyboodsp_tpu_torch``) with the JAX package.

Seeded numpy inputs go through the JAX function and its port; the JAX side
runs on the CPU as the JAX package's own tests run it (the fused kernel in
interpret mode).  On CPU tensors the port's kernel wrapper runs its plain
PyTorch version, so these tests hold the plain version's arithmetic; the
CUDA kernel is held against the plain version in tests/test_torch_cuda.py
and by chip_smoke.py.
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
from jeicyboodsp_tpu.utils.cnum import c_short_np
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K
from jeicyboodsp_tpu_torch.ops import enhance as TE
from jeicyboodsp_tpu_torch.utils.cnum import c_short

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOR = {True: 78.0, False: 65.0}  # vs the oracle: mxu8f (hq), mxu8t (turbo)
ENGINE_FLOOR = {"mxu8f": 78.0, "mxu8t": 65.0, "mxu8": 78.0, "mxu3": 85.0}
PORT_VS_JAX_DB = 90.0


def _signal(n_blocks, seed, silent_blocks=0):
    """The engine-matrix probe (tests/test_engine_matrix.py:32-37); with
    ``silent_blocks`` the tone starts late over N(0, 50) noise, which the
    VAD calls noise block after block (N(0, 20) alone truncates to runs of
    zeros that read as speech), so the run reaches the 10-frame latch."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    noise = rng.normal(0, 20, n_blocks * 512)
    sp[: silent_blocks * 512] = 0.0
    noise[: silent_blocks * 512] *= 2.5
    return np.clip(sp + noise, -32768, 32767).astype(np.int16)


PROBES = {"probe64": (64, 11, 0), "latch64": (64, 11, 16)}


@pytest.fixture(scope="module", params=sorted(PROBES))
def probe(request):
    return request.param, _signal(*PROBES[request.param])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import jeicyboodsp_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jeicyboodsp_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('jeicyboodsp_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 12  # every submodule was imported


@pytest.mark.parametrize("basis_fn", ["_dft_mats_aligned", "_dft_mats_int8", "_dft_mats_int8_back"])
def test_bases_byte_identical(basis_fn):
    want, got = getattr(JE, basis_fn)(), getattr(TE, basis_fn)()
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, k
        assert want[k].tobytes() == got[k].tobytes(), k


def test_constants_from_jax_arrays_equal_own():
    own = TE.enhance_constants("cpu")
    jx = TE.enhance_constants(
        "cpu", (JE._dft_mats_aligned(), JE._dft_mats_int8(), JE._dft_mats_int8_back()))
    assert sorted(own) == sorted(jx) == sorted(K.CONST_SPECS)
    for k, (dtype, shape) in K.CONST_SPECS.items():
        assert own[k].dtype == dtype and tuple(own[k].shape) == shape, k
        assert torch.equal(own[k], jx[k]), k


def test_back32_is_the_tf32_split_of_the_inverse_bases():
    """back32 (K5's and K13's right operands) holds TF32 halves of UC512 and
    VS512, transposed: no bits below TF32's 10-bit mantissa, hi the nearest
    TF32 value, and hi + lo within 2^-22 of each entry."""
    C = TE.enhance_constants("cpu")
    b = C["back32"].numpy()
    for i, name in enumerate(("UC512", "VS512")):
        B = C[name].numpy().T.astype(np.float64)
        hi, lo = b[2 * i], b[2 * i + 1]
        for half in (hi, lo):
            assert not (half.view(np.uint32) & 0x1FFF).any(), name
        assert (np.abs(B - hi) <= 2.0 ** -11 * np.abs(B)).all(), name
        assert (np.abs(B - hi - lo) <= 2.0 ** -22 * np.abs(B)).all(), name


@pytest.mark.parametrize("v", [
    float("nan"), float("inf"), -float("inf"), 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1,
    -(2.0 ** 31) - 1, 2.0 ** 31 + 1, 32767.9, 32768.0, -32769.0, 65535.5, 65536.0,
    0.5, -0.5, 1.5, -1.5, 0.0, -0.0, 12345.99, -12345.99, 3e9, -3e9,
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c_short_matches_reference(v, dtype):
    x = torch.tensor([v], dtype=dtype)
    want = c_short_np(x.numpy().astype(np.float64))
    got = c_short(x)
    assert got.dtype == torch.int16
    assert got.numpy().tolist() == want.tolist()


def test_vad_flags_and_rowpack_exact(probe):
    _, x = probe
    b = x.reshape(-1, 512)
    sj = np.asarray(JE.vad_flags(jnp.asarray(b), jnp.float32))
    st = TE.vad_flags(torch.from_numpy(b), torch.float32).numpy()
    np.testing.assert_array_equal(st, sj)
    for L in (16, 64):
        rj = np.asarray(JE._latch_rowpack(jnp.asarray(sj), L=L))
        rt = TE._latch_rowpack(torch.from_numpy(st), L=L).numpy()
        assert rt.dtype == rj.dtype == np.float32
        np.testing.assert_array_equal(rt[:, 2], rj[:, 2])  # latch rows g
        np.testing.assert_array_equal(rt[:, 4:], rj[:, 4:])
        # the port's scalings are exact powers of two (w = c*2^lk with c in
        # {0, 1/2, 1}); jnp.exp2 on XLA:CPU is a few ulp off for |lk| >= 13
        # (ROADMAP R6), so JAX's agree to that
        for col in (0, 1, 3):
            mant = np.frexp(rt[:, col])[0]
            assert np.all((mant == 0) | (mant == 0.5)), col
        np.testing.assert_allclose(rt[:, :4], rj[:, :4], rtol=2 ** -20, atol=0)


def _batched_vad_probe():
    """ROADMAP P6's probe: 3 streams x 64 blocks of N(0, 30) noise with a
    5000-amplitude tone on every third block."""
    rng = np.random.default_rng(16)
    x = rng.normal(0, 30, (3, 64, 512))
    x[:, ::3] += 5000 * np.sin(2 * np.pi * 313 * np.arange(512) / 16000)
    return np.clip(x, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(3, 64), (192,), (3, 4, 16), ()], ids=str)
def test_vad_flags_over_batch_axes_equal_jax(dtype, shape):
    """``vad_flags`` over (..., 512) blocks: the energy and the ZCR partner
    along the last axis, in f32 the leading axes flattened around K14's
    wrapper; flags equal to JAX's on the same blocks."""
    b = _batched_vad_probe().reshape(*shape, -1, 512)[..., 0, :]  # () takes one block
    want = np.asarray(JE.vad_flags(jnp.asarray(b), getattr(jnp, dtype)))
    got = TE.vad_flags(torch.from_numpy(b), getattr(torch, dtype))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    if shape == (3, 64):
        assert 0 < want.sum() < want.size  # speech and noise rows both


def test_vad_flags_default_is_jax_s():
    """The default call, float64 as JAX's default, equal to JAX's default
    call."""
    import inspect

    assert inspect.signature(TE.vad_flags).parameters["dtype"].default is torch.float64
    b = _batched_vad_probe()
    np.testing.assert_array_equal(TE.vad_flags(torch.from_numpy(b)).numpy(),
                                  np.asarray(JE.vad_flags(jnp.asarray(b))))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("shape", [(0, 512), (3, 0, 512), (0, 64, 512)], ids=str)
def test_vad_flags_empty_leading_axis(dtype, shape):
    """An empty leading axis gives empty flags of the leading shape, as JAX
    does, and launches nothing (K14 needs T >= 1)."""
    from jeicyboodsp_tpu_torch.kernels import vad_flags as K14

    before = K14.vad_flags.launches
    got = TE.vad_flags(torch.zeros(shape, dtype=torch.int16), dtype)
    want = np.asarray(JE.vad_flags(jnp.zeros(shape, jnp.int16)))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape == shape[:-1]
    assert K14.vad_flags.launches == before


def test_latch_probe_latches():
    x = _signal(*PROBES["latch64"])
    sp = TE.vad_flags(torch.from_numpy(x.reshape(-1, 512)), torch.float32)
    assert TE._latch_rowpack(sp)[:, 2].max() >= 0  # a latch happened


def test_noise_latch_parts_matches_jax():
    x = _signal(*PROBES["latch64"])[: 60 * 512]  # T not a multiple of the chunk
    b = x.reshape(-1, 512)
    rng = np.random.default_rng(3)
    mags = (np.abs(rng.normal(0, 1e4, (60, 512))).astype(np.float32),
            np.abs(rng.normal(0, 1e4, (60, 1))).astype(np.float32))
    sp = np.array(JE.vad_flags(jnp.asarray(b), jnp.float32))
    want = JE._noise_latch_parts(jnp.asarray(sp), tuple(jnp.asarray(m) for m in mags), chunk=16)
    got = TE._noise_latch_parts(torch.from_numpy(sp), tuple(torch.from_numpy(m) for m in mags),
                                chunk=16)
    assert np.abs(np.asarray(want[0])).max() > 0
    for w, g in zip(want, got):
        # same power-of-two scalings; only the f32 summation order differs
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=0)


def test_plain_int8_dots_exact():
    """The plain version's int8 dots are exact integers: the data split
    x = 256*xh + xl + 128 holds, both halves fit int8, and each dot and the
    256*a + b combination equal a numpy int64 matmul."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(-32768, 32768, (62, 512)),
                        np.full((1, 512), -32768), np.full((1, 512), 32767)]).astype(np.int16)
    C = TE.enhance_constants("cpu")
    xh, xl = K._split8(torch.from_numpy(x).to(torch.int32))
    assert xh.min() >= -128 and xh.max() <= 127 and xl.min() >= -128 and xl.max() <= 127
    np.testing.assert_array_equal((256 * xh + xl + 128).numpy(), x.astype(np.int32))
    for W in (C["fwd8"][0], C["fwd8"][7], C["back8"][1]):
        Wn = W.numpy().astype(np.int64)
        a, b = K._i8dot(xh, W), K._i8dot(xl, W)
        ha, hb = xh.numpy().astype(np.int64) @ Wn.T, xl.numpy().astype(np.int64) @ Wn.T
        np.testing.assert_array_equal(a.numpy(), ha)
        np.testing.assert_array_equal(b.numpy(), hb)
        comb = 256 * ha + hb
        assert np.abs(comb).max() < 2 ** 31  # the int32 bound the kernel relies on
        np.testing.assert_array_equal((256 * a + b).numpy(), comb)


def test_quant_row_nan_row_outputs_zero():
    """A NaN gain (Wiener 0/0) poisons the row max, so the whole row's
    output is c_short(NaN) = 0, as in the TPU kernel (jnp.max propagates NaN)."""
    Y = torch.ones(4, 512)
    Y[2, 7] = float("nan")
    for hq in (True, False):
        h, l, q, z2, q2 = K._quant_row_int8(Y, hq)
        assert torch.isnan(q[2]).all() and not torch.isnan(q[[0, 1, 3]]).any()
    head = torch.full((4, 512), 5.0)
    head[2] = float("nan")
    out = K._ola(head, torch.zeros(4, 512), emit_all=True)
    assert out[2].eq(0).all() and out[3].eq(5).all()


@pytest.mark.parametrize("hq", [True, False], ids=["hq", "turbo"])
def test_quant_row_bit_equal_to_jax(hq):
    """The port's per-row two-level quantization is JAX's bit for bit: the
    planes h, l, z2 and the scales q, q2 on 128 rows of 512 at row scales
    1 to 3e4, a NaN row and an all-zero row.  Written as a Python scalar
    over a tensor (a reciprocal multiply in torch), the port gave another l
    in 18 values, z2 in 935 and q2 in 11 rows on this probe; both now divide
    tensor by tensor, as JAX does."""
    from jeicyboodsp_tpu.kernels import enhance_pallas as KP

    rng = np.random.default_rng(8)
    Y = rng.normal(0, 1, (130, 512)) * np.geomspace(1.0, 3e4, 130)[:, None]
    Y[128, 77] = np.nan
    Y[129] = 0.0
    Y = Y.astype(np.float32)
    got = K._quant_row_int8(torch.from_numpy(Y), hq)
    want = KP._quant_row_int8(jnp.asarray(Y), hq)
    finite = np.arange(130) != 128  # JAX casts the NaN row's planes to int8, the port keeps NaN
    for name, g, w in zip(("h", "l", "q", "z2", "q2"), got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.numpy().astype(np.float32)
        w = np.asarray(w).astype(np.float32)
        assert g.shape == w.shape, name
        if name.startswith("q"):  # the scales: the NaN row's is NaN in both
            assert np.isnan(g[128]).all() and np.isnan(w[128]).all(), name
        g, w = g[finite], w[finite]
        # planes as the kernels store them, int8 (-0 is 0); scales bit for bit
        g, w = (g.astype(np.int8), w.astype(np.int8)) if name[0] != "q" else (
            g.view(np.int32), w.view(np.int32))
        assert np.array_equal(g, w), f"{name}: {int((g != w).sum())} differ"


@pytest.fixture(scope="module")
def jax_full8(probe):
    name, x = probe
    b = jnp.asarray(x.reshape(-1, 512))
    out = {}
    for mode in ("wiener", "specsub"):
        for hq in (True, False):
            o, m = JE._enhance_fused_full(b, mode, False, interpret=True, F=64, L=16, hq=hq)
            out[mode, hq] = np.asarray(o), np.asarray(m)
    return name, x, out


@pytest.mark.parametrize("hq", [True, False], ids=["mxu8f", "mxu8t"])
@pytest.mark.parametrize("mode", ["wiener", "specsub"])
def test_k1_plain_vs_jax_interpret(jax_full8, mode, hq):
    name, x, jout = jax_full8
    oj, mj = jout[mode, hq]
    ot, mt = TE._enhance_fused_full(torch.from_numpy(x.reshape(-1, 512)), mode, False, hq=hq, L=16)
    ot, mt = ot.numpy(), mt.numpy()
    np.testing.assert_array_equal(mt, mj)
    snr = snr_db(oj, ot)
    print(f"{name} {mode} hq={hq}: port vs JAX K1 {snr:.2f} dB, "
          f"differing samples {np.mean(oj != ot):.3e}")
    assert snr >= PORT_VS_JAX_DB
    want = oenh.run(x, mode)
    for got in (oj[mj].reshape(-1), ot[mt].reshape(-1)):
        assert snr_db(want, got) >= FLOOR[hq]


@pytest.mark.parametrize("hq", [True, False], ids=["mxu8f", "mxu8t"])
def test_k1_plain_planes_rebuild_its_output(probe, hq):
    """K1's plain version with ``return_planes``: its back half is K3's
    plain version on the forward planes and the latch, and flip_ola
    rebuilds the int16 output from the uv and rowsc planes it returns."""
    _, x = probe
    blocks = torch.from_numpy(x.reshape(-1, 512))
    C = TE.enhance_constants("cpu")
    rowpack = TE._latch_rowpack(TE.vad_flags(blocks, torch.float32))
    out, p = K.enhance_full8(blocks, rowpack, C, "wiener", hq, L=16, return_planes=True)
    assert torch.equal(out, K.enhance_full8(blocks, rowpack, C, "wiener", hq, L=16))
    re, im, ren = K.forward8_plain(blocks, C)
    assert torch.equal(p["re"], re) and torch.equal(p["im"], im)
    mags = torch.cat([torch.sqrt(re * re + im * im), ren.abs()[:, None]], 1)
    ns = K.latch_from_rowpack(rowpack, mags, 16)
    q8, rowsc = K.quant8_plain(re, im, ren, ns[:, :512], ns[:, 512], C, "wiener", hq)
    assert torch.equal(p["q8"], q8) and torch.equal(p["rowsc"], rowsc)
    assert torch.equal(p["uv"], K.inv8_plain(q8, rowsc, C, hq))
    assert torch.equal(K.flip_ola(p["uv"][0], p["uv"][1], rowsc[:, 5], False), out)


def test_chip_smoke_reference_matches_oracle():
    """The port's own numpy reference (``jeicyboodsp_tpu_torch.oracle``, which
    chip_smoke.py holds the port to: it may not import the JAX package)
    must equal the JAX package's oracle byte for byte."""
    from jeicyboodsp_tpu_torch.oracle import enhance as port_oracle

    for n in (0, 100, 512, 1100, 40 * 512 - 77):
        x = _signal(-(-n // 512), 7, silent_blocks=8)[:n]
        for mode in ("wiener", "specsub"):
            np.testing.assert_array_equal(port_oracle.reference_enhance(x, mode), oenh.run(x, mode))


@pytest.mark.parametrize("engine", sorted(ENGINE_FLOOR))
def test_pipeline_file_end_to_end(tmp_path, engine):
    from jeicyboodsp_tpu_torch.cli import main
    from jeicyboodsp_tpu_torch.pipelines import registry

    x = _signal(*PROBES["latch64"])
    cases = {"full": x, "partial": x[: 40 * 512 + 300], "empty": x[:0], "header_only": x[:22]}
    for name, data in cases.items():
        inp = tmp_path / f"{name}.pcm"
        data.tofile(inp)
        for mode in ("wiener", "specsub"):
            out = tmp_path / f"{name}_{mode}.pcm"
            y = registry.PIPELINES[mode](str(inp), str(out), fft_engine=engine, device="cpu")
            got = np.fromfile(out, "<i2")
            np.testing.assert_array_equal(got, y)
            want = oenh.run(data, mode)  # header NOT skipped, as the reference
            assert got.shape == want.shape, (name, mode)
            if len(want):
                assert snr_db(want, got) >= ENGINE_FLOOR[engine], (name, mode)
    # the CLI is the same path
    out_cli = tmp_path / "cli.pcm"
    assert main(["wiener", str(tmp_path / "full.pcm"), str(out_cli), "--fast", "--engine",
                 engine, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(out_cli, "<i2"),
                                  np.fromfile(tmp_path / "full_wiener.pcm", "<i2"))


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_unported_engines_raise(engine):
    """Engines xla and mxu, once unported, now run (zeros in, zeros out);
    an engine the JAX package does not have raises (mxu1, once the example,
    is ported too)."""
    b = torch.zeros(4, 512, dtype=torch.int16)
    out, mask = TE.enhance_blocks(b, dtype=torch.float32, resynth="ratio", fft_engine=engine)
    assert out.shape == (4, 512) and not out.any() and mask.tolist() == [False, False, True, True]
    with pytest.raises(ValueError, match="fft_engine"):
        TE.enhance_blocks(b, fft_engine=engine + "2")
