"""CPU parity of engines mxu8 and mxu3, the two-kernel f32 engine
(``_enhance_fused``, K13) and the VAD kernel's wrapper (K14) of the PyTorch
port with the JAX package.

Seeded numpy inputs (the two 64-block probes of test_torch_enhance.py) go
through the JAX kernels K2-K5 in interpret mode and through the port's
wrappers, which run their plain PyTorch versions on CPU tensors.  The back
kernels K3 and K5 get the same JAX-made inputs on both sides.  The CUDA
kernels are held against these plain versions in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.kernels import enhance_pallas as EP
from jeicyboodsp_tpu.oracle import enhance as oenh
from jeicyboodsp_tpu.ops import enhance as JE
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.config import ENGINE_FIDELITY
from jeicyboodsp_tpu_torch.kernels import enhance_back as K13
from jeicyboodsp_tpu_torch.kernels import enhance_back_ola3 as K5
from jeicyboodsp_tpu_torch.kernels import enhance_back_ola8 as K3
from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K1
from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
from jeicyboodsp_tpu_torch.kernels import enhance_fwd_int8 as K2
from jeicyboodsp_tpu_torch.kernels import vad_flags as K14
from jeicyboodsp_tpu_torch.ops import enhance as TE
from test_torch_enhance import PROBES, _signal

F = 64  # the JAX kernels' row tile: one grid step per 64-block probe
ROW_RTOL = 1e-5  # K13's planes: of each row's max
FLOOR = {e: ENGINE_FIDELITY["enhance", e]["floor"] for e in ("mxu8", "mxu3")}  # vs the oracle
PORT_VS_JAX_DB = 90.0
MODES = ("wiener", "specsub")


def _np(xs):
    return [np.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.fixture(scope="module", params=sorted(PROBES))
def jax_parts(request):
    """JAX's K2 and K4 outputs on one probe, the latch over each, and K3 /
    K5 on those inputs for both modes."""
    x = _signal(*PROBES[request.param])
    b = jnp.asarray(x.reshape(-1, 512))
    M = JE._dft_mats_aligned()
    J = np.zeros((512, 512), np.float32)
    J[np.arange(511, 0, -1), np.arange(1, 512)] = 1.0  # as JE._enhance_fused3
    prev = jnp.concatenate([jnp.zeros((1, 512), b.dtype), b[:-1]])
    fwd = {
        "K2": EP.enhance_fwd_int8_pallas(b, JE._dft_mats_int8(), M["nyq"], M["w2"], F=F,
                                         interpret=True),
        "K4": EP.enhance_fwd_pallas(prev, b, M["WC"], M["WS"], M["nyq"], M["w2"], F=F,
                                    interpret=True),
    }
    nz = [K1.frame_nonzero(torch.from_numpy(x.reshape(-1, 512))).float()[:, None].numpy()]
    back = {}
    for name, (re, im, re_n, mag, mag_n, sp) in fwd.items():
        ns, ns_n = JE._noise_latch_parts(sp[:, 0] > 0.5, (mag, mag_n))
        ins = (re, im, re_n, ns, ns_n)
        for mode in MODES:
            if name == "K2":
                out = EP.enhance_back_ola8_pallas(*ins, JE._dft_mats_int8_back(), M["u_nyq"],
                                                  M["y512col"], J, mode=mode, F=F, interpret=True)
            else:  # f32 c_short values, cast as JE._enhance_fused3 casts them
                out = EP.enhance_back_ola3_pallas(*ins, M["UC512"], M["VS512"], M["u_nyq"],
                                                  M["y512col"], J, mode=mode, F=F,
                                                  interpret=True).astype(jnp.int16)
            back[name, mode] = _np(ins) + nz, np.asarray(out)
            if name == "K4":
                back["K13", mode] = _np(ins) + nz, _np(EP.enhance_back_pallas(
                    *ins, M["UC512"], M["VS512"], M["u_nyq"], M["y512col"], mode=mode, F=F,
                    interpret=True))
    return request.param, x, {k: _np(v) for k, v in fwd.items()}, back


def _check_fwd(name, want, got, tol):
    re, im, re_n, mag, mag_n, sp = want
    gre, gim, gre_n, gmag, gmag_n, gsp = (g.numpy() for g in got[:6])
    assert gre.shape == re.shape and gre_n.shape == re_n.shape == (re.shape[0], 1)
    np.testing.assert_array_equal(gsp, sp)  # speech flags, exactly
    for w, g, what in ((re, gre, "re"), (im, gim, "im"), (mag, gmag, "mag"),
                       (re_n, gre_n, "re_n"), (mag_n, gmag_n, "mag_n")):
        err = np.abs(g - w) / tol
        print(f"{name} {what}: max err / tolerance {err.max():.3f}")
        assert err.max() <= 1.0, what


def test_k2_plain_vs_jax_interpret(jax_parts):
    """re/im bit-for-bit up to one f32 rounding of the epilogue: XLA:CPU
    contracts s1*zh + s2*rh + ... into FMAs, the port (and its kernel, built
    with -fmad=false) rounds every product as the TPU does.  Those
    intermediates reach the size of the folded +128 shift rows (crows),
    whatever the row's own size, so the tolerance is 1e-6 of the row max
    plus the largest crow."""
    name, x, fwd, _ = jax_parts
    C = TE.enhance_constants("cpu")
    got = K2.enhance_fwd_int8(torch.from_numpy(x.reshape(-1, 512)), C)
    scale = np.abs(fwd["K2"][0]).max(1, keepdims=True) + float(C["fcrows"].abs().max())
    _check_fwd(name, fwd["K2"], got, 1e-6 * scale)


def test_k4_plain_vs_jax_interpret(jax_parts):
    """The port's f32 GEMM against JAX's bf16x3 (_dot3): in interpret mode
    _dot3 drops only the al*bl product (<= 2^-18 of |a*b|), and both sum
    in their own order, so each output is held to 2^-16 of the sum of
    |a*b| over its contraction."""
    name, x, fwd, _ = jax_parts
    C = TE.enhance_constants("cpu")
    blocks = torch.from_numpy(x.reshape(-1, 512))
    got = K4.enhance_fwd(blocks, C)
    absf = K4.frames_f32(blocks).abs().double()
    abs_re = (absf @ C["WC"].abs().double()).numpy()
    abs_n = (absf @ C["nyq"].abs().double()).numpy()[:, None]
    tol_plane = 2.0 ** -16 * np.maximum(abs_re, (absf @ C["WS"].abs().double()).numpy())
    tol_plane = tol_plane.max(1, keepdims=True)  # |X| mixes re and im
    want = fwd["K4"]
    re, im, re_n, mag, mag_n, sp = want
    tols = {"re": tol_plane, "im": tol_plane, "mag": tol_plane,
            "re_n": 2.0 ** -16 * abs_n, "mag_n": 2.0 ** -16 * abs_n}
    gre, gim, gre_n, gmag, gmag_n, gsp = (g.numpy() for g in got[:6])
    np.testing.assert_array_equal(gsp, sp)
    for w, g, what in ((re, gre, "re"), (im, gim, "im"), (mag, gmag, "mag"),
                       (re_n, gre_n, "re_n"), (mag_n, gmag_n, "mag_n")):
        err = np.abs(g - w) / tols[what]
        print(f"{name} K4 {what}: max err / tolerance {err.max():.3f}")
        assert err.max() <= 1.0, what


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_back_plain_vs_jax_interpret(jax_parts, kernel, mode):
    """K3 / K5 plain on JAX's own inputs: at most one int16 step apart
    (f32 sums in another order; K5 also f32 against bf16x3)."""
    name, _, _, back = jax_parts
    ins, want = back["K2" if kernel == "K3" else "K4", mode]
    C = TE.enhance_constants("cpu")
    if kernel == "K3":
        got = K3.enhance_back_ola8(*_t(ins), C, mode).numpy()
    else:  # JAX's K5 leaves rows t < 2 to its caller: emit them all
        got = K5.enhance_back_ola3(*_t(ins), C, mode, emit_all=True).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{name} {kernel} {mode}: max |diff| {d.max()}, differing {np.mean(d > 0):.3e}")
    assert got.dtype == np.int16 and got.shape == want.shape
    assert d.max() <= 1


@pytest.mark.parametrize("hq", [True, False], ids=["hq", "turbo"])
@pytest.mark.parametrize("mode", MODES)
def test_k3_plain_planes_rebuild_its_output(jax_parts, mode, hq):
    """K3's plain version with ``return_planes``: the same int16 output,
    which flip_ola rebuilds from uv and the y512 slot of rowsc; uv is the
    plain inverse of q8 and rowsc; q8 holds Z = 256h + l + 128 =
    rint(Y * 32512 / rowmax) (to the few f32 roundings of 32512 that the
    f32 scaling makes), and z2 only in hq."""
    name, _, _, back = jax_parts
    ins = _t(back["K2", mode][0])
    C = TE.enhance_constants("cpu")
    out, p = K3.enhance_back_ola8(*ins, C, mode, hq, return_planes=True)
    q8, rowsc, uv = p["q8"], p["rowsc"], p["uv"]
    T = out.shape[0]
    assert q8.shape == (6, T, 512) and q8.dtype == torch.int8
    assert rowsc.shape == (T, 8) and uv.shape == (2, T, 512)
    assert torch.equal(out, K3.enhance_back_ola8(*ins, C, mode, hq))
    assert torch.equal(K1.flip_ola(uv[0], uv[1], rowsc[:, 5], False), out)
    assert torch.equal(K1.inv8_plain(q8, rowsc, C, hq), uv)
    re, im, re_n, ns, ns_n, nz = ins
    g, gn = K1.bin_gain(re, im, re_n[:, 0], ns, ns_n[:, 0], nz[:, 0], mode)
    for c, Y in enumerate((re * g, im * g)):
        Z = 256 * q8[3 * c].double() + q8[3 * c + 1].double() + 128
        Yd = Y.double()
        err = (Z - Yd * 32512 / Yd.abs().amax(1, keepdim=True)).abs().max()
        assert err <= 0.5 + 32512 * 2.0 ** -21
        assert hq or (q8[3 * c + 2].eq(0).all() and rowsc[:, 2 * c + 1].eq(0).all())
    assert torch.equal(rowsc[:, 4], re_n[:, 0] * gn) and rowsc[:, 6:].eq(0).all()


@pytest.mark.parametrize("hq", [True, False], ids=["hq", "turbo"])
def test_inv8_plain_vs_jax_inv_plane8(jax_parts, hq):
    """The plain inverse pass on K3's own q8 and rowsc, with the port's
    transposed int8 bases, bit-equal to JAX's ``_inv_plane8`` on the same
    int8 planes and row scales with ``_dft_mats_int8_back``'s [k, s] bases
    (exact int32 dots, the same f32 epilogue), u with its Nyquist term.
    The CUDA pass is held bit-equal to this plain version on the card."""
    name, _, _, back = jax_parts
    C = TE.enhance_constants("cpu")
    _, p = K3.enhance_back_ola8(*_t(back["K2", "wiener"][0]), C, "wiener", hq,
                                return_planes=True)
    q8, rs, uv = p["q8"].numpy(), p["rowsc"].numpy(), p["uv"].numpy()
    M8B, u_nyq = JE._dft_mats_int8_back(), np.asarray(JE._dft_mats_aligned()["u_nyq"])
    sv, cr = M8B["scales"], M8B["crows"]
    for plane, (wh, wl) in enumerate((("Uh", "Ul"), ("Vh", "Vl"))):
        h, l, z2 = (jnp.asarray(q8[3 * plane + i]) for i in range(3))
        q, q2 = rs[:, 2 * plane:2 * plane + 1], rs[:, 2 * plane + 1:2 * plane + 2]
        want = np.asarray(EP._inv_plane8(
            h, l, M8B[wh], M8B[wl], sv[2 * plane:2 * plane + 1],
            sv[2 * plane + 1:2 * plane + 2], cr[plane:plane + 1], q,
            z2 if hq else None, q2 if hq else None, hq=hq))
        if plane == 0:
            want = want + rs[:, 4:5] * u_nyq.reshape(1, 512)
        np.testing.assert_array_equal(uv[plane].view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["mxu8", "mxu3"])
def test_fused3_vs_jax_and_oracle(jax_parts, engine, mode):
    """The port's engine against JAX ``_enhance_fused3`` (interpret mode)
    and both against the oracle.  mxu8: >= 90 dB, same int8 arithmetic.
    mxu3: one int16 step at most, on under 1% of the samples -- JAX's
    bf16x3 on XLA:CPU drops the al*bl products, the port sums in f32, and
    measured 0.67% on the latch probe in specsub (the JAX package's own
    bf16x3-vs-HIGH test allows 0.5% on its probe); the port must then be at
    least as close to the oracle as JAX."""
    name, x, _, _ = jax_parts
    b = x.reshape(-1, 512)
    oj, mj = JE._enhance_fused3(jnp.asarray(b), mode, False, interpret=True, F=F,
                                int8=(engine == "mxu8"))
    oj, mj = np.asarray(oj), np.asarray(mj)
    ot, mt = TE.enhance_blocks(torch.from_numpy(b), mode, resynth="ratio", fft_engine=engine)
    ot, mt = ot.numpy(), mt.numpy()
    np.testing.assert_array_equal(mt, mj)
    d = np.abs(ot.astype(np.int32) - oj.astype(np.int32))
    want = oenh.run(x, mode)
    snr_j, snr_t = snr_db(want, oj[mj].reshape(-1)), snr_db(want, ot[mt].reshape(-1))
    print(f"{name} {engine} {mode}: port vs JAX {snr_db(oj, ot):.2f} dB, max |diff| {d.max()}, "
          f"differing {np.mean(d > 0):.3e}; vs oracle JAX {snr_j:.2f} dB, port {snr_t:.2f} dB")
    if engine == "mxu8":
        assert snr_db(oj, ot) >= PORT_VS_JAX_DB
    else:
        assert d.max() <= 1 and np.mean(d > 0) < 0.01
        assert snr_t >= snr_j
    assert min(snr_j, snr_t) >= FLOOR[engine]


def test_in_kernel_vad_equals_vad_flags(probe_blocks):
    C = TE.enhance_constants("cpu")
    want = TE.vad_flags(probe_blocks, torch.float32)
    for fwd in (K2.enhance_fwd_int8, K4.enhance_fwd):
        sp = fwd(probe_blocks, C)[5]
        assert sp.shape == (probe_blocks.shape[0], 1)
        assert torch.equal(sp[:, 0] > 0.5, want)


@pytest.fixture(params=sorted(PROBES))
def probe_blocks(request):
    return torch.from_numpy(_signal(*PROBES[request.param]).reshape(-1, 512))


def test_noise_latch_wrapper_is_its_plain_version(probe_blocks):
    C = TE.enhance_constants("cpu")
    _, _, _, mag, mag_n, sp, _ = K2.enhance_fwd_int8(probe_blocks, C)
    rowpack = TE._latch_rowpack(sp[:, 0] > 0.5)
    before = K1.noise_latch.launches
    ns, ns_n = K1.noise_latch(rowpack, mag, mag_n)
    assert K1.noise_latch.launches == before  # CPU: the plain version, not counted
    want = K1.latch_from_rowpack(rowpack, torch.cat([mag, mag_n], 1), 64)
    assert torch.equal(ns, want[:, :512]) and torch.equal(ns_n, want[:, 512:])
    with pytest.raises(ValueError):
        K1.noise_latch(rowpack, mag, mag_n[:, 0])  # (T,) instead of (T, 1)
    with pytest.raises(ValueError):
        K1.noise_latch(rowpack[:60], mag[:60], mag_n[:60])  # T not a multiple of L


def test_run_stream_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    x = _signal(8, 1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.run_stream(x)
    from jeicyboodsp_tpu_torch.cli import main

    x.tofile(tmp_path / "in.pcm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["wiener", str(tmp_path / "in.pcm"), str(tmp_path / "out.pcm")])
    assert not (tmp_path / "out.pcm").exists()
    got = TE.run_stream(x, device="cpu")
    assert got.shape == oenh.run(x, "wiener").shape


@pytest.mark.parametrize("mode", MODES)
def test_k13_plain_vs_jax_interpret(jax_parts, mode):
    """K13's plain version on JAX's own inputs (K4's planes and the latch
    over them): head, w2 and y512 within 1e-5 of each row's max, the row
    being the frame's inverse [head, y512, w2] (head alone is rounding
    noise in row 0, whose first half frame is zeros) -- f32 against JAX's
    bf16x3, which in interpret mode drops the al*bl products (<= 2^-18 of
    each |a*b|) and sums in another order."""
    name, _, _, back = jax_parts
    ins, want = back["K13", mode]
    C = TE.enhance_constants("cpu")
    before = K13.enhance_back.launches
    got = [g.numpy() for g in K13.enhance_back(*_t(ins), C, mode)]
    assert K13.enhance_back.launches == before  # CPU: the plain version, not counted
    wrow = np.concatenate(want, 1)
    fin = np.isfinite(wrow)
    rowmax = np.where(fin, np.abs(wrow), 0).max(1, keepdims=True)
    for what, g, w in zip(("head", "w2", "y512"), got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        fin = np.isfinite(w)
        assert np.isfinite(g).all()  # no 0/0 gain in a frame that holds a sample (R23)
        rel = (np.where(fin, np.abs(g - w), 0) / np.maximum(rowmax, 1e-30)).max()
        print(f"{name} K13 {mode} {what}: max err / row max {rel:.2e}")
        assert rel <= ROW_RTOL, what


@pytest.mark.parametrize("mode", MODES)
def test_k13_zero_bins_depart_from_jax(jax_parts, mode):
    """The port's deliberate departure from JAX's K13 as written (ROADMAP
    R23), on K4's planes with bins 100-109 planted at re = im = 0: before
    the latch (ns = 0 there) JAX's gain is 0/0 = NaN and each such row of
    its outputs NaN; the port's frame flags give those bins gain 1, so its
    rows are finite.  On the latched rows the two agree, NaN masks
    included (specsub's 0 * -inf there is P8, unrepaired in both), within
    ROW_RTOL of each row's max where JAX is finite."""
    name, _, _, back = jax_parts
    re, im, re_n, ns, ns_n, nz = (np.array(a) for a in back["K13", mode][0])
    re[:, 100:110] = 0.0
    im[:, 100:110] = 0.0
    M = JE._dft_mats_aligned()
    want = _np(EP.enhance_back_pallas(
        *(jnp.asarray(a) for a in (re, im, re_n, ns, ns_n)), M["UC512"], M["VS512"],
        M["u_nyq"], M["y512col"], mode=mode, F=F, interpret=True))
    got = [g.numpy() for g in K13.enhance_back(*_t((re, im, re_n, ns, ns_n, nz)),
                                               TE.enhance_constants("cpu"), mode)]
    wrow, grow = np.concatenate(want, 1), np.concatenate(got, 1)
    pre = (ns[:, 100:110] == 0).all(1)
    print(f"{name} K13 {mode}: {int(pre.sum())} rows before the latch")
    assert pre.any() and nz.all()
    assert np.isnan(wrow[pre]).any(1).all() and np.isfinite(grow[pre]).all()
    np.testing.assert_array_equal(np.isfinite(grow[~pre]), np.isfinite(wrow[~pre]))
    fin = np.isfinite(wrow).all(1)
    rowmax = np.abs(wrow[fin]).max(1, keepdims=True)
    assert (np.abs(grow[fin] - wrow[fin]) <= ROW_RTOL * np.maximum(rowmax, 1e-30)).all()


@pytest.fixture(scope="module", params=sorted(PROBES))
def jax_fused(request):
    x = _signal(*PROBES[request.param])
    out = {}
    for mode in MODES:
        o, m = JE._enhance_fused(jnp.asarray(x.reshape(-1, 512)), mode, False, interpret=True)
        out[mode] = np.asarray(o), np.asarray(m)
    return request.param, x, out


@pytest.mark.parametrize("mode", MODES)
def test_enhance_fused_vs_jax_and_oracle(jax_fused, mode):
    """The port's two-kernel f32 engine against JAX ``_enhance_fused``
    (interpret mode): masks equal, one int16 step at most, on under 1% of
    the samples, and >= 90 dB, unless JAX itself is below 90 dB from the
    oracle -- its bf16x3 on XLA:CPU drops the al*bl products, and on the
    latch probe in specsub it reads 86.7 dB against the port's 99.5 -- in
    which case the port must be at least as close to the oracle as JAX;
    both >= 60 dB against the oracle (test_pallas_kernels.py:230)."""
    name, x, out = jax_fused
    oj, mj = out[mode]
    ot, mt = TE._enhance_fused(torch.from_numpy(x.reshape(-1, 512)), mode, False)
    ot, mt = ot.numpy(), mt.numpy()
    np.testing.assert_array_equal(mt, mj)
    assert ot.dtype == np.int16 and ot.shape == oj.shape
    d = np.abs(ot.astype(np.int32) - oj.astype(np.int32))
    want = oenh.run(x, mode)
    snr_j, snr_t = snr_db(want, oj[mj].reshape(-1)), snr_db(want, ot[mt].reshape(-1))
    print(f"{name} _enhance_fused {mode}: port vs JAX {snr_db(oj, ot):.2f} dB, max |diff| "
          f"{d.max()}, differing {np.mean(d > 0):.3e}; vs oracle JAX {snr_j:.2f}, port {snr_t:.2f}")
    assert d.max() <= 1 and np.mean(d > 0) < 0.01
    assert snr_db(oj, ot) >= PORT_VS_JAX_DB or (snr_j < PORT_VS_JAX_DB and snr_t >= snr_j)
    assert min(snr_j, snr_t) >= 60.0
    ea, _ = TE._enhance_fused(torch.from_numpy(x.reshape(-1, 512)), mode, True)
    assert torch.equal(ea[2:], torch.from_numpy(ot[2:])) and ea[0].eq(0).all()


def _vad_probe():
    """The 40-block speech probe of test_pallas_kernels.py:198-213, and rows
    at the energy and ZCR thresholds for the port's f32 window and for the
    f64-built w2 (torch_inputs.vad_threshold_rows)."""
    from torch_inputs import vad_threshold_rows

    rng = np.random.default_rng(8)
    n = 512 * 24
    t = np.arange(n) / 16000
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (t > 0.4)
    x = np.clip(sp + rng.normal(0, 20, n), -32768, 32767).astype(np.int16).reshape(-1, 512)
    w32 = TE._vad_window(torch.device("cpu")).numpy()
    w64 = JE._dft_mats_aligned()["w2"]
    zeros = np.zeros((4, 512), np.int16)  # 40 rows: 5 grid steps of the JAX kernel's F = 8
    return np.concatenate([x, zeros, vad_threshold_rows(w32),
                           vad_threshold_rows(w64)]), w64


def test_vad_flags_vs_jax_at_the_thresholds():
    """``ops.enhance.vad_flags`` (the K14 wrapper with the port's own f32
    window) against JAX ``vad_flags(..., float32)``, and the wrapper with
    the f64-built w2 against the Pallas kernel in interpret mode: equal
    flags, including rows whose sum(s^2) is 700*1024 - 1, + 0, + 1 and rows
    with ZCR 199, 200, 201.  The two f32 windows differ by one ulp in 17
    of 512 values (torch.cos against XLA's cos); no flag here depends on
    that."""
    rows, w64 = _vad_probe()
    blocks = torch.from_numpy(rows)
    got = TE.vad_flags(blocks, torch.float32).numpy()
    np.testing.assert_array_equal(got, np.asarray(JE.vad_flags(jnp.asarray(rows), jnp.float32)))
    np.testing.assert_array_equal(got[-12:], [False, False, True, True, False, False] * 2)
    before = K14.vad_flags.launches
    got64 = K14.vad_flags(blocks, torch.from_numpy(w64))
    assert K14.vad_flags.launches == before  # CPU: the plain version, not counted
    assert got64.dtype == torch.bool and got64.shape == (len(rows),)
    want64 = np.asarray(EP.vad_flags_pallas(jnp.asarray(rows), w64, F=8, interpret=True))
    np.testing.assert_array_equal(got64.numpy(), want64[:, 0] > 0.5)
    np.testing.assert_array_equal(got64[-6:].numpy(), [False, False, True, True, False, False])


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "w2", "noncontig", "device"])
def test_vad_wrapper_rejects(bad):
    cur, w2 = torch.zeros(8, 512, dtype=torch.int16), torch.ones(512)
    if bad == "dtype":
        cur = cur.to(torch.int32)
    elif bad == "width":
        cur = cur[:, :256]
    elif bad == "rows":
        cur = cur[:0]
    elif bad == "w2":
        w2 = w2.double()
    elif bad == "noncontig":
        cur = torch.zeros(512, 8, dtype=torch.int16).t()
    elif bad == "device":
        cur = cur.to("meta")
    with pytest.raises(ValueError):
        K14.vad_flags(cur, w2)
