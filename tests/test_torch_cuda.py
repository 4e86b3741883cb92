"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' contract.  Imports neither jax nor the JAX package, so it runs on
a card's host that has no jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernel tests skip, with the reason, where there is no CUDA device; the
wrapper and build tests run everywhere.
"""

import os
import stat

import numpy as np
import pytest
import torch

from chip_smoke import k4_f64_bases, make_signal
from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels import enhance_back_ola3 as K5
from jeicyboodsp_tpu_torch.kernels import enhance_back_ola8 as K3
from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K
from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
from jeicyboodsp_tpu_torch.kernels import enhance_fwd_int8 as K2
from jeicyboodsp_tpu_torch.config import ENGINE_FIDELITY
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.oracle.cnum import c_short
from jeicyboodsp_tpu_torch.utils.metrics import snr_db

KERNEL_VS_PLAIN_DB = 90.0
FIDELITY = {e: ENGINE_FIDELITY[("enhance", e)]["floor"] for e in ("mxu3", "mxu8", "mxu8f", "mxu8t")}
FWD = {"K2": (K2.enhance_fwd_int8, K2.enhance_fwd_int8_plain),
       "K4": (K4.enhance_fwd, K4.enhance_fwd_plain)}
BACK = {"K3": (K3.enhance_back_ola8, K3.enhance_back_ola8_plain, "K2"),
        "K5": (K5.enhance_back_ola3, K5.enhance_back_ola3_plain, "K4")}


def _signal(n_blocks, seed):
    return make_signal(n_blocks * 512, np.random.default_rng(seed))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n_blocks=512, seed=3):
    blocks = torch.from_numpy(_signal(n_blocks, seed).reshape(-1, 512)).to(device)
    rowpack = E._latch_rowpack(E.vad_flags(blocks, torch.float32))
    return blocks, rowpack, E.enhance_constants(device)


@pytest.mark.parametrize("hq", [True, False], ids=["mxu8f", "mxu8t"])
@pytest.mark.parametrize("mode", ["wiener", "specsub"])
def test_kernel_matches_plain(cuda, mode, hq):
    blocks, rowpack, C = _inputs(cuda)
    assert rowpack[:, 2].max() >= 0  # the probe reaches the noise latch
    before = K.enhance_full8.launches
    got, pk = K.enhance_full8(blocks, rowpack, C, mode, hq, return_planes=True)
    want, pp = K.enhance_full8_plain(blocks, rowpack, C, mode, hq, return_planes=True)
    torch.cuda.synchronize()
    assert K.enhance_full8.launches == before + 1
    for k in ("re", "im"):  # same exact int dots and f32 epilogue order
        rel = (pk[k] - pp[k]).abs().amax(1) / pp[k].abs().amax(1)
        assert rel.max().item() <= 1e-6, k
    assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= KERNEL_VS_PLAIN_DB


def _unit_gain_rows(blocks, drop):
    """The reference's float64 chain (its Hamming window, FFT, OLA and
    double -> short store) with gain 1 on every bin but ``drop`` and their
    mirrors, which contribute 0: what the chain writes before the first
    latch (ns = 0) where those bins of its spectrum are exactly 0.  Rows
    t >= 2, int16."""
    x = blocks.cpu().numpy().astype(np.float64)
    prev = np.vstack([np.zeros((1, 512)), x[:-1]])
    w = 0.54 - 0.46 * np.cos(2.0 * 3.141592 * np.arange(1024) / 1023)
    X = np.fft.fft(np.hstack([prev, x]) * w, axis=1)
    X[:, drop] = 0.0
    X[:, 1024 - drop] = 0.0
    y = np.fft.ifft(X, axis=1).real
    return c_short(y[1:-1, 512:] + y[2:, :512])


def _before_latch(rowpack):
    """The rows before the first latch (ns = 0 on every bin there)."""
    latched = (rowpack[:, 2] >= 0).nonzero()
    return int(latched[0]) if len(latched) else rowpack.shape[0]


ZERO_BINS = np.arange(100, 110)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_zero_bins_take_gain_one_and_zero_no_row(device, request):
    """Bins with re = im = 0 before any latch, in frames that hold nonzero
    samples: the Wiener gain's 0/0 takes gain 1 there (``bin_gain``), so
    each such bin contributes its 0 and the rest of the frame passes with
    gain 1 -- the reference's answer, whose float64 spectrum has no zero
    bin there.  (The TPU kernel as written makes the gain NaN and zeroes
    those rows: ROADMAP R23.)  Held against the reference's float64 chain
    with those bins dropped, at each engine's floor, no row zeroed; on the
    card, K1 against its plain version."""
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    blocks, rowpack, C = _inputs(dev, n_blocks=64)
    C = dict(C, fscales=C["fscales"].clone(), fcrows=C["fcrows"].clone())
    C["fscales"][:, ZERO_BINS] = 0.0  # re = im = 0 on bins 100..109
    C["fcrows"][:, ZERO_BINS] = 0.0
    end = _before_latch(rowpack)
    assert end > 32
    want = _unit_gain_rows(blocks, ZERO_BINS)[: end - 2]
    for hq, floor in ((True, FIDELITY["mxu8f"]), (False, FIDELITY["mxu8t"])):
        out = K.enhance_full8(blocks, rowpack, C, "wiener", hq, emit_all=True)
        got = out.cpu().numpy()[2:end]
        assert not (got == 0).all(1).any()
        assert snr_db(want, got) >= floor
        if device == "cuda":
            plain = K.enhance_full8_plain(blocks, rowpack, C, "wiener", hq, emit_all=True)
            assert snr_db(plain.cpu().numpy(), out.cpu().numpy()) >= KERNEL_VS_PLAIN_DB


def test_kernel_emit_all_and_odd_lengths(cuda):
    """enhance_blocks pads T to a multiple of 64 and masks warm-up rows."""
    for T in (3, 65, 200):
        blocks = torch.from_numpy(_signal(T, T).reshape(-1, 512)).to(cuda)
        kw = dict(emit_all=True, resynth="ratio", fft_engine="mxu8f")
        out, mask = E.enhance_blocks(blocks, "wiener", **kw)
        out_c, mask_c = E.enhance_blocks(blocks.cpu(), "wiener", **kw)
        assert out.shape == (T, 512) and mask.tolist() == mask_c.tolist()
        assert out[:1].eq(0).all()
        assert snr_db(out_c[2:].numpy(), out[2:].cpu().numpy()) >= KERNEL_VS_PLAIN_DB


def test_cpu_runs_plain_without_counting():
    blocks, rowpack, C = _inputs("cpu", n_blocks=64)
    before = K.enhance_full8.launches
    out = K.enhance_full8(blocks, rowpack, C, "wiener", True)
    assert K.enhance_full8.launches == before
    assert torch.equal(out, K.enhance_full8_plain(blocks, rowpack, C, "wiener", True))


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "rowpack", "mode", "const",
                                 "noncontig", "device"])
def test_wrapper_rejects(bad):
    blocks, rowpack, C = _inputs("cpu", n_blocks=64)
    mode = "wiener"
    if bad == "dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "width":
        blocks = blocks[:, :256]
    elif bad == "rows":
        blocks, rowpack = blocks[:60], rowpack[:60]
    elif bad == "rowpack":
        rowpack = rowpack[:, :4]
    elif bad == "mode":
        mode = "mmse"
    elif bad == "const":
        C = dict(C, fwd8=C["fwd8"].to(torch.int16))
    elif bad == "noncontig":
        blocks = blocks.t().contiguous().t()
    elif bad == "device":
        blocks = blocks.to("meta")
    with pytest.raises(ValueError):
        K.enhance_full8(blocks, rowpack, C, mode)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback: a compiler error surfaces with its stderr."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="sm_90a refused"):
        _build._compile(str(tmp_path / "build" / "lib.so"))
    assert not os.listdir(tmp_path / "build")


def test_library_path_keys_on_sources():
    p = _build.library_path()
    assert p.startswith(_build.BUILD) and p.endswith(".so")
    assert p == _build.library_path()


def _rel(got, want):
    """max over rows of the max error over the row's max (0 on zero rows)"""
    return ((got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-30)).max().item()


def _back_inputs(fwd_name, blocks, C, L=64):
    """K3 / K5 inputs from a forward kernel's outputs and the noise latch
    (in chunks of L rows: T a multiple of L)."""
    re, im, re_n, mag, mag_n, sp, nz = FWD[fwd_name][0](blocks, C)
    ns, ns_n = K.noise_latch(E._latch_rowpack(sp[:, 0] > 0.5, L), mag, mag_n, L)
    return re, im, re_n, ns, ns_n, nz


@pytest.mark.parametrize("name", sorted(FWD))
def test_forward_kernels_match_plain(cuda, name):
    """K2's planes are bit-equal to the plain version (exact int dots, the
    same f32 epilogue).  K4's f32 sums may run in another order than the
    plain matmul's (cuBLAS may split K): each output within 2^-16 of the
    sum of |a*b| over its contraction.  Flags equal."""
    blocks, _, C = _inputs(cuda)
    kernel, plain = FWD[name]
    before = kernel.launches
    got, want = kernel(blocks, C), plain(blocks, C)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert torch.equal(got[5], want[5]) and torch.equal(got[6], want[6])
    absf = K4.frames_f32(blocks).abs().double()
    scale = torch.maximum(absf @ C["WC"].abs().double(), absf @ C["WS"].abs().double())
    tol = 2.0 ** -16 * scale.amax(1, keepdim=True)  # |X| mixes re and im
    for i in (0, 1, 3):  # re, im, |X|
        if name == "K2":
            assert torch.equal(got[i], want[i]), i
        else:
            assert ((got[i] - want[i]).abs() <= tol).all(), i
    tol_n = 2.0 ** -16 * (absf @ C["nyq"].abs().double())[:, None]
    assert ((got[2] - want[2]).abs() <= tol_n).all()  # the Nyquist bin, an f32 dot


def _k4_blocks(T, seed):
    """(T, 512) int16 blocks of the chain's signal with rows 4 and 5 digital
    silence (frame 5 all zero), a quiet row 6 (samples in -3..3) beside a
    full-scale random row 7; the rows wrap for T < 8."""
    rng = np.random.default_rng(seed)
    x = _signal(max(T, 8), seed).reshape(-1, 512)
    x[4:6] = 0
    x[6] = rng.integers(-3, 4, 512)
    x[7] = rng.integers(-32768, 32768, 512)
    return torch.from_numpy(x[:T].copy())


def _k4_row_scale(blocks, C, double_bases=None):
    """(T, 1) f64: each row's largest sum of |a*b| over K4's contraction, with
    the f32 bases of C (or the given f64 ones)."""
    WC, WS = double_bases or (C["WC"].double(), C["WS"].double())
    a = K4.frames_f32(blocks).abs().double()
    return torch.maximum(a @ WC.abs(), a @ WS.abs()).amax(1, keepdim=True)


@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd-offset"])
@pytest.mark.parametrize("T", [8, 200, 16392])
def test_k4_fft_pass_rows_and_offsets(cuda, T, odd):
    """K4's real-FFT pass (8 frames a block) at T = 8, 200 and 16392, on
    blocks that start 16-byte aligned or at an odd 2-byte offset: re, im and
    |X| within 2^-16 of each row's largest sum of |a*b| of the plain
    version, the speech and frame flags and the all-zero frame's zeros
    exact."""
    C = E.enhance_constants(cuda)
    blocks = _k4_blocks(T, T).to(cuda)
    if odd:
        buf = torch.zeros(blocks.numel() + 1, dtype=torch.int16, device=cuda)
        buf[1:] = blocks.reshape(-1)
        blocks = buf[1:].view(T, 512)
        assert blocks.data_ptr() % 4
    before = K4.enhance_fwd.launches
    got, want = K4.enhance_fwd(blocks, C), K4.enhance_fwd_plain(blocks, C)
    torch.cuda.synchronize()
    assert K4.enhance_fwd.launches == before + 1
    assert torch.equal(got[5], want[5]) and torch.equal(got[6], want[6])
    tol = 2.0 ** -16 * _k4_row_scale(blocks, C)
    for i in (0, 1, 3):  # re, im, |X|
        err = (got[i].double() - want[i].double()).abs()
        assert (err <= tol).all(), (i, float((err / tol.clamp_min(1e-30)).max()))
    if T >= 8:
        assert got[0][5].eq(0).all() and got[1][5].eq(0).all() and got[3][5].eq(0).all()


def test_k4_fft_pass_against_f64(cuda):
    """K4's re and im against f64 products of the frames and the f64
    window-folded bases, within 2^-18 of each row's largest sum of |a*b|:
    the f32 FFT keeps about 2^-21 of it, and a wrong twiddle or a lost term
    of the split would miss by orders of magnitude.  re, im and |X| within
    1e-5 of each plane's row max of the f64 values (chip_smoke.F32_RTOL)."""
    C = E.enhance_constants(cuda)
    blocks = _k4_blocks(1024, 21).to(cuda)
    WC, WS = k4_f64_bases(cuda)
    frames = K4.frames_f32(blocks).double()
    got = K4.enhance_fwd(blocks, C)
    torch.cuda.synchronize()
    tol = 2.0 ** -18 * _k4_row_scale(blocks, C, (WC, WS))
    exact = (frames @ WC, frames @ WS)
    for i in (0, 1):
        err = (got[i].double() - exact[i]).abs()
        assert (err <= tol).all(), (i, float((err / tol.clamp_min(1e-30)).max()))
    exact += (torch.sqrt(exact[0] ** 2 + exact[1] ** 2),)
    for i, w in zip((0, 1, 3), exact):
        assert _rel(got[i].double(), w) <= 1e-5, i


@pytest.mark.parametrize("T", [64, 192, 200, 16384])
def test_int8_forward_pass_bit_equal(cuda, T):
    """The tensor-core forward pass that K1 and K2 share: K2's re/im planes
    and K1's forward planes bit-equal to their plain versions, at T = 200 a
    ragged last row tile (K2 only: K1 takes T a multiple of 64), and K2
    the same from a view that starts off a 16-byte boundary."""
    blocks = torch.from_numpy(_signal(T, T).reshape(-1, 512)).to(cuda)
    C = E.enhance_constants(cuda)
    got, want = K2.enhance_fwd_int8(blocks, C), K2.enhance_fwd_int8_plain(blocks, C)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    buf = torch.zeros(blocks.numel() + 1, dtype=torch.int16, device=cuda)
    buf[1:] = blocks.reshape(-1)
    odd = buf[1:].view(blocks.shape)
    assert odd.data_ptr() % 16
    got_odd = K2.enhance_fwd_int8(odd, C)
    assert all(torch.equal(a, b) for a, b in zip(got_odd, got))
    if T % 64 == 0:
        rowpack = E._latch_rowpack(E.vad_flags(blocks, torch.float32))
        _, pk = K.enhance_full8(blocks, rowpack, C, "wiener", True, return_planes=True)
        _, pp = K.enhance_full8_plain(blocks, rowpack, C, "wiener", True, return_planes=True)
        torch.cuda.synchronize()
        assert torch.equal(pk["re"], pp["re"]) and torch.equal(pk["im"], pp["im"])


@pytest.mark.parametrize("hq", [True, False], ids=["hq", "turbo"])
@pytest.mark.parametrize("T", [64, 200, 16384])
def test_int8_inverse_pass_bit_equal(cuda, T, hq):
    """The tensor-core inverse pass that K1 and K3 share: uv bit-equal to
    the plain inverse (inv8_plain) of the kernels' own q8 and rowsc, on the
    card -- exact int32 sums and the same f32 epilogue order.  K3 also at
    T = 200, a ragged last row tile (K1 takes T a multiple of 64)."""
    blocks = torch.from_numpy(_signal(T, T).reshape(-1, 512)).to(cuda)
    C = E.enhance_constants(cuda)
    runs = {"K3": K3.enhance_back_ola8(*_back_inputs("K2", blocks, C, 8), C, "wiener", hq,
                                       return_planes=True)}
    if T % 64 == 0:
        rowpack = E._latch_rowpack(E.vad_flags(blocks, torch.float32))
        runs["K1"] = K.enhance_full8(blocks, rowpack, C, "wiener", hq, return_planes=True)
    for name, (_, p) in runs.items():
        got = p["uv"].view(torch.int32)
        want = K.inv8_plain(p["q8"], p["rowsc"], C, hq).view(torch.int32)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{name}: {int((got != want).sum())} of {got.numel()} differ"


@pytest.mark.parametrize("engine", ["mxu8", "mxu8f", "mxu8t"])
def test_int8_engines_equal_their_cpu_runs(cuda, engine):
    """On the 192-block probe the int8 engines' int16 output on the card is
    its CPU run's (the plain versions') but for at most 8 of the 98,304
    samples, each one step apart.  The forward planes are bit-equal (above),
    so is the inverse pass on its own q8 and rowsc
    (test_int8_inverse_pass_bit_equal), and the plain quantization divides
    32512 and 127 by the row maxima as the kernels do (it multiplied by a
    reciprocal before, which flipped up to 0.1% of the samples); what is
    left are the sums taken in another order on the card: the y512 column
    (the tail that each row's first sample adds) and, in K1, the Nyquist
    bin, which feeds the gain of the row.
    On the card this probe gives 0 (mxu8, mxu8f) and 1 (mxu8t) differing
    samples; chip_smoke.py prints the q8 bytes that differ at T = 16384."""
    blocks = torch.from_numpy(_signal(192, 5).reshape(-1, 512))
    kw = dict(resynth="ratio", fft_engine=engine)
    out, mask = E.enhance_blocks(blocks.to(cuda), "wiener", **kw)
    out_c, mask_c = E.enhance_blocks(blocks, "wiener", **kw)
    torch.cuda.synchronize()
    d = (out.cpu().int() - out_c.int()).abs()
    assert torch.equal(mask.cpu(), mask_c)
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 8


def test_compat_path_on_card(cuda):
    """The compat path on the card: f64 xla within one int16 step of its CPU
    run on under 0.1% of the samples; f32 xla >= 95 dB and mxu >= 90 dB
    against the CPU's f64 run, with the log-depth scan."""
    x = _signal(64, 11)
    cpu = E.run_stream(x, "wiener", device="cpu")
    got = E.run_stream(x, "wiener", device=cuda)
    d = np.abs(got.astype(np.int32) - cpu.astype(np.int32))
    assert got.shape == cpu.shape and d.max() <= 1 and np.mean(d > 0) < 1e-3
    for engine, floor in (("xla", 95.0), ("mxu", 90.0)):
        f32 = E.run_stream(x, "wiener", dtype=torch.float32, use_assoc_scan=True,
                           fft_engine=engine, device=cuda)
        assert snr_db(cpu, f32) >= floor, engine


def test_noise_latch_kernel_matches_plain(cuda):
    blocks, _, C = _inputs(cuda)
    _, _, _, mag, mag_n, sp, _ = K2.enhance_fwd_int8(blocks, C)
    rowpack = E._latch_rowpack(sp[:, 0] > 0.5)
    assert rowpack[:, 2].max() >= 0  # the probe reaches the latch
    before = K.noise_latch.launches
    ns, ns_n = K.noise_latch(rowpack, mag, mag_n)
    want = K.latch_from_rowpack(rowpack, torch.cat([mag, mag_n], 1), 64)
    torch.cuda.synchronize()
    assert K.noise_latch.launches == before + 1
    assert (ns - want[:, :512]).abs().max() <= 1e-6 * want.abs().max()
    assert (ns_n - want[:, 512:]).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("emit_all", [False, True])
@pytest.mark.parametrize("mode", ["wiener", "specsub"])
@pytest.mark.parametrize("name", sorted(BACK))
def test_back_kernels_match_plain(cuda, name, mode, emit_all):
    blocks, _, C = _inputs(cuda)
    kernel, plain, fwd = BACK[name]
    ins = _back_inputs(fwd, blocks, C)
    before = kernel.launches
    got = kernel(*ins, C, mode, emit_all=emit_all)
    want = plain(*ins, C, mode, emit_all=emit_all)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert got[:1].eq(0).all() and (emit_all or got[:2].eq(0).all())
    assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= KERNEL_VS_PLAIN_DB


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", sorted(BACK))
def test_back_zero_bins_take_gain_one_and_zero_no_row(name, device, request):
    """Bins with re = im = 0 before any latch, with the forward kernel's
    frame flags: the Wiener gain's 0/0 takes gain 1 in a frame that holds
    nonzero samples, so each planted bin contributes 0 and the rest of the
    frame passes with gain 1, the reference's answer (the TPU kernels as
    written make the gain NaN and the rows zeros: ROADMAP R23).  Held against the reference's float64 chain with
    those bins dropped, at the engine's floor, no row zeroed; on the card,
    K3 and K5 against their plain versions."""
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    blocks, _, C = _inputs(dev, n_blocks=64)
    kernel, plain, fwd = BACK[name]
    re, im, re_n, mag, mag_n, sp, nz = FWD[fwd][1](blocks, C)
    assert nz.eq(1.0).all()
    re, im, mag = re.clone(), im.clone(), mag.clone()
    for plane in (re, im, mag):
        plane[:, ZERO_BINS] = 0.0
    rowpack = E._latch_rowpack(sp[:, 0] > 0.5)
    ns, ns_n = K.noise_latch(rowpack, mag, mag_n)
    out = kernel(re, im, re_n, ns, ns_n, nz, C, "wiener", emit_all=True)
    end = _before_latch(rowpack)
    assert end > 32
    got = out.cpu().numpy()[2:end]
    assert not (got == 0).all(1).any()
    floor = FIDELITY["mxu8" if name == "K3" else "mxu3"]
    assert snr_db(_unit_gain_rows(blocks, ZERO_BINS)[: end - 2], got) >= floor
    if device == "cuda":
        want = plain(re, im, re_n, ns, ns_n, nz, C, "wiener", emit_all=True)
        assert snr_db(want.cpu().numpy(), out.cpu().numpy()) >= KERNEL_VS_PLAIN_DB


@pytest.mark.parametrize("engine", ["mxu8", "mxu3"])
def test_fused3_odd_lengths(cuda, engine):
    """enhance_blocks pads T to a multiple of 64 and masks warm-up rows.
    Against the CPU run at most one int16 step apart on under 0.5% of the
    samples: f32 sums run in other orders there (in K5's GEMMs above all),
    and on these short quiet probes one flipped step is already ~53 dB."""
    for T in (3, 65, 200):
        blocks = torch.from_numpy(_signal(T, T).reshape(-1, 512)).to(cuda)
        for emit_all in (False, True):
            kw = dict(emit_all=emit_all, resynth="ratio", fft_engine=engine)
            out, mask = E.enhance_blocks(blocks, "wiener", **kw)
            out_c, mask_c = E.enhance_blocks(blocks.cpu(), "wiener", **kw)
            assert out.shape == (T, 512) and mask.tolist() == mask_c.tolist()
            assert out[:1].eq(0).all() and (emit_all or out[:2].eq(0).all())
            d = (out.cpu().to(torch.int32) - out_c.to(torch.int32)).abs()
            assert d.max() <= 1 and d.gt(0).double().mean() < 0.005


def test_new_cpu_wrappers_run_plain_without_counting():
    blocks, _, C = _inputs("cpu", n_blocks=64)
    for name, (kernel, plain) in FWD.items():
        before = kernel.launches
        got = kernel(blocks, C)
        assert kernel.launches == before, name
        assert all(torch.equal(g, w) for g, w in zip(got, plain(blocks, C))), name
    for name, (kernel, plain, fwd) in BACK.items():
        ins = _back_inputs(fwd, blocks, C)
        before = kernel.launches
        got = kernel(*ins, C, "specsub")
        assert kernel.launches == before, name
        assert torch.equal(got, plain(*ins, C, "specsub")), name


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "const", "noncontig", "device"])
@pytest.mark.parametrize("name", sorted(FWD))
def test_forward_wrappers_reject(name, bad):
    blocks, _, C = _inputs("cpu", n_blocks=64)
    if bad == "dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "width":
        blocks = blocks[:, :256]
    elif bad == "rows":
        blocks = blocks[:60]  # not a multiple of 8
    elif bad == "const":
        C = dict(C, nyq=C["nyq"][:512])
    elif bad == "noncontig":
        blocks = blocks.t().contiguous().t()
    elif bad == "device":
        blocks = blocks.to("meta")
    with pytest.raises(ValueError):
        FWD[name][0](blocks, C)


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "column", "flags", "mode", "const",
                                 "noncontig", "device"])
@pytest.mark.parametrize("name", sorted(BACK))
def test_back_wrappers_reject(name, bad):
    blocks, _, C = _inputs("cpu", n_blocks=64)
    kernel, _, fwd = BACK[name]
    re, im, re_n, ns, ns_n, nz = _back_inputs(fwd, blocks, C)
    mode = "wiener"
    if bad == "dtype":
        re = re.double()
    elif bad == "width":
        ns = ns[:, :256]
    elif bad == "rows":
        re, im, re_n, ns, ns_n, nz = (v[:60] for v in (re, im, re_n, ns, ns_n, nz))
    elif bad == "column":
        ns_n = ns_n[:, 0]
    elif bad == "flags":
        nz = nz[:, 0] > 0.5  # (T,) bool instead of the forward's (T, 1) f32
    elif bad == "mode":
        mode = "mmse"
    elif bad == "const":
        C = dict(C, y512col=C["y512col"][:512])
    elif bad == "noncontig":
        im = im.t().contiguous().t()
    elif bad == "device":
        re = re.to("meta")
    with pytest.raises(ValueError):
        kernel(re, im, re_n, ns, ns_n, nz, C, mode)


# ---- the GEQ (K6, K7) and the echo cancellers (K8, K9) ----------------------

from jeicyboodsp_tpu_torch.kernels import bnlms as K9  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import geq_cascade as K7  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import geq_cascade_quant as K6  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import nlms as K8  # noqa: E402
from jeicyboodsp_tpu_torch.ops import geq as G  # noqa: E402


def _geq_coef(dtype=np.float64):
    return torch.from_numpy(K7.pack_coefficients(*G.geq_coefficients(), dtype))


def _int16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-32768, 32768, shape).astype(np.int16))


def _echo_pair(B, T, seed):
    """Far ends N(0, 3000) and their echoes (lead tap 0.5) plus noise."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 3000, (B, T)), -32768, 32767)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    r = np.stack([np.convolve(xi, h)[:T] for xi in x]) + rng.normal(0, 50, (B, T))
    return (torch.from_numpy(x.astype(np.int16)),
            torch.from_numpy(np.clip(r, -32768, 32767).astype(np.int16)))


GEQ_CASES = [(B, T) for B in (1, 3, 4, 5, 2049, 3072) for T in (1, 5, 6, 7, 255, 256, 257)]
GEQ_F32_CASES = [(B, T) for B in (1, 5, 2049, 3072) for T in (1, 13, 257)]


@pytest.mark.parametrize("B,T,dtype", [(B, T, "f64") for B, T in GEQ_CASES + [(37, 1000), (3072, 300)]]
                         + [(B, T, "f32") for B, T in GEQ_F32_CASES])
def test_geq_quant_kernel_matches_plain(cuda, B, T, dtype):
    """K6 bit-equal to its plain version, in f64 and in its f32 instance, for
    odd B and T (T = 1 .. 13 shorter than or at the skew's 12-step lag,
    ragged groups of 4 streams a warp), wrapping input, and B = 3072, where
    the JAX op raises; from a nonzero state and threaded across two calls."""
    x = _int16((B, T), B + T).to(cuda)
    st = (_int16((B, K6.BANDS, 4), B) // 64).to(cuda)
    coef = _geq_coef(np.float64 if dtype == "f64" else np.float32).to(cuda)
    before = K6.geq_cascade_quant.launches
    y1, s1 = K6.geq_cascade_quant(x[:, : T // 2].contiguous(), coef, st)
    y2, s2 = K6.geq_cascade_quant(x[:, T // 2:].contiguous(), coef, s1)
    yw, sw = K6.geq_cascade_quant(x, coef, st)
    torch.cuda.synchronize()
    assert K6.geq_cascade_quant.launches == before + 2 + (T // 2 > 0)
    want, want_s = K6.geq_cascade_quant_plain(x, coef, st)
    assert torch.equal(yw, want) and torch.equal(sw, want_s)
    assert torch.equal(torch.cat([y1, y2], 1), yw) and torch.equal(s2, sw)


def test_geq_quant_kernel_unbounded_coefficients(cuda):
    """Coefficients whose sums break K6's bound (sum |coef| * 32768 >= 2^30)
    run with c_short's range compares: sums beyond int32 give 0, as the
    reference's cvttsd2si does, bit-equal to the plain version."""
    x = _int16((5, 300), 21).to(cuda)
    coef = (_geq_coef() * 1e5).to(cuda)
    y, s = K6.geq_cascade_quant(x, coef)
    want, want_s = K6.geq_cascade_quant_plain(x, coef, K6.init_state(5, cuda))
    torch.cuda.synchronize()
    assert torch.equal(y, want) and torch.equal(s, want_s)
    assert 0.1 < want.eq(0).float().mean() < 0.9  # sums in and beyond int32 both


GEQ_LINEAR_CASES = [(B, T) for B in (1, 5, 64, 2049) for T in (1, 5, 12, 13, 255, 256, 257, 2048)]


@pytest.mark.parametrize("B,T", GEQ_LINEAR_CASES + [(5, 777)])
def test_geq_linear_kernel_matches_plain(cuda, B, T):
    """K7 bit-equal to its plain version: the same f32 ops in the same order,
    no FMA contraction (-fmad=false), for ragged B and T up to and past the
    skew's 12-step lag.  Stream 0 holds an infinity and a value whose
    products overflow f32 past its middle: inf and NaN must propagate as in
    the plain version (equal NaN masks, the rest bit-equal)."""
    x = (_int16((B, T), T).float() * 0.5).to(cuda)
    x[0, T // 2] = float("inf")
    if T > 2:
        x[0, T // 2 + 1] = 3e38
    coef = _geq_coef(np.float32).to(cuda)
    before = K7.geq_cascade.launches
    got = K7.geq_cascade(x, coef)
    torch.cuda.synchronize()
    assert K7.geq_cascade.launches == before + 1
    want = K7.geq_cascade_plain(x, coef)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    if B > 1:
        assert got[1:].isfinite().all()


NLMS_CASES = [(B, T) for B in (1, 5, 1025) for T in (1, 31, 32, 33, 255, 256, 257)]


def _nlms_state(B, seed):
    """A nonzero history and small coefficients, every fifth one -0.0; stream
    0 holds only +-0 coefficients and a negative history, so with x < 0 and
    ref = 0 its errors stay 0 and its updates are -0 (IEEE's -0 / d)."""
    rng = np.random.default_rng(seed)
    coef = torch.from_numpy(rng.normal(0, 1e-3, (B, K8.TAPS)))
    coef[:, ::5] = -0.0
    coef[0] = torch.where(torch.arange(K8.TAPS) % 2 == 0, 0.0, -0.0).double()
    hist = _int16((B, K8.KEEP), seed)
    hist[0] = -5
    return coef, hist


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("B,T", NLMS_CASES + [(3, 1100), (33, 400)])
def test_nlms_kernel_matches_plain(cuda, B, T, compat):
    """K8 bit-equal to its plain version (est, err, coefficients bit for bit
    with the sign of zero, history) over chunk edges and the window's first
    256 samples, from a nonzero state, also when the stream is cut into two
    calls."""
    x, r = _echo_pair(B, T, B)
    x[0], r[0] = -5, 0
    x, r = x.to(cuda), r.to(cuda)
    state = tuple(v.to(cuda) for v in _nlms_state(B, T))
    cut = T // 3 if T > 2 else T
    before = K8.nlms.launches
    e1, r1, s = K8.nlms(x[:, :cut].contiguous(), r[:, :cut].contiguous(), state, compat=compat)
    if cut < T:
        e2, r2, s = K8.nlms(x[:, cut:].contiguous(), r[:, cut:].contiguous(), s, compat=compat)
        e1, r1 = torch.cat([e1, e2], 1), torch.cat([r1, r2], 1)
    torch.cuda.synchronize()
    assert K8.nlms.launches == before + 1 + (cut < T)
    we, wr, (wc, wh) = K8.nlms_plain(x, r, *state, compat=compat)
    assert torch.equal(e1, we) and torch.equal(r1, wr)
    assert torch.equal(s[0].view(torch.int64), wc.view(torch.int64))
    assert torch.equal(s[1], wh)
    assert wc[0].view(torch.int64).lt(0).any()  # -0.0 kept where IEEE keeps it


# each kernel's mu, eps and largest window energy: K8 256 taps, K9 128
QUOTIENT_RANGES = {"K8": (K8.MU, K8.EPS, 38), "K9": (K9.MU, K9.EPS, 37)}


@pytest.mark.parametrize("kernel", sorted(QUOTIENT_RANGES))
def test_nlms_quotient_matches_ieee_division(cuda, kernel):
    """The quotient from one reciprocal that K8 and K9 share equals __ddiv_rn
    bit for bit on 2^26 pairs from each kernel's ranges (int16 w, e in
    +-65535, integer window energies in [0, 2^38] for K8 and [0, 2^37] for
    K9, over every binade) and on the edges: d = EPS, energies at powers of
    two and at the top, a = +-0, the largest and the smallest nonzero |a|."""
    mu, eps, kmax = QUOTIENT_RANGES[kernel]
    g = torch.Generator(device=cuda).manual_seed(20261017)
    n = 1 << 26
    f64 = dict(dtype=torch.float64, device=cuda)
    w = torch.randint(-32768, 32768, (n,), generator=g, device=cuda).double()
    e = torch.randint(-65535, 65536, (n,), generator=g, device=cuda).double()
    norm = torch.floor(2.0 ** (kmax * torch.rand(n, generator=g, **f64)))
    a = (w * (2.0 * mu)) * e
    if kernel == "K8":
        a[::4] = (2.0 * mu) * e[::4]
    norms = [0.0, 1.0, 2.0 ** kmax, 2.0 ** kmax - 1] + [2.0 ** k + j for k in range(1, kmax)
                                                      for j in (-1, 0, 1)]
    nums = [(wv * 2.0 * mu) * ev for wv in (-32768, -1, 0, 1, 32767)
            for ev in (-65535, -1, 0, 1, 65535)] + [-0.0, 0.0]
    edge_a = torch.tensor(nums, **f64).repeat_interleave(len(norms))
    edge_d = torch.tensor(norms, **f64).repeat(len(nums))
    a = torch.cat([a, edge_a])
    d = torch.cat([norm + eps, edge_d + eps])
    q, want = torch.empty_like(a), torch.empty_like(a)
    _build.launch("jb_test_quotient", a.device, a.data_ptr(), d.data_ptr(), q.data_ptr(),
                  want.data_ptr(), a.numel())
    torch.cuda.synchronize()
    bad = int((q.view(torch.int64) != want.view(torch.int64)).sum())
    assert bad == 0, f"{bad} of {a.numel()} quotients differ from __ddiv_rn"
    assert torch.equal(want.view(torch.int64), (a / d).view(torch.int64))


def test_nlms_kernel_wraps_diverged_estimates(cuda):
    """Coefficients far too large give estimates beyond int32: c_short maps
    them to 0 (the reference's cvttsd2si), never the GPU's saturated value."""
    x, r = (v.to(cuda) for v in _echo_pair(2, 64, 9))
    coef = torch.full((2, K8.TAPS), 1e6, dtype=torch.float64, device=cuda)
    hist = _int16((2, K8.KEEP), 3).to(cuda)
    got = K8.nlms(x, r, (coef, hist))
    want = K8.nlms_plain(x, r, coef, hist)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].eq(0).any()


def _bnlms_state(B, seed):
    """Small nonzero coefficients, every fifth one -0.0, and a random keep."""
    rng = np.random.default_rng(seed)
    coef = torch.from_numpy(rng.normal(0, 1e-3, (B, K9.TAPS)))
    coef[:, ::5] = -0.0
    return coef, _int16((B, K9.KEEP), seed)


@pytest.mark.parametrize("B,nb", [(B, nb) for B in (1, 7, 1025) for nb in (1, 2, 3)])
def test_bnlms_kernel_matches_plain(cuda, B, nb):
    """K9 bit-equal to its plain version (est, err, coefficients bit for bit
    with the sign of zero, keep) with open and shut gates, from a nonzero
    state, also when the stream is cut into two calls (one block, then the
    rest); stream 0 is silent on its far end, so its windows are zero and
    its quotients +-0 / EPS."""
    x, r = _echo_pair(B, nb * 1024, 10 + B)
    x[0] = 0
    x, r = x.to(cuda), r.to(cuda)
    gates = torch.from_numpy(np.random.default_rng(B + nb).random((B, nb)) < 0.7).to(cuda)
    gates[0] = True
    state = tuple(v.to(cuda) for v in _bnlms_state(B, nb))
    state[1][0] = 0
    before = K9.bnlms.launches
    e1, r1, s = K9.bnlms(x[:, :1024].contiguous(), r[:, :1024].contiguous(),
                         gates[:, :1].contiguous(), state)
    if nb > 1:
        e2, r2, s = K9.bnlms(x[:, 1024:].contiguous(), r[:, 1024:].contiguous(),
                             gates[:, 1:].contiguous(), s)
        e1, r1 = torch.cat([e1, e2], 1), torch.cat([r1, r2], 1)
    torch.cuda.synchronize()
    assert K9.bnlms.launches == before + 1 + (nb > 1)
    we, wr, (wc, wk) = K9.bnlms_plain(x, r, gates, *state)
    assert torch.equal(e1, we) and torch.equal(r1, wr)
    assert torch.equal(s[0].view(torch.int64), wc.view(torch.int64)) and torch.equal(s[1], wk)
    if B > 1:  # the open gates moved the other streams' coefficients
        assert not torch.equal(wc[1:], state[0][1:])


def test_bnlms_kernel_occupancy(cuda):
    """K9's shared memory and registers leave room for 8 blocks of 64
    threads on an SM, so 1024 streams run in one wave."""
    assert K9.occupancy(cuda) >= 8


def test_bnlms_gates_on_card_match_cpu(cuda):
    x, r = _echo_pair(4, 4096, 12)
    keep = torch.zeros(4, 127, dtype=torch.int16)
    r[1] = -r[1]
    got = K9.bnlms_gates(x.to(cuda), r.to(cuda), keep.to(cuda), keep.to(cuda))
    assert torch.equal(got.cpu(), K9.bnlms_gates(x, r, keep, keep))


def test_recursion_cpu_wrappers_run_plain_without_counting():
    x, r = _echo_pair(2, 2048, 13)
    coef = _geq_coef()
    counts = [f.launches for f in (K6.geq_cascade_quant, K7.geq_cascade, K8.nlms, K9.bnlms)]
    y, s = K6.geq_cascade_quant(x[:, :64].contiguous(), coef)
    assert torch.equal(y, K6.geq_cascade_quant_plain(x[:, :64].contiguous(), coef,
                                                     K6.init_state(2))[0])
    xf = x[:, :64].float().contiguous()
    assert torch.equal(K7.geq_cascade(xf, coef.float()), K7.geq_cascade_plain(xf, coef.float()))
    assert torch.equal(K8.nlms(x, r)[0], K8.nlms_plain(x, r, *K8.init_state(2))[0])
    gates = torch.ones(2, 2, dtype=torch.bool)
    assert torch.equal(K9.bnlms(x, r, gates)[1], K9.bnlms_plain(x, r, gates, *K9.init_state(2))[1])
    assert counts == [f.launches for f in (K6.geq_cascade_quant, K7.geq_cascade, K8.nlms, K9.bnlms)]


@pytest.mark.parametrize("bad", ["dtype", "rank", "state", "coef", "noncontig", "device"])
@pytest.mark.parametrize("name", ["K6", "K7", "K8", "K9"])
def test_recursion_wrappers_reject(name, bad):
    x, r = _echo_pair(2, 2048, 14)
    coef = _geq_coef(np.float32 if name == "K7" else np.float64)
    if name == "K7":
        x = x.float()
    state = {"K6": K6.init_state(2), "K8": K8.init_state(2), "K9": K9.init_state(2)}.get(name)
    if bad == "dtype":
        x = x.to(torch.int32) if name != "K7" else x.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "state":
        state = {"K6": K6.init_state(3), "K8": K8.init_state(3), "K9": K9.init_state(3)}.get(name)
        if name == "K7":
            coef = coef[:6]
    elif bad == "coef":  # K6 takes f64 and f32 coefficients, K7 f32
        coef = {"K6": coef.half(), "K7": coef.double()}.get(name, coef.float())
        if name == "K8":
            state = (state[0].float(), state[1])
        elif name == "K9":
            state = (state[0], state[1].to(torch.int32))
    elif bad == "noncontig":
        x = x[:, ::2]
    elif bad == "device":
        x = x.to("meta")
    call = {"K6": lambda: K6.geq_cascade_quant(x, coef, state),
            "K7": lambda: K7.geq_cascade(x, coef),
            "K8": lambda: K8.nlms(x, r, state),
            "K9": lambda: K9.bnlms(x, r, torch.ones(2, 2, dtype=torch.bool), state)}[name]
    with pytest.raises(ValueError):
        call()


# ---- the speech features: MFCC (K10) and the AMDF (K11) ---------------------

from chip_smoke import class_models, class_signal, reference_mfcc, speech_signal  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import amdf as K11  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10  # noqa: E402
from jeicyboodsp_tpu_torch.models import gmm as GM  # noqa: E402
from jeicyboodsp_tpu_torch.ops import features as F  # noqa: E402
from jeicyboodsp_tpu_torch.pipelines import speech as S  # noqa: E402


def _feature_rows(n_blocks, seed, silent=None):
    """The zero-prefixed (2T + 1, 512) row view of a speech signal."""
    x = speech_signal(n_blocks * 1024, np.random.default_rng(seed), silent)
    return torch.from_numpy(np.concatenate([np.zeros(512, np.int16), x])).reshape(-1, 512)


def _frames(T, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-32768, 32768, (T, 1024))
                            .astype(np.int16))


@pytest.mark.parametrize("n_blocks", [1, 37, 300])
def test_mfcc_kernel_matches_plain(cuda, n_blocks):
    """K10 >= 90 dB of its plain version over the finite features, with equal
    NaN masks: a silent stretch gives log 0 = -inf channels and NaN frames."""
    rows = _feature_rows(n_blocks, n_blocks, silent=(0, 2048)).to(cuda)
    before = K10.mfcc_fused.launches
    got = K10.mfcc_fused(rows[:-1], rows[1:])
    want = K10.mfcc_fused_plain(rows[:-1], rows[1:])
    torch.cuda.synchronize()
    assert K10.mfcc_fused.launches == before + 1
    g, w = got.cpu().double().numpy(), want.cpu().double().numpy()
    assert g.shape == (2 * n_blocks, 12) and np.isnan(w[0]).all()
    assert np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    if fin.any():
        assert snr_db(w[fin], g[fin]) >= KERNEL_VS_PLAIN_DB


@pytest.mark.parametrize("N", [1, 37, 300, 16384])
def test_mfcc_kernel_frame_counts(cuda, N):
    """K10 at N frames (8 a block: 1, 37 and 300 leave the last block
    ragged) >= 90 dB of its plain version over the finite features, with
    equal NaN and infinity masks, on rows with a digital-silence stretch
    (frames 3-5 NaN) and a quiet row 8 (samples in -3..3) beside a
    full-scale random row 9."""
    rng = np.random.default_rng(N)
    rows = _feature_rows((N + 1) // 2 + 4, N, silent=(1024, 3072)).numpy()
    rows[8] = rng.integers(-3, 4, 512)
    rows[9] = rng.integers(-32768, 32768, 512)
    rows = torch.from_numpy(rows).to(cuda)
    prev, cur = rows[:N], rows[1:N + 1]
    before = K10.mfcc_fused.launches
    got = K10.mfcc_fused(prev, cur)
    want = K10.mfcc_fused_plain(prev, cur)
    torch.cuda.synchronize()
    assert K10.mfcc_fused.launches == before + 1
    g, w = got.cpu().double().numpy(), want.cpu().double().numpy()
    assert g.shape == (N, 12)
    assert np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(np.isinf(g), np.isinf(w))
    if N > 9:
        assert np.isnan(w[3:6]).all() and np.isfinite(w[7:10]).all()
    fin = np.isfinite(w)
    assert fin.any() and snr_db(w[fin], g[fin]) >= KERNEL_VS_PLAIN_DB


@pytest.mark.parametrize("lo", [0, 8, 96, 504])
@pytest.mark.parametrize("T", [1, 2, 333, 16384 + 5])
def test_amdf_kernel_bit_equal_to_plain(cuda, T, lo):
    """K11 over T frames: 16 a block, so 2, 333 and 16389 leave the last block
    ragged; each lo gives another count of lag groups (odd at lo = 8 and
    504)."""
    frames = _frames(T, T + lo).to(cuda)
    frames[0] = 0  # a silent frame: every lag 0
    before = K11.amdf.launches
    got = K11.amdf(frames, lo)
    torch.cuda.synchronize()
    assert K11.amdf.launches == before + 1
    assert got.dtype == torch.float64 and got.shape == (T, 512 - lo)
    assert torch.equal(got, K11.amdf_plain(frames, lo)) and got[0].eq(0).all()


@pytest.mark.parametrize("lo", [0, 8, 96, 504])
@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd-offset"])
def test_amdf_kernel_extremes_bit_equal(cuda, odd, lo):
    """K11 bit-equal to its plain version on frames of full-scale extremes
    (random and alternating: the sums pass 2^24, where an f32 sum would
    round, and the packed int16 minima take both extremes), a silent frame,
    aligned and as a contiguous view one sample past a 16-byte boundary (the
    scalar-load variant)."""
    rng = np.random.default_rng(lo)
    u = np.where(rng.random((37, 1024)) < 0.5, -32768, 32767).astype(np.int16)
    u[1] = np.tile(np.array([-32768, 32767], np.int16), 512)
    u[2] = 0
    frames = torch.from_numpy(u).to(cuda)
    if odd:
        buf = torch.zeros(frames.numel() + 1, dtype=torch.int16, device=cuda)
        buf[1:] = frames.reshape(-1)
        frames = buf[1:].view(frames.shape)
        assert frames.data_ptr() % 16 and frames.is_contiguous()
    got = K11.amdf(frames, lo)
    want = K11.amdf_plain(frames, lo)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and got[2].eq(0).all()
    assert float(want[1, 1]) == 65535  # lag lo + 1: (1023 - lo) * 65535 >= 2^25


def test_feature_paths_launch_their_kernels(cuda):
    """mfcc_blocks(mxu3), pitch_frames(method=2, mxu) and speech_classify go
    through K10 / K11 and agree with the CPU run."""
    rows = _feature_rows(16, 1)
    blocks = rows[1:].reshape(16, 1024)
    mel_m, dct_m = F.mel_dct(torch.float32, cuda)
    k10, k11 = K10.mfcc_fused.launches, K11.amdf.launches
    feats = F.mfcc_blocks(blocks.to(cuda), mel_m, dct_m, dtype=torch.float32, fft_engine="mxu3")
    frames = torch.cat([rows[:-1], rows[1:]], 1)[::2].contiguous()
    lag, val, f0 = F.pitch_frames(frames.to(cuda), method=2, dtype=torch.float64, fft_engine="mxu")
    torch.cuda.synchronize()
    assert K10.mfcc_fused.launches == k10 + 1 and K11.amdf.launches == k11 + 1
    want = F.mfcc_blocks(blocks, *F.mel_dct(torch.float32, "cpu"), fft_engine="mxu3")
    assert snr_db(want.numpy(), feats.cpu().numpy()) >= KERNEL_VS_PLAIN_DB
    wl, wv, wf = F.pitch_frames(frames, method=2, dtype=torch.float64, fft_engine="mxu")
    assert torch.equal(lag.cpu(), wl) and torch.equal(val.cpu(), wv) and torch.equal(f0.cpu(), wf)
    rng = np.random.default_rng(2)
    model = class_models([reference_mfcc(class_signal(c, 32 * 1024, rng), False) for c in range(3)])
    utt = class_signal(1, 16 * 1024, rng)
    M = GM.model_to_port(*model, cuda)
    k10 = K10.mfcc_fused.launches
    scores = S.speech_classify(torch.from_numpy(utt.reshape(-1, 1024)).to(cuda), *M,
                               fft_engine="mxu3")
    torch.cuda.synchronize()
    assert K10.mfcc_fused.launches == k10 + 1
    want = S.speech_classify(torch.from_numpy(utt.reshape(-1, 1024)), *GM.model_to_port(*model, "cpu"),
                             fft_engine="mxu3")
    assert int(scores.argmax()) == int(want.argmax()) == 1
    assert torch.allclose(scores.cpu(), want, rtol=1e-5, atol=0)


def test_feature_cpu_wrappers_run_plain_without_counting():
    rows = _feature_rows(4, 3)
    frames = _frames(5, 4)
    counts = K10.mfcc_fused.launches, K11.amdf.launches
    assert torch.equal(K10.mfcc_fused(rows[:-1], rows[1:]), K10.mfcc_fused_plain(rows[:-1], rows[1:]))
    assert torch.equal(K11.amdf(frames, 96), K11.amdf_plain(frames, 96))
    assert counts == (K10.mfcc_fused.launches, K11.amdf.launches)


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "rank", "noncontig", "device"])
def test_mfcc_wrapper_rejects(bad):
    rows = _feature_rows(4, 5)
    prev, cur = rows[:-1], rows[1:]
    if bad == "dtype":
        prev = prev.to(torch.int32)
    elif bad == "width":
        prev, cur = prev[:, :256], cur[:, :256]
    elif bad == "rows":
        cur = cur[:-1]
    elif bad == "rank":
        prev = prev.reshape(-1)
    elif bad == "noncontig":
        prev = prev.t().contiguous().t()
    elif bad == "device":
        prev, cur = prev.to("meta"), cur.to("meta")
    with pytest.raises(ValueError):
        K10.mfcc_fused(prev, cur)


@pytest.mark.parametrize("bad", ["dtype", "width", "rank", "noncontig", "device", "lo"])
def test_amdf_wrapper_rejects(bad):
    frames, lo = _frames(4, 6), 96
    if bad == "dtype":
        frames = frames.float()
    elif bad == "width":
        frames = frames[:, :512].contiguous()
    elif bad == "rank":
        frames = frames[0]
    elif bad == "noncontig":
        frames = frames[::2]
    elif bad == "device":
        frames = frames.to("meta")
    elif bad == "lo":
        lo = 100
    with pytest.raises(ValueError):
        K11.amdf(frames, lo)


# ---- K12 (the FFT), K13 (the f32 back half), K14 (the VAD) ----

from chip_smoke import vad_threshold_rows  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import enhance_back as K13  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import fft_four_step as K12  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import vad_flags as K14  # noqa: E402
from jeicyboodsp_tpu_torch.ops import fastconv as FC  # noqa: E402
from jeicyboodsp_tpu_torch.ops import fft as FT  # noqa: E402

FFT_RTOL = 1e-5   # K12 against its plain version and numpy: of max |X|
ROW_RTOL = 1e-5   # K13 against its plain version: of each frame row's max


@pytest.mark.parametrize("forward", [True, False], ids=["forward_real", "inverse_complex"])
@pytest.mark.parametrize("n", [512, 1024, 8192, 96, 16384, 384])
def test_fft4_kernel_matches_plain(cuda, n, forward):
    """K12 against its plain version (cuBLAS f32 matmuls, TF32 off) and a
    float64 numpy FFT, within 1e-5 of max |X|: T = 37 (a last block that
    several small frames do not fill), T = 1 and T = 9.  n = 96 (8 x 12)
    and 384 (16 x 24) take the plan's odd radix 3, 16384 is the largest
    frame.  Each call is one counted launch that allocates its two outputs
    and no scratch."""
    rng = np.random.default_rng(n + forward)
    for T in (37, 1, 9):
        xr, xi = (torch.from_numpy(rng.normal(0, 100, (T, n)).astype(np.float32)).to(cuda)
                  for _ in range(2))
        xi = None if forward else xi
        K12.fft_pallas(xr, xi, n, forward)  # the twiddle tables are made once
        torch.cuda.synchronize()
        # the bytes the calls ask for: a cached block that the allocator hands
        # out whole (its tail too small to split) would count in full in
        # memory_allocated, depending on what earlier tests left
        base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        before = K12.fft_pallas.launches
        r, i = K12.fft_pallas(xr, xi, n, forward)
        torch.cuda.synchronize()
        out_bytes = 2 * T * n * 4
        assert torch.cuda.memory_stats()["requested_bytes.all.peak"] - base <= out_bytes
        assert K12.fft_pallas.launches == before + 1
        pr, pi = K12.fft_four_step(xr, xi, n, forward)
        assert r.shape == (T, n) and r.dtype == torch.float32
        got = r.cpu().double().numpy() + 1j * i.cpu().double().numpy()
        z = xr.cpu().double().numpy() + (0 if forward else 1j * xi.cpu().double().numpy())
        for what, want in (("plain", pr.cpu().double().numpy() + 1j * pi.cpu().double().numpy()),
                           ("numpy", np.fft.fft(z) if forward else np.fft.ifft(z) * n)):
            assert np.abs(got - want).max() <= FFT_RTOL * np.abs(want).max(), (what, T)


def test_fft4_paths_launch_k12(cuda):
    """roundtrip_blocks(fourstep) and fastconv's mxu engine in f32 go through
    K12 and agree with their CPU runs to one int16 step."""
    rng = np.random.default_rng(9)
    x = np.clip(rng.normal(0, 3000, 40 * 512), -32768, 32767).astype(np.int16)
    before = K12.fft_pallas.launches
    rt = FT.roundtrip_blocks(torch.from_numpy(x.reshape(-1, 512)).to(cuda), torch.float32,
                             "fourstep")
    fc = FC.run_stream(x, dtype=torch.float32, fft_engine="mxu", device=cuda)
    torch.cuda.synchronize()
    assert K12.fft_pallas.launches == before + 4  # two transforms each
    rc = FT.roundtrip_blocks(torch.from_numpy(x.reshape(-1, 512)), torch.float32, "fourstep")
    fcc = FC.run_stream(x, dtype=torch.float32, fft_engine="mxu", device="cpu")
    assert (rt.cpu().int() - rc.int()).abs().max() <= 1
    assert fc.shape == fcc.shape and np.abs(fc.astype(int) - fcc.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["wiener", "specsub"])
def test_enhance_back_kernel_matches_plain(cuda, mode):
    blocks, _, C = _inputs(cuda)
    ins = _back_inputs("K4", blocks, C)
    before = K13.enhance_back.launches
    got = K13.enhance_back(*ins, C, mode)
    want = K13.enhance_back_plain(*ins, C, mode)
    torch.cuda.synchronize()
    assert K13.enhance_back.launches == before + 1
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    rowmax = torch.cat(want, 1).abs().amax(1, keepdim=True)
    for g, w in zip(got, want):
        assert ((g - w).abs() <= ROW_RTOL * rowmax).all()


def test_enhance_back_zero_bins_give_nan(cuda):
    """re = im = 0 on bins 100-109 before any latch: a NaN gain (0/0) only
    in the rows whose frame flag says the frame holds no sample (here
    every fourth row, flagged so), where the kernel's NaN masks equal the
    plain version's; in every other row the port gives those bins gain 1
    and its outputs are finite, where the TPU kernel as written has NaN
    (ROADMAP R23), within ROW_RTOL of the plain version's."""
    blocks, _, C = _inputs(cuda, n_blocks=64)
    re, im, re_n, ns, ns_n, nz = _back_inputs("K4", blocks, C)
    re, im, nz = re.clone(), im.clone(), nz.clone()
    re[:, 100:110] = 0.0
    im[:, 100:110] = 0.0
    nz[::4] = 0.0
    got = K13.enhance_back(re, im, re_n, ns, ns_n, nz, C, "wiener")
    want = K13.enhance_back_plain(re, im, re_n, ns, ns_n, nz, C, "wiener")
    torch.cuda.synchronize()
    _row_check(got, want, "K13 zero bins")
    nan_rows = torch.cat(got, 1).isnan().any(1).cpu()
    flagged = torch.zeros(64, dtype=torch.bool)
    flagged[::4] = True
    assert torch.equal(nan_rows, flagged & (ns[:, 100:110] == 0).all(1).cpu())
    assert nan_rows.any()


def _row_check(got, want, what):
    """K13's outputs within ROW_RTOL of each frame row's max, NaN masks equal."""
    rowmax = torch.cat(want, 1).nan_to_num(0.0).abs().amax(1, keepdim=True)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan()), what
        assert ((g - w).nan_to_num(0.0).abs() <= ROW_RTOL * rowmax).all(), what


@pytest.mark.parametrize("mode", ["wiener", "specsub"])
@pytest.mark.parametrize("T", [200, 16384 + 8])
def test_back_tensor_core_pass_ragged_rows(cuda, T, mode):
    """K13 and K5 at T not a multiple of their tensor-core pass's 128-row
    tile (the rows past T read as zero and are not written): K13 within
    ROW_RTOL of each frame row's max with equal NaN masks, K5 >= 90 dB, both
    against their plain versions."""
    blocks = torch.from_numpy(_signal(T, T % 97).reshape(-1, 512)).to(cuda)
    C = E.enhance_constants(cuda)
    ins = _back_inputs("K4", blocks, C, 8)
    got = K13.enhance_back(*ins, C, mode)
    want = K13.enhance_back_plain(*ins, C, mode)
    out = K5.enhance_back_ola3(*ins, C, mode, emit_all=True)
    out_p = K5.enhance_back_ola3_plain(*ins, C, mode, emit_all=True)
    torch.cuda.synchronize()
    assert [tuple(g.shape) for g in got] == [(T, 512), (T, 512), (T, 1)]
    _row_check(got, want, f"K13 T={T}")
    assert snr_db(out_p.cpu().numpy(), out.cpu().numpy()) >= KERNEL_VS_PLAIN_DB


@pytest.mark.parametrize("mode", ["wiener", "specsub"])
def test_back_tensor_core_gemm_against_f64(cuda, mode):
    """The 3xTF32 GEMMs alone: K13's head, w2 and y512 against float64
    products of the same Y (the plain version's f32 gain, cast up), each
    within 2^-18 of its sum of |products|.  3xTF32 keeps about 2^-22 of a
    product; a lost lo half (2^-11 of a product) would show here apart
    from the gain."""
    blocks, _, C = _inputs(cuda, n_blocks=1024)
    ins = _back_inputs("K4", blocks, C)
    re, im, re_n, ns, ns_n, nz = ins
    g, gn = K.bin_gain(re, im, re_n[:, 0], ns, ns_n[:, 0], nz[:, 0], mode)
    Yre, Yim, Yren = (re * g).double(), (im * g).double(), (re_n[:, 0] * gn).double()
    UC, VS, un = C["UC512"].double(), C["VS512"].double(), C["u_nyq"].double()
    ycol = C["y512col"].double()
    u = Yre @ UC + Yren[:, None] * un
    v = Yim @ VS
    su = Yre.abs() @ UC.abs() + (Yren.abs()[:, None] * un.abs())
    sv = Yim.abs() @ VS.abs()
    want = (u - v, u + v, (Yre @ ycol[:512] + Yren * ycol[512])[:, None])
    scale = (su + sv, su + sv, (Yre.abs() @ ycol[:512].abs() + (Yren * ycol[512]).abs())[:, None])
    got = K13.enhance_back(*ins, C, mode)
    torch.cuda.synchronize()
    for name, gt, w, sc in zip(("head", "w2", "y512"), got, want, scale):
        ok = w.isfinite()
        assert torch.equal(gt.isfinite(), ok), name
        ratio = ((gt.double() - w).abs() / sc.clamp_min(1e-30))[ok]
        assert float(ratio.max()) <= 2.0 ** -18, (name, float(ratio.max()))


def test_enhance_fused_on_card(cuda):
    """_enhance_fused runs K4 and K13 and agrees with its CPU run to one
    int16 step on under 0.5% of the samples (f32 sums in other orders)."""
    blocks = torch.from_numpy(_signal(200, 5).reshape(-1, 512))
    k4, k13 = K4.enhance_fwd.launches, K13.enhance_back.launches
    out, mask = E._enhance_fused(blocks.to(cuda), "wiener", False)
    torch.cuda.synchronize()
    assert (K4.enhance_fwd.launches, K13.enhance_back.launches) == (k4 + 1, k13 + 1)
    out_c, mask_c = E._enhance_fused(blocks, "wiener", False)
    assert torch.equal(mask.cpu(), mask_c) and out[:2].eq(0).all()
    d = (out.cpu().int() - out_c.int()).abs()
    assert d.max() <= 1 and d.gt(0).double().mean() < 0.005


def test_vad_kernel_bit_equal_to_plain(cuda):
    """K14's flags equal its plain version's on the chain's signal, on
    full-scale random rows and on rows at the energy and ZCR thresholds,
    with the port's f32 window and the f64-built w2."""
    rng = np.random.default_rng(4)
    C = E.enhance_constants(cuda)
    for w2 in (E._vad_window(cuda), C["w2"]):
        rows = np.concatenate([_signal(300, 6).reshape(-1, 512),
                               rng.integers(-32768, 32768, (40, 512)).astype(np.int16),
                               vad_threshold_rows(w2.cpu().numpy())])
        cur = torch.from_numpy(rows).to(cuda)
        before = K14.vad_flags.launches
        got = K14.vad_flags(cur, w2)
        torch.cuda.synchronize()
        assert K14.vad_flags.launches == before + 1
        assert got.dtype == torch.bool and torch.equal(got, K2.vad_rows(cur, w2))
        assert got[-6:].tolist() == [False, False, True, True, False, False]
    # a contiguous view that starts off a 16-byte boundary takes the 2-byte loads
    buf = torch.zeros(cur.numel() + 1, dtype=torch.int16, device=cuda)
    buf[1:] = cur.reshape(-1)
    odd = buf[1:].view(cur.shape)
    assert odd.data_ptr() % 16
    assert torch.equal(K14.vad_flags(odd, w2), got)


@pytest.mark.parametrize("T", [1, 7, 9, 2049, 16384 + 3])
def test_vad_kernel_row_counts(cuda, T):
    """K14 over T rows: 8 warps a block and a grid of at most 4 blocks an
    SM, so 2049 and 16387 rows take more than one round of the grid-stride
    loop and end in a part of one; the last rows are the threshold rows,
    with both windows, aligned and one sample past a 16-byte boundary."""
    C = E.enhance_constants(cuda)
    for w2 in (E._vad_window(cuda), C["w2"]):
        edge = vad_threshold_rows(w2.cpu().numpy())
        rows = np.concatenate([_signal(T // 2 + 1, T).reshape(-1, 512),
                               np.random.default_rng(T).integers(-32768, 32768, (T, 512))
                               .astype(np.int16)])
        rows = np.concatenate([rows[:max(T - len(edge), 0)], edge])[-T:]
        cur = torch.from_numpy(rows).to(cuda)
        buf = torch.zeros(cur.numel() + 1, dtype=torch.int16, device=cuda)
        buf[1:] = cur.reshape(-1)
        odd = buf[1:].view(cur.shape)
        before = K14.vad_flags.launches
        got, got_odd = K14.vad_flags(cur, w2), K14.vad_flags(odd, w2)
        torch.cuda.synchronize()
        assert K14.vad_flags.launches == before + 2
        want = K2.vad_rows(cur, w2)
        assert got.shape == (T,) and torch.equal(got, want) and torch.equal(got_odd, want)
        if T >= len(edge):
            assert got[-6:].tolist() == [False, False, True, True, False, False]


def test_batched_vad_flags_through_k14(cuda):
    """``ops.enhance.vad_flags`` in f32 over (B, T, 512) blocks (P6): one
    K14 launch over the flattened rows, equal to one call a stream and to
    the f32 flags on the CPU; an empty leading axis launches nothing."""
    rows = np.concatenate([_signal(3 * 64, 16).reshape(-1, 512)[:-6],
                           vad_threshold_rows(E._vad_window(cuda).cpu().numpy())])
    blocks = torch.from_numpy(rows.reshape(3, 64, 512)).to(cuda)
    before = K14.vad_flags.launches
    got = E.vad_flags(blocks, torch.float32)
    torch.cuda.synchronize()
    assert K14.vad_flags.launches == before + 1
    per_stream = torch.stack([E.vad_flags(blocks[b], torch.float32) for b in range(3)])
    assert got.shape == (3, 64) and torch.equal(got, per_stream)
    assert torch.equal(got.cpu(), E.vad_flags(blocks.cpu(), torch.float32))
    assert got[-1, -6:].tolist() == [False, False, True, True, False, False]
    before = K14.vad_flags.launches
    assert E.vad_flags(blocks[:0], torch.float32).shape == (0, 64)
    assert K14.vad_flags.launches == before


def test_engines_mxu8f_mxu8t_launch_k14(cuda):
    blocks = torch.from_numpy(_signal(100, 8).reshape(-1, 512)).to(cuda)
    for eng in ("mxu8f", "mxu8t"):
        before = K14.vad_flags.launches
        E.enhance_blocks(blocks, "wiener", fft_engine=eng, resynth="ratio")
        torch.cuda.synchronize()
        assert K14.vad_flags.launches == before + 1, eng


@pytest.mark.parametrize("eng", [*E.ENGINES, "_enhance_fused"])
def test_enhance_blocks_on_an_unaligned_view(cuda, eng):
    """A contiguous CUDA view at an odd sample offset (T a multiple of 64,
    so no padded copy is made) gives the same output as an aligned copy:
    K14 and K4 read such blocks with scalar loads."""
    x = _signal(128, 9)
    buf = torch.zeros(x.size + 1, dtype=torch.int16, device=cuda)
    buf[1:] = torch.from_numpy(x).to(cuda)
    odd = buf[1:].view(-1, 512)
    assert odd.data_ptr() % 8 and odd.is_contiguous()
    if eng == "_enhance_fused":
        got, want = (E._enhance_fused(b, "wiener", False) for b in (odd, odd.clone()))
    else:
        got, want = (E.enhance_blocks(b, "wiener", fft_engine=eng, resynth="ratio")
                     for b in (odd, odd.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _session_inputs(what):
    rng = np.random.default_rng(9)
    if what == "geq":
        return (np.clip(rng.normal(0, 6000, 8 * 512), -32768, 32767).astype(np.int16),)
    x = np.clip(rng.normal(0, 3000, 6 * 1024), -32768, 32767).astype(np.int16)
    ref = np.clip(0.5 * x + np.roll(0.2 * x, 7) + rng.normal(0, 50, len(x)), -32768,
                  32767).astype(np.int16)
    return x, ref


@pytest.mark.parametrize("what", ["geq", "nlms", "bnlms"])
def test_recursion_sessions_on_the_card(cuda, what, tmp_path):
    """GEQSession (K6 f64) and AECSession (K8, K9) at B = 1 on the card:
    bit-equal to the same session on the CPU (the plain versions), across a
    checkpoint the card writes and the CPU session restores; one launch a
    call."""
    from jeicyboodsp_tpu_torch.io import stream as ST
    from jeicyboodsp_tpu_torch.kernels import bnlms as K9
    from jeicyboodsp_tpu_torch.kernels import geq_cascade_quant as K6
    from jeicyboodsp_tpu_torch.kernels import nlms as K8

    kern = {"geq": K6.geq_cascade_quant, "nlms": K8.nlms, "bnlms": K9.bnlms}[what]
    make = (lambda d: ST.GEQSession(device=d)) if what == "geq" else (
        lambda d: ST.AECSession(what, device=d))
    sig = _session_inputs(what)
    cut = 2048 if what == "geq" else 3 * 1024
    card, cpu = make(cuda), make("cpu")
    before = kern.launches
    first = card.process(*(s[:cut] for s in sig))
    card.checkpoint(str(tmp_path / "ck.npz"))
    rest = card.process(*(s[cut:] for s in sig))
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    rows = lambda out: np.atleast_2d(np.asarray(out))  # noqa: E731  (est, err) or y
    np.testing.assert_array_equal(np.concatenate([rows(first), rows(rest)], 1),
                                  rows(cpu.process(*sig)))
    again = make("cpu")
    again.restore(str(tmp_path / "ck.npz"))
    np.testing.assert_array_equal(rows(again.process(*(s[cut:] for s in sig))), rows(rest))


def test_enhance_session_f32_on_the_card(cuda, tmp_path):
    """EnhanceSession in f32 on the card runs its VAD through K14, one launch
    a chunk: chunked with a checkpoint restored on the CPU, >= 95 dB of the
    CPU session (cuFFT and the CPU's FFT round apart), the VAD flags equal."""
    from jeicyboodsp_tpu_torch.io import stream as ST
    from jeicyboodsp_tpu_torch.kernels import vad_flags as K14

    blocks = _signal(48, 5).reshape(-1, 512)
    card = ST.EnhanceSession("wiener", dtype=torch.float32, device=cuda)
    before = K14.vad_flags.launches
    outs = [card.process(blocks[s: s + 4]) for s in range(0, 24, 4)]
    card.checkpoint(str(tmp_path / "ck.npz"))
    outs += [card.process(blocks[s: s + 4]) for s in range(24, 48, 4)]
    torch.cuda.synchronize()
    assert K14.vad_flags.launches == before + 12
    cpu = ST.EnhanceSession("wiener", dtype=torch.float32, device="cpu")
    want = np.concatenate([cpu.process(blocks[s: s + 4]) for s in range(0, 48, 4)])
    got = np.concatenate(outs)
    assert got.shape == want.shape and snr_db(want, got) >= 95.0
    again = ST.EnhanceSession("wiener", dtype=torch.float32, device="cpu")
    again.restore(str(tmp_path / "ck.npz"))
    assert again.sample_offset == 24 * 512
    rest = np.concatenate([again.process(blocks[s: s + 4]) for s in range(24, 48, 4)])
    assert snr_db(np.concatenate(outs[6:]), rest) >= 95.0
    sp = torch.from_numpy(blocks).to(cuda)
    assert torch.equal(E.vad_flags(sp, torch.float32).cpu(), E.vad_flags(sp.cpu(), torch.float32))


# ---- speech recognition: GMM training and HMM decoding on the card (torch ops) ----


def test_bool_stable_argsort_on_the_card(cuda):
    """train_hmm orders each state's frames first by a stable argsort of a
    bool mask: on the card as on the CPU (ties keep their order)."""
    mask = torch.from_numpy(np.random.default_rng(8).random((6, 4099)) < 0.3)
    want = torch.argsort(~mask, dim=1, stable=True)
    got = torch.argsort(~mask.to(cuda), dim=1, stable=True).cpu()
    assert torch.equal(got, want)


def test_train_classes_batched_on_the_card(cuda):
    """train_classes_batched in f64 over 25 classes x 512 frames of the
    benchmark's synth_class on the card against the CPU: the k-means
    iteration counts equal; alpha within rtol 1e-6, the projected mean
    (signs aligned: cuSOLVER's eigenvectors differ from LAPACK's) 1e-5, cov
    1e-4, the top-4 |eigenvector dots| within 1e-5 of 1."""
    from chip_smoke import synth_class
    from jeicyboodsp_tpu_torch.models import gmm as G

    feats = torch.from_numpy(np.stack([synth_class(1000 + c, 512) for c in range(25)]))
    masks = torch.ones(25, 512, dtype=torch.bool)
    masks[3, 400:] = False  # a ragged class
    counts = [G.kmeans_counted(f, m, f[:, 0:16:4])[2]
              for f, m in ((feats, masks), (feats.to(cuda), masks.to(cuda)))]
    assert counts[1].cpu().tolist() == counts[0].tolist()
    want = [t.numpy() for t in G.train_classes_batched(feats, masks)]
    got = [t.cpu().numpy() for t in G.train_classes_batched(feats.to(cuda), masks.to(cuda))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    s = np.sign(np.sum(got[3] * want[3], axis=-2))
    mean = got[1].copy()
    mean[..., :8] *= s
    np.testing.assert_allclose(mean, want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.abs(np.sum(got[3] * want[3], axis=-2))[..., :4], 1.0, atol=1e-5)


def _same_scores(got, want, rtol=1e-12):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("T", [1, 2, 300, 4096])
def test_viterbi_forms_on_the_card(cuda, T):
    """Every decode on the card against the CPU on the benchmark's models:
    compat (f64 packed HMM, NaN and held-state observations), corrected and
    viterbi_assoc (the f64 decode model), viterbi_batched (16 ragged
    utterances): paths equal, scores within 1e-12 relative, NaN equal."""
    from chip_smoke import bench_hmm
    from jeicyboodsp_tpu_torch.models import hmm as H

    (vf, va, vm, vc, ve, vt), (states, trans, obs, obs0) = bench_hmm(np.random.default_rng(T))
    hmm = H.hmm_to_port(*(np.stack([s[i] for s in states]) for i in range(4)), trans, "cpu")
    for o in (obs[:T], obs0[:T]):
        want = H.viterbi(torch.from_numpy(o), *hmm, compat=True, full=True)
        got = H.viterbi(torch.from_numpy(o).to(cuda), *(t.to(cuda) for t in hmm), compat=True,
                        full=True)
        assert torch.equal(got[0].cpu(), want[0])
        _same_scores(got[1].cpu().numpy(), want[1].numpy())
        _same_scores(got[2].cpu().numpy(), want[2].numpy())
    dec = [torch.from_numpy(np.ascontiguousarray(x, np.float64)) for x in (vf[:T], va, vm, vc, ve, vt)]
    dec_c = [t.to(cuda) for t in dec]
    for fn in (lambda *a: H.viterbi(*a, compat=False), H.viterbi_assoc):
        want, got = fn(*dec), fn(*dec_c)
        assert torch.equal(got[0].cpu(), want[0])
        _same_scores(got[1].cpu().numpy(), want[1].numpy())
    rng = np.random.default_rng(5)
    lengths = torch.from_numpy(rng.integers(1, T + 1, 16))
    corpus = torch.from_numpy(rng.normal(0, 1, (16, T, 12)))
    want = H.viterbi_batched(corpus, lengths, *dec[1:])
    got = H.viterbi_batched(corpus.to(cuda), lengths.to(cuda), *dec_c[1:])
    assert torch.equal(got[0].cpu(), want[0])
    _same_scores(got[1].cpu().numpy(), want[1].numpy())


# ---- the f32 instances of K8 and K9, and the time-parallel BNLMS

from jeicyboodsp_tpu_torch.ops import nlms as TN  # noqa: E402


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("B,T", NLMS_CASES + [(3, 1100), (33, 400)])
def test_nlms_f32_kernel_matches_plain(cuda, B, T, compat):
    """K8's f32 instance bit-equal to its plain version (est, err, f32
    coefficients bit for bit with the sign of zero, history) over chunk
    edges and the window's first 256 samples, from a nonzero state, also
    when the stream is cut into two calls."""
    x, r = _echo_pair(B, T, B + 7)
    x[0], r[0] = -5, 0
    x, r = x.to(cuda), r.to(cuda)
    coef, hist = _nlms_state(B, T)
    state = (coef.float().to(cuda), hist.to(cuda))
    cut = T // 3 if T > 2 else T
    before = K8.nlms_f32.launches
    e1, r1, s = K8.nlms_f32(x[:, :cut].contiguous(), r[:, :cut].contiguous(), state,
                            compat=compat)
    if cut < T:
        e2, r2, s = K8.nlms_f32(x[:, cut:].contiguous(), r[:, cut:].contiguous(), s,
                                compat=compat)
        e1, r1 = torch.cat([e1, e2], 1), torch.cat([r1, r2], 1)
    torch.cuda.synchronize()
    assert K8.nlms_f32.launches == before + 1 + (cut < T)
    we, wr, (wc, wh) = K8.nlms_f32_plain(x, r, *state, compat=compat)
    assert torch.equal(e1, we) and torch.equal(r1, wr)
    assert torch.equal(s[0].view(torch.int32), wc.view(torch.int32))
    assert torch.equal(s[1], wh)


@pytest.mark.parametrize("B,nb", [(B, nb) for B in (1, 7, 1025) for nb in (1, 2, 3)])
def test_bnlms_f32_kernel_matches_plain(cuda, B, nb):
    """K9's f32 instance bit-equal to its plain version (est, err, f32
    coefficients bit for bit, keep) with open and shut gates, from a
    nonzero state, also when the stream is cut into two calls; stream 0 is
    silent on its far end."""
    x, r = _echo_pair(B, nb * 1024, 20 + B)
    x[0] = 0
    x, r = x.to(cuda), r.to(cuda)
    gates = torch.from_numpy(np.random.default_rng(B + nb).random((B, nb)) < 0.7).to(cuda)
    gates[0] = True
    coef, keep = _bnlms_state(B, nb)
    state = (coef.float().to(cuda), keep.to(cuda))
    state[1][0] = 0
    before = K9.bnlms_f32.launches
    e1, r1, s = K9.bnlms_f32(x[:, :1024].contiguous(), r[:, :1024].contiguous(),
                             gates[:, :1].contiguous(), state)
    if nb > 1:
        e2, r2, s = K9.bnlms_f32(x[:, 1024:].contiguous(), r[:, 1024:].contiguous(),
                                 gates[:, 1:].contiguous(), s)
        e1, r1 = torch.cat([e1, e2], 1), torch.cat([r1, r2], 1)
    torch.cuda.synchronize()
    assert K9.bnlms_f32.launches == before + 1 + (nb > 1)
    we, wr, (wc, wk) = K9.bnlms_f32_plain(x, r, gates, *state)
    assert torch.equal(e1, we) and torch.equal(r1, wr)
    assert torch.equal(s[0].view(torch.int32), wc.view(torch.int32)) and torch.equal(s[1], wk)


def test_bnlms_f32_kernel_occupancy(cuda):
    """K9's f32 instance fits at least as many blocks on an SM as the f64 one."""
    assert K9.occupancy(cuda, torch.float32) >= K9.occupancy(cuda)


def test_f32_ops_launch_the_f32_instances(cuda):
    x, r = _echo_pair(3, 2048, 31)
    x, r = x.to(cuda), r.to(cuda)
    n8, n9 = K8.nlms_f32.launches, K9.bnlms_f32.launches
    st = {k: v.expand(3, *v.shape).contiguous()
          for k, v in TN.nlms_init_state(torch.float32).items()}
    e, _, s = TN.nlms_apply(x, r, st, dtype=torch.float32)
    bs = {k: v.expand(3, *v.shape).contiguous()
          for k, v in TN.bnlms_init_state(torch.float32).items()}
    be, _, bs = TN.bnlms_apply(x.view(3, 2, 1024), r.view(3, 2, 1024), bs, dtype=torch.float32)
    torch.cuda.synchronize()
    assert (K8.nlms_f32.launches, K9.bnlms_f32.launches) == (n8 + 1, n9 + 1)
    assert s["coeff"].dtype == bs["coeff"].dtype == torch.float32
    st_cpu = {k: v.cpu() for k, v in st.items()}
    assert torch.equal(e.cpu(), TN.nlms_apply(x.cpu(), r.cpu(), st_cpu, dtype=torch.float32)[0])
    bs_cpu = {k: v.expand(3, *v.shape).contiguous()
              for k, v in TN.bnlms_init_state(torch.float32).items()}
    assert torch.equal(be.cpu(), TN.bnlms_apply(x.cpu().view(3, 2, 1024), r.cpu().view(3, 2, 1024),
                                                bs_cpu, dtype=torch.float32)[0])


def test_timeparallel_on_card_matches_cpu(cuda):
    """bnlms_apply_timeparallel on the card against the CPU path: within
    one LSB on under 1% of the samples (the matmuls sum in other orders)."""
    T = 16
    rng = np.random.default_rng(41)
    far = np.clip(rng.normal(0, 3000, (T, 1024)), -32768, 32767).astype(np.int16)
    echo = 0.5 * np.roll(far.reshape(-1), 5).reshape(T, 1024)
    near = np.clip(echo + rng.normal(0, 150, (T, 1024)), -32768, 32767).astype(np.int16)
    got = TN.bnlms_apply_timeparallel(torch.from_numpy(far).to(cuda),
                                      torch.from_numpy(near).to(cuda))
    want = TN.bnlms_apply_timeparallel(torch.from_numpy(far), torch.from_numpy(near))
    for g, w in zip(got, want):
        d = (g.cpu().to(torch.int64) - w.to(torch.int64)).abs()
        assert int(d.max()) <= 1 and float((d != 0).double().mean()) < 0.01


def test_run_checks_on_the_card(cuda):
    """``utils.gpu_checks.run_checks`` on the card: every reference contract
    holds, and each kernel it runs (K1-K6, K8, K9, K11, K14) launched."""
    from jeicyboodsp_tpu_torch.utils import gpu_checks

    launched = {}
    res = gpu_checks.run_checks("cuda", launched)
    assert res["all_ok"], res
    assert set(launched) == {"K1", "K2", "K3", "K4", "K5", "K6", "K8", "K9", "K11", "K14"}
    assert all(n > 0 for n in launched.values()), launched
