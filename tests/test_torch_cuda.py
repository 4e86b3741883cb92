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
from torch_inputs import F32_RTOL, k4_f64_bases, make_signal

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
    1e-5 of each plane's row max of the f64 values (F32_RTOL)."""
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
        assert _rel(got[i].double(), w) <= F32_RTOL, i


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
    samples."""
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

from jeicyboodsp_tpu_torch.kernels import amdf as K11  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10  # noqa: E402
from jeicyboodsp_tpu_torch.models import gmm as GM  # noqa: E402
from jeicyboodsp_tpu_torch.ops import features as F  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.mfcc import reference_mfcc  # noqa: E402
from jeicyboodsp_tpu_torch.pipelines import speech as S  # noqa: E402
from torch_inputs import class_models, class_signal, speech_signal  # noqa: E402


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

from jeicyboodsp_tpu_torch.kernels import enhance_back as K13  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import fft_four_step as K12  # noqa: E402
from jeicyboodsp_tpu_torch.kernels import vad_flags as K14  # noqa: E402
from jeicyboodsp_tpu_torch.ops import fastconv as FC  # noqa: E402
from jeicyboodsp_tpu_torch.ops import fft as FT  # noqa: E402
from torch_inputs import vad_threshold_rows  # noqa: E402

FFT_RTOL = 1e-5   # K12 against its plain version and numpy: of max |X|
ROW_RTOL = 1e-5   # K13 against its plain version: of each frame row's max
FFT_FULL_T = {8192: 2041, 512: 16384}  # the frames of a fastconv call / an FFT-program call


@pytest.mark.parametrize("forward", [True, False], ids=["forward_real", "inverse_complex"])
@pytest.mark.parametrize("n", [512, 1024, 8192, 96, 16384, 384])
def test_fft4_kernel_matches_plain(cuda, n, forward):
    """K12 against its plain version (cuBLAS f32 matmuls, TF32 off) and a
    float64 numpy FFT, within 1e-5 of max |X|: T = 37 (a last block that
    several small frames do not fill), T = 1 and T = 9, and the full-size
    calls (2041, 8192) and (16384, 512).  n = 96 (8 x 12) and 384 (16 x 24)
    take the plan's odd radix 3, 16384 is the largest frame.  Each call is
    one counted launch that allocates its two outputs and no scratch."""
    rng = np.random.default_rng(n + forward)
    for T in (37, 1, 9, *([FFT_FULL_T[n]] if n in FFT_FULL_T else [])):
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


def _fft_pair(got, want):
    """K12's (re, im) within FFT_RTOL of the plain version's max |X|."""
    err = torch.sqrt((got[0] - want[0]) ** 2 + (got[1] - want[1]) ** 2)
    scale = float(torch.sqrt(want[0] ** 2 + want[1] ** 2).max())
    assert float(err.max()) <= FFT_RTOL * scale, float(err.max()) / scale


def test_fft4_kernel_matches_plain_on_the_transform_signals(cuda):
    """K12 against its plain version at the full-size calls of its two
    users, on their signals (torch_inputs.transform_inputs), within 1e-5 of
    max |X|: at (2041, 8192) forward on the fastconv call's segments, then
    inverse on their spectra times the filter's (the mxu engine's
    inverse); at (16384, 512) forward on the FFT program's blocks and
    inverse on their spectra."""
    xc, xf = transform_inputs()
    segs = FC._segments(FC._warm(torch.from_numpy(xc.reshape(FC_T, 1024)).to(cuda),
                                 torch.float32), FC_T)
    Hr, Hi = (torch.from_numpy(a).to(cuda) for a in FC.filter_spectrum(dtype=torch.float32))
    fb = torch.from_numpy(xf.reshape(FFT_T, 512)).to(cuda).float()
    for n, x, filt in ((8192, segs, (Hr, Hi)), (512, fb, None)):
        X = K12.fft_pallas(x, None, n, True)
        _fft_pair(X, K12.fft_four_step(x, None, n, True))
        if filt:
            X = (X[0] * filt[0] - X[1] * filt[1], X[0] * filt[1] + X[1] * filt[0])
        _fft_pair(K12.fft_pallas(*X, n, False), K12.fft_four_step(*X, n, False))


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
    from jeicyboodsp_tpu_torch.models import gmm as G
    from torch_inputs import synth_class

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
    from jeicyboodsp_tpu_torch.models import hmm as H
    from torch_inputs import bench_hmm

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


# ---- the port's paths at full size on the card, against the f64 references ----
#
# The tests above hold each kernel against its plain version; the CPU tests hold the
# plain versions and the torch-op paths against the oracles.  These run on the card what
# no other test runs there: the torch-op engines (fastconv, the FFT program, pitch 1/3,
# the f64 MFCC, MVDR, LPC, geq_apply_fast, GMM training and scoring, AWGN), the CLIs
# in subprocesses, the enhancement file pipelines and sessions and the f32 echo
# cancellers at full size, each at the benchmark's size against the port's float64
# oracles (numpy only).  tests/test_torch_cuda_one_rank.py runs the sharded paths in
# a world of one NCCL rank.

import contextlib  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from jeicyboodsp_tpu_torch import cli  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.enhance import reference_enhance  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.fastconv import reference_fastconv  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.fftprog import reference_fft_roundtrip  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.geq import reference_geq_linear  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.gmm import (  # noqa: E402
    PCA_TEST, PCA_TRAIN, reference_read_models, reference_score, reference_score_file,
    reference_train_class,
)
from jeicyboodsp_tpu_torch.oracle.lpc import reference_lpc  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.mvdr import reference_mvdr  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.pitch import reference_pitch, reference_pitch_frames  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.viterbi import (  # noqa: E402
    reference_forward, reference_hmm_decode,
)
from jeicyboodsp_tpu_torch.pipelines import registry  # noqa: E402
from torch_inputs import (  # noqa: E402
    AEC_B, AEC_T, FC_T, FFT_T, GEQ_B, GEQ_T, HMM_T, LPC_F32_LOST, LPC_F32_MEDIAN,
    MFCC_T, PITCH_T, SCORE_RTOL, SEED, T_FULL, T_PROBE, bench_hmm, chain_signals,
    feature_inputs, lpc_signal, make_aec_streams, make_geq_streams, make_stereo,
    probe_signals, synth_class, tp_inputs, transform_inputs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPAT_FLIPPED = 1e-3  # f64 against the reference: one step, on under 0.1% of the samples
MFCC_PIPE_DB = ENGINE_FIDELITY["mfcc", "mxu3"]["floor"]  # the mfcc pipeline vs the reference
MFCC_FULL_DB = 85.0   # mfcc_blocks(mxu3) at full size vs the f64 reference: the TPU kernel's level
CLASSES = 25          # class models gmm_train trains (jeicyboodsp_tpu/pipelines/registry.py:159)
TRAIN_BLOCKS, UTT_BLOCKS = 64, 32  # blocks of 1024 behind a class model / in an utterance


def _flip_count(got, want, share):
    """int16 outputs at most one step apart on under ``share`` of the samples."""
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max(initial=0) <= 1 and int((d > 0).sum()) < share * max(len(want), 1), (
        int(d.max(initial=0)), int((d > 0).sum()))


def _write_probe(work, name, x):
    """x behind a 44-byte header, which the pipelines that read a header skip."""
    path = os.path.join(work, f"{name}.wav")
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(path)
    return path


def test_engines_mxu8f_mxu8t_through_k14_equal_the_torch_vad_chain(cuda):
    """Engines mxu8f and mxu8t on the full-size chain signal (T = 16384):
    the int16 output through K14 equal to the same chain with the VAD as
    torch ops (``vad_rows``), and the same from blocks at an odd offset."""
    blocks = torch.from_numpy(chain_signals()[1].reshape(T_FULL, 512)).to(cuda)
    C = E.enhance_constants(cuda)
    odd = torch.empty(blocks.numel() + 1, dtype=blocks.dtype, device=cuda)[1:].view(blocks.shape)
    odd.copy_(blocks)
    for eng, hq in (("mxu8f", True), ("mxu8t", False)):
        new = E.enhance_blocks(blocks, "wiener", fft_engine=eng, resynth="ratio")[0]
        rowpack = E._latch_rowpack(K2.vad_rows(blocks, E._vad_window(cuda)))
        assert torch.equal(new, K.enhance_full8(blocks, rowpack, C, "wiener", hq)), eng
        assert torch.equal(E.enhance_blocks(odd, "wiener", fft_engine=eng, resynth="ratio")[0],
                           new), eng


def _finite_db(got, want, floor):
    """SNR over the finite features at or above ``floor``, the NaN and
    infinity masks (with signs) equal."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(w)
    inf = ~fin & ~np.isnan(w)
    assert g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
    assert np.array_equal(np.isinf(g), np.isinf(w)) and np.array_equal(g[inf], w[inf])
    err = g[fin] - w[fin]
    db = 10 * np.log10(np.sum(w[fin] ** 2) / max(np.sum(err ** 2), 1e-300))
    assert db >= floor, db


def _pitch_lines(text):
    """(lag, value, f0) arrays from the pitch pipeline's printed lines."""
    rows = [line.split() for line in text.splitlines() if line.startswith("Estimation arg")]
    return (np.array([int(r[2]) for r in rows], np.int64), np.array([float(r[5]) for r in rows]),
            np.array([float(r[7]) for r in rows]))


def test_feature_pipelines_and_ops_at_full_size(cuda, tmp_path):
    """The ``pitch1``-``pitch3`` pipelines in f64, ``pitch2`` through K11 in
    f64 and from the CLI with ``--fast --engine mxu`` on a speech probe with
    a silent stretch, a partial last block and an empty payload (lags equal;
    f64 values and f0 equal, to 1e-9 for method 1's FFT); the ``mfcc``
    pipeline in f64 and f32 xla/mxu3 (at the mxu3 floor); at full size
    ``mfcc_blocks(mxu3)`` (K10, >= 85 dB), ``speech_classify(mxu3)`` of 25
    utterances against 25 class models built from the reference's features
    (every argmax the class, scores within SCORE_RTOL) and
    ``pitch_frames(method=2, mxu)`` (K11; 256 sampled frames: f64 equal, f32
    lags equal up to f32 ties, the silent frame's lag 101); each against the
    port's float64 oracles."""
    work, dev = str(tmp_path), cuda
    rng = np.random.default_rng(SEED + 4)
    probe = speech_signal(40 * 512 + 300, rng, silent=(4096, 8192))  # partial last blocks
    cases = {"probe": probe, "empty": probe[:0]}
    paths = {c: _write_probe(work, f"feat_{c}", x) for c, x in cases.items()}
    mfcc_runs = {"f64 xla": (torch.float64, "xla"), "f32 xla": (torch.float32, "xla"),
                 "f32 mxu3": (torch.float32, "mxu3")}
    lists = {}
    for r in mfcc_runs:  # the probe first: its first frame is the run's, skipped
        tag = r.replace(" ", "_")
        lists[r] = os.path.join(work, f"mfcc_{tag}.list")
        with open(lists[r], "w") as f:
            f.writelines(f"{paths[c]} {os.path.join(work, f'{c}_{tag}.mfc')}\n" for c in cases)
    x, rows, frames = feature_inputs(dev)
    train = [class_signal(c, TRAIN_BLOCKS * 1024, rng) for c in range(CLASSES)]
    utts = [class_signal(c, UTT_BLOCKS * 1024, rng) for c in range(CLASSES)]
    model = class_models([reference_mfcc(t, skip_first=False) for t in train])
    tmodel = GM.model_to_port(*model, dev)
    printed = {}
    for c in cases:
        for m in (1, 2, 3):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                registry.pitch(paths[c], m, dtype=torch.float64, device=dev)
            printed[f"pitch{m} f64 xla", c] = out.getvalue()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            registry.pitch(paths[c], 2, dtype=torch.float64, fft_engine="mxu", device=dev)
        printed["pitch2 f64 mxu (K11)", c] = out.getvalue()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli.main(["pitch2", paths[c], "--fast", "--engine", "mxu", "--device", str(dev)])
        printed["cli pitch2 --fast --engine mxu (K11)", c] = out.getvalue()
    for r, (dtype, eng) in mfcc_runs.items():
        registry.mfcc(lists[r], dtype=dtype, fft_engine=eng, device=dev)
    mel_m, dct_m = F.mel_dct(torch.float32, dev)
    feats_full = F.mfcc_blocks(rows[1:].reshape(MFCC_T, 1024), mel_m, dct_m, dtype=torch.float32,
                               fft_engine="mxu3")
    scores = [S.speech_classify(torch.from_numpy(u.reshape(-1, 1024)).to(dev), *tmodel,
                                dtype=torch.float32, fft_engine="mxu3") for u in utts]
    lag64, val64, f064 = F.pitch_frames(frames, method=2, dtype=torch.float64, fft_engine="mxu")
    lag32, val32, _ = F.pitch_frames(frames, method=2, dtype=torch.float32, fft_engine="mxu")
    torch.cuda.synchronize()

    for (run, c), text in printed.items():
        m = int(run.split("pitch")[1][0])
        want, got = reference_pitch(cases[c], m), _pitch_lines(text)
        assert np.array_equal(got[0], want[0]), (run, c)
        if "--fast" not in run:  # f64: values and f0 too
            if m == 1:  # the FFTs' last bits differ between libraries
                np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=0)
            else:  # exact integer sums and one IEEE division
                assert np.array_equal(got[1], want[1]), (run, c)
            assert np.array_equal(got[2], want[2]), (run, c)
    for r in mfcc_runs:
        for first, (c, x_c) in zip((True, False), cases.items()):
            got = np.fromfile(os.path.join(work, f"{c}_{r.replace(' ', '_')}.mfc"), "<f8")
            want = reference_mfcc(x_c, skip_first=first).reshape(-1)
            if not len(want):
                assert not len(got), (r, c)
                continue
            _finite_db(got, want, MFCC_PIPE_DB)
    _finite_db(feats_full.cpu(), reference_mfcc(x, skip_first=False), MFCC_FULL_DB)
    for c, u in enumerate(utts):
        f = reference_mfcc(u, skip_first=False)
        want = np.array([reference_score(f, *(m[j] for m in model)) for j in range(CLASSES)])
        got = scores[c].cpu().numpy()
        assert int(np.argmax(got)) == int(np.argmax(want)) == c
        assert np.max(np.abs(got - want) / np.abs(want)) <= SCORE_RTOL
    idx = np.linspace(0, PITCH_T - 1, 256).astype(np.int64)
    idx[1] = 1_000_000 // 512 + 2  # a frame inside the silent stretch
    wl, wv, wf = reference_pitch_frames(frames[torch.from_numpy(idx).to(dev)].cpu().numpy(), 2)
    gl, gv, gf = (v.cpu().numpy()[idx] for v in (lag64, val64, f064))
    assert np.array_equal(gl, wl) and np.array_equal(gv, wv) and np.array_equal(gf, wf)
    l32, v32 = lag32.cpu().numpy()[idx], val32.cpu().numpy()[idx]
    ties = np.flatnonzero(l32 != wl)  # an f32 tie with a smaller lag is allowed
    assert all(np.float32(wv[i]) == v32[i] for i in ties) and gl[1] == 101


FC_FLOORS = {"xla": 88.0, "gemm": 95.0, "gemm8": 70.0, "gemm8hq": 85.0, "mxu": 88.0,
             "mxu3": 88.0, "auto": 85.0}  # f32 fastconv (tests/test_engine_matrix.py:134-163)
FC_SPARSE_DB = 95.0    # fastconv_blocks_sparse in f32 (tests/test_engine_matrix.py:153-160)
FC_F64_FLIPPED = 3e-3  # f64 fastconv: one int16 step on under 0.3% (tests/test_fastconv.py:16-25)
FFT_FLOORS = {"radix2": 65.0, "xla": 68.0, "fourstep": 65.0}  # f32 roundtrip (:166-176)
FFT_F64_DB = 70.0      # f64 radix2: one step at most, >= 70 dB (tests/test_fft_awgn.py:12-24)
FUSED_DB = 85.0        # _enhance_fused against the reference: the mxu3 floor


def _fc_verdict(got, want, floor=None):
    """One fastconv output against the f64 reference: f64 (floor None) within
    one step on under FC_F64_FLIPPED of the samples, f32 at its floor."""
    assert got.shape == want.shape, (got.shape, want.shape)
    if not len(want):
        return
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if floor is None:
        assert d.max() <= 1 and (d > 0).mean() < FC_F64_FLIPPED, (int(d.max()), (d > 0).mean())
    else:
        assert snr_db(want, got) >= floor


def test_fastconv_fft_and_enhance_fused_at_full_size(cuda, tmp_path):
    """The ``fastconv`` pipeline of every engine (f64 xla, f32 xla, gemm,
    gemm8, gemm8hq, mxu, mxu3, auto) and the ``fft`` pipeline (f64 radix2,
    ``--verbose`` lines) on probe files with a partial last block, an empty
    payload and (fastconv) T <= 7; every fastconv engine and
    ``fastconv_blocks_sparse`` at 2048 blocks, ``roundtrip_blocks`` f32
    radix2 / xla / fourstep and f64 radix2 at 16,384 blocks and
    ``_enhance_fused`` at T = 16384, each against the port's float64
    oracles (f64 within one step; f32 at the floors of
    tests/test_engine_matrix.py; ``_enhance_fused`` >= 85 dB)."""
    work, dev = str(tmp_path), cuda
    xc, xf = transform_inputs()
    x_enh = chain_signals()[1]
    blocks = torch.from_numpy(x_enh.reshape(T_FULL, 512)).to(dev)
    probe = make_signal(40 * 1024 + 300, np.random.default_rng(SEED + 6))
    fc_cases = {"probe": probe, "short": probe[: 5 * 1024 + 7], "empty": probe[:0]}
    fft_cases = {"probe": probe[: 30 * 512 + 77], "empty": probe[:0]}
    fc_runs = {"f64 xla": (torch.float64, "xla", None),
               **{f"f32 {e}": (torch.float32, e, FC_FLOORS[e]) for e in FC_FLOORS}}
    for c, x in fc_cases.items():
        path = _write_probe(work, f"fc_{c}", x)
        for run, (dtype, eng, floor) in fc_runs.items():
            out = os.path.join(work, f"fc_{c}_{run.replace(' ', '_')}.pcm")
            registry.fastconv(path, out, dtype=dtype, fft_engine=eng, device=dev)
            _fc_verdict(np.fromfile(out, "<i2"), reference_fastconv(x), floor)
    for c, x in fft_cases.items():
        out = os.path.join(work, f"fft_{c}.pcm")
        with contextlib.redirect_stdout(io.StringIO()) as text:
            registry.fft_roundtrip(_write_probe(work, f"fft_{c}", x), out, verbose=True, device=dev)
        got, want, printed = np.fromfile(out, "<i2"), reference_fft_roundtrip(x), text.getvalue()
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert got.shape == want.shape and d.max(initial=0) <= 1, c
        lines = printed.count("512-point FFT Calculation add 2304 multiply 2048")
        assert lines == 2 * len(want) // 512, c
        assert printed.endswith("Break! The buffer is insufficient.\nProcessing End\n"), c
    ref_fc = reference_fastconv(xc)
    for run, (dtype, eng, floor) in fc_runs.items():
        _fc_verdict(FC.run_stream(xc, dtype=dtype, fft_engine=eng, device=dev), ref_fc, floor)
    cb = torch.from_numpy(xc.reshape(FC_T, 1024)).to(dev)
    sparse = FC.fastconv_blocks_sparse(cb, torch.float32).reshape(-1).cpu().numpy()
    _fc_verdict(sparse, ref_fc, FC_SPARSE_DB)
    fb = torch.from_numpy(xf.reshape(FFT_T, 512)).to(dev)
    ref_fft = reference_fft_roundtrip(xf)
    rts = {e: FT.roundtrip_blocks(fb, torch.float32, e).reshape(-1).cpu().numpy()
           for e in FFT_FLOORS}
    for eng, got in rts.items():
        assert snr_db(ref_fft, got) >= FFT_FLOORS[eng], eng
    got = FT.run_stream(xf, device=dev)  # f64 radix2
    assert snr_db(ref_fft, got) >= FFT_F64_DB
    assert np.abs(got.astype(np.int64) - ref_fft.astype(np.int64)).max() <= 1
    fused, mask = E._enhance_fused(blocks, "wiener", False)
    got = fused[mask].reshape(-1).cpu().numpy()
    ref_enh = reference_enhance(x_enh, "wiener")
    assert got.shape == ref_enh.shape and snr_db(ref_enh, got) >= FUSED_DB


def _cli_stream(*args):
    """The port's ``stream`` command in a subprocess on the card; its exit code."""
    cmd = [sys.executable, "-m", "jeicyboodsp_tpu_torch.cli", "stream", *args, "--device", "cuda"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode in (0, 137), res.stderr[-2000:]
    return res.returncode


def test_stream_cli_killed_twice_and_resumed_on_the_card(cuda, tmp_path):
    """The ``stream`` CLI on the card over the full-size chain signal, in
    subprocesses with ``--chunk-blocks 64``: killed twice by
    ``--crash-after 50`` (checkpoints every 8 chunks) and finished, its
    output byte-identical to an uninterrupted run, which is within one step
    on under 0.1% of ``reference_enhance``."""
    x_full = chain_signals()[1]
    inp, whole = str(tmp_path / "in.pcm"), str(tmp_path / "whole.pcm")
    killed, ck = str(tmp_path / "killed.pcm"), str(tmp_path / "ck.npz")
    x_full.tofile(inp)
    chunk = ("--chunk-blocks", "64")
    rcs = [_cli_stream(inp, whole, "wiener", *chunk)]
    common = (inp, killed, "wiener", *chunk, "--ckpt", ck, "--ckpt-every", "8")
    rcs += [_cli_stream(*common, "--crash-after", "50") for _ in range(2)]
    rcs.append(_cli_stream(*common))
    assert rcs == [0, 137, 137, 0]
    np.testing.assert_array_equal(np.fromfile(killed, "<i2"), np.fromfile(whole, "<i2"))
    _flip_count(np.fromfile(whole, "<i2"), reference_enhance(x_full, "wiener"), COMPAT_FLIPPED)


def test_mvdr_blocks_at_full_size_on_the_card(cuda):
    """``mvdr_blocks`` (torch ops, no kernel) over 16,384 stereo blocks
    against ``reference_mvdr``: f64 xla and ``steering_delay(0.3)`` within
    one step on under 1% of the samples (tests/test_mvdr.py); f32 xla and
    mxu3 with ``collapse=False`` >= 60 dB; the mxu3 collapse within one step
    on under 1% and >= 90 dB."""
    from jeicyboodsp_tpu_torch.ops import mvdr as MV

    xl, xr = make_stereo(T_FULL * 512, np.random.default_rng(SEED + 3))
    dt = MV.steering_delay(0.3)
    refs = {0.0: reference_mvdr(xl, xr), dt: reference_mvdr(xl, xr, d_time=dt)}
    bl, br = (torch.from_numpy(x.reshape(T_FULL, 512)).to(cuda) for x in (xl, xr))
    cases = {  # name: (dtype, engine, collapse, d_time)
        "f64 xla": (torch.float64, "xla", True, 0.0),
        "f32 xla": (torch.float32, "xla", True, 0.0),
        "f32 mxu3 collapse=False": (torch.float32, "mxu3", False, 0.0),
        "f32 mxu3 (collapse)": (torch.float32, "mxu3", True, 0.0),
        "f64 xla steering 0.3": (torch.float64, "xla", True, dt),
    }
    for name, (dtype, eng, col, d) in cases.items():
        out, mask = MV.mvdr_blocks(bl, br, d, dtype=dtype, fft_engine=eng, collapse=col)
        got, ref = out[mask].reshape(-1).cpu().numpy(), refs[d]
        assert got.shape == ref.shape and not np.isnan(snr_db(ref, got)), name
        if dtype == torch.float64 or col and eng == "mxu3":
            _flip_count(got, ref, 0.01)
        if dtype == torch.float32:
            assert snr_db(ref, got) >= (90.0 if col and eng == "mxu3" else 60.0), name


# tests/test_gmm.py:25-41, :136, :406: the training, compat and corrected decode bounds
ALPHA_RTOL, MEAN_TOL, COV_TOL, DOT_TOL = 1e-6, 1e-5, 1e-4, 1e-5
VIT_RTOL = 1e-9
ASSOC_RTOL, ASSOC_ATOL = 1e-5, 1e-2
PRINTED_ATOL = 5e-7       # half a unit of %f's last digit
F32_TIE_ULPS = 4          # an f32 decode may pick another state where two states' f64 values
                          # differ by this few f32 spacings of the score (2^-8 at T = 4096): its
                          # partial sums round there (seen: up to 1.42 on the CPU, three seeds)
GMM_C, GMM_F = 25, 512    # classes x frames of the training corpus (bench/all_configs.py:938)
GMM_TEST_FILES, GMM_TEST_FRAMES = 2, 128  # a class's test files (the benchmark's 4 x 128, :990)
VIT_U, VIT_T = 512, 512   # the corpus decode: utterances x frames (:904)


def _c_argmax(scores):
    """GMMAlgorithm_Test_Auto_ver2.cpp:117-124: strict <, first wins, a NaN
    keeps the incumbent."""
    pred, best = 0, scores[0]
    for u in range(1, len(scores)):
        if best < scores[u]:
            best, pred = scores[u], u
    return pred


def _check_trained(got, refs):
    """A PCA export (numpy, per class) against reference_train_class at
    tests/test_gmm.py's bounds, the eigenvectors' signs aligned first
    (cuSOLVER's differ from LAPACK's)."""
    for c, ref in enumerate(refs):
        a, m, cv, e = (x[c] for x in got)
        s = np.sign(np.sum(e * ref.eigvec, axis=1))
        s[s == 0] = 1.0
        m = m.copy()
        m[:, :PCA_TRAIN] *= s
        assert np.max(np.abs(a - ref.alpha) / np.abs(ref.alpha)) <= ALPHA_RTOL, c
        assert np.max(np.abs(m - ref.mean) / (1 + np.abs(ref.mean))) <= MEAN_TOL, c
        assert np.max(np.abs(cv - ref.cov) / (1 + np.abs(ref.cov))) <= COV_TOL, c
        assert np.max(np.abs(np.abs(np.sum(e * ref.eigvec, axis=1))[:, :4] - 1)) <= DOT_TOL, c


def _same_value(got, want, rtol, atol=0.0):
    return (np.isnan(got) and np.isnan(want)) or abs(got - want) <= atol + rtol * abs(want)


def test_speech_recognition_on_the_card(cuda, tmp_path):
    """Speech recognition on the card against the port's float64 oracles
    (``oracle/gmm.py``, ``oracle/viterbi.py``):

    - ``train_classes_batched`` in f64 over 25 classes x 512 frames of
      synth_class and the ``gmm-train`` CLI's model file at
      tests/test_gmm.py's bounds; ``gmm-test`` on that file through the CLI
      (the reference's misaligned read) and the pipeline aligned, every
      printed decision that of reference_score_file;
    - ``speech_train(mxu3, f32, K10)`` over 25 x 64 blocks of class_signal,
      then ``speech_classify(mxu3)`` of an utterance a class with the models
      in f64: every decision that of reference_score_file on the f64 MFCC,
      NaN scores in the same places, the finite models' scores within
      SCORE_RTOL;
    - ``viterbi(compat=True)`` on the benchmark's packed HMM at T = 4096 (its
      observation, and state 0 held) against reference_hmm_decode (paths
      equal, scores and per-time values within 1e-9, NaN equal), the
      ``viterbi --verbose`` CLI's lines within %f's rounding; the corrected
      decode against ``viterbi_assoc`` in f64, both in f32 against the f64
      decode (paths equal but at f32 ties); ``viterbi_batched`` over 512 x
      512 against single decodes of 8 utterances;
    - the ``awgn`` CLI at 16,384 blocks: the noise recovered through the wrap
      has |mean| < 0.5 and 8.5 < std < 11.5, a 32760 stretch wraps negative,
      whiteness_ratio below 0.25 after the first block and within 1e-9 of a
      numpy f64 autocorrelation."""
    from jeicyboodsp_tpu_torch.models import hmm as H
    from jeicyboodsp_tpu_torch.ops import awgn as AW

    work, dev = str(tmp_path), cuda
    rng = np.random.default_rng(SEED + 7)
    feats = np.stack([synth_class(1000 + c, GMM_F) for c in range(GMM_C)])
    refs = [reference_train_class([feats[c]]) for c in range(GMM_C)]
    lists = []
    for c in range(GMM_C):
        p = os.path.join(work, f"c{c}.mfc")
        feats[c].astype("<f8").tofile(p)
        lists.append(os.path.join(work, f"c{c}.lst"))
        with open(lists[-1], "w") as f:
            f.write(p)  # no trailing whitespace: the reference's fscanf loop
    train_list, model = os.path.join(work, "train.lst"), os.path.join(work, "model.bin")
    with open(train_list, "w") as f:
        f.write("\n".join(lists))
    r2 = np.random.default_rng(555)
    test_lists, test_files = [], []
    for c in range(GMM_C):
        paths = []
        for j in range(GMM_TEST_FILES):
            fr = (feats[c][r2.integers(0, GMM_F, GMM_TEST_FRAMES)]
                  + r2.normal(0, 0.3, (GMM_TEST_FRAMES, 12)))
            paths.append(os.path.join(work, f"t{c}_{j}.mfc"))
            fr.astype("<f8").tofile(paths[-1])
            test_files.append(fr)
        test_lists.append(os.path.join(work, f"t{c}.lst"))
        with open(test_lists[-1], "w") as f:
            f.write("\n".join(paths))
    test_list = os.path.join(work, "test.lst")
    with open(test_list, "w") as f:
        f.write("\n".join(test_lists))
    train = [class_signal(c, TRAIN_BLOCKS * 1024, rng) for c in range(CLASSES)]
    utts = [class_signal(c, UTT_BLOCKS * 1024, rng) for c in range(CLASSES)]
    audio = torch.from_numpy(np.stack(train).reshape(CLASSES, TRAIN_BLOCKS, 1024)).to(dev)
    (vf, va, vm, vc, ve, vt), (hstates, htrans, hobs, hobs0) = bench_hmm(rng)
    hmm_path, obs_path = os.path.join(work, "hmm.bin"), os.path.join(work, "obs.mfc")
    with open(hmm_path, "wb") as f:
        for a, m, cv, ev in hstates:
            f.write(b"".join(np.asarray(x, "<f8").tobytes() for x in (a, m, cv, ev)))
        f.write(np.asarray(htrans, "<f8").tobytes())
    hobs.astype("<f8").tofile(obs_path)
    obs_list = os.path.join(work, "obs.lst")
    with open(obs_list, "w") as f:
        f.write(obs_path)
    dec32 = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (vf, va, vm, vc, ve, vt)]
    hmm64 = H.hmm_to_port(*(np.stack([s[i] for s in hstates]) for i in range(4)), htrans, dev)
    corpus = torch.from_numpy(rng.normal(0, 1.0, (VIT_U, VIT_T, 12)).astype(np.float32)).to(dev)
    lengths = torch.full((VIT_U,), VIT_T, dtype=torch.int64, device=dev)
    awgn_x = make_signal(T_FULL * 512, rng)
    awgn_x[: 20 * 512] = 32760
    awgn_in, awgn_out = _write_probe(work, "awgn_in", awgn_x), os.path.join(work, "awgn_out.pcm")

    ft = torch.from_numpy(feats).to(dev)
    trained = GM.train_classes_batched(ft, torch.ones(GMM_C, GMM_F, dtype=torch.bool, device=dev))
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["gmm-train", train_list, model])  # the card: the CLI's default device
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(["gmm-test", test_list, model])
    printed_mis = out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        registry.gmm_test(test_list, model, emulate_layout_mismatch=False)
    printed_al = out.getvalue()
    s_model = S.speech_train(audio, dtype=torch.float32, fft_engine="mxu3")
    s_model64 = [x.double() for x in s_model[:3]] + [s_model[3][..., :4].double()]
    s_scores = [S.speech_classify(torch.from_numpy(u.reshape(-1, 1024)).to(dev), *s_model64,
                                  dtype=torch.float32, fft_engine="mxu3")
                for u in utts]  # the f32 features scored in f64
    compat_runs = [H.viterbi(torch.from_numpy(o).to(dev), *hmm64, compat=True, full=True)
                   for o in (hobs, hobs0)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(["viterbi", obs_list, hmm_path, "--verbose"])
    printed_vit = out.getvalue()
    dec64 = [t.double() for t in dec32]
    corrected = {dt: (H.viterbi(*d, compat=False), H.viterbi_assoc(*d))
                 for dt, d in (("f64", dec64), ("f32", dec32))}
    paths_b, scores_b = H.viterbi_batched(corpus, lengths, *dec32[1:], compat=False)
    cli.main(["awgn", awgn_in, awgn_out])
    torch.cuda.synchronize()

    # training, and gmm-test on the trained file
    _check_trained([x.cpu().numpy() for x in trained], refs)
    with open(model, "rb") as f:
        raw = np.frombuffer(f.read(), "<f8").reshape(GMM_C, -1)
    _check_trained([raw[:, :4], raw[:, 4:52].reshape(-1, 4, 12),
                    raw[:, 52:628].reshape(-1, 4, 12, 12), raw[:, 628:].reshape(-1, 4, 12, 8)],
                   refs)
    for printed, pca in ((printed_mis, PCA_TEST), (printed_al, PCA_TRAIN)):
        stride = 8 * (4 + 48 + 576 + 48 * pca)  # bytes of a GMMParameter struct
        models = reference_read_models(model, GMM_C, stride, pca)
        want = [f"{i // GMM_TEST_FILES + 1} -th result "
                f"{_c_argmax([reference_score_file(fr, *m) for m in models]) + 1}"
                for i, fr in enumerate(test_files)]
        assert printed.splitlines() == want, pca
    # speech_train(mxu3) through K10 and speech_classify
    model64 = [x.cpu().numpy() for x in s_model64]
    ref_models = [(model64[0][c], model64[1][c], np.stack([np.diag(v)[:4] for v in model64[2][c]]),
                   model64[3][c]) for c in range(CLASSES)]
    finite = np.isfinite(model64[0]).all(1) & np.isfinite(model64[3]).all((1, 2, 3))
    assert finite.any()
    for c, u in enumerate(utts):
        f = reference_mfcc(u, skip_first=False)
        want = np.array([reference_score_file(f, *m) for m in ref_models])
        got = s_scores[c].cpu().numpy()
        assert _c_argmax(got.tolist()) == _c_argmax(want.tolist()), c
        assert np.array_equal(np.isnan(got), np.isnan(want)), c
        assert _c_argmax(got[finite].tolist()) == _c_argmax(want[finite].tolist()), c
        assert np.max(np.abs(got[finite] - want[finite]) / np.abs(want[finite])) <= SCORE_RTOL
    # decodes
    states4 = [(a, m, np.stack([np.diag(c)[:4] for c in cv]), e) for a, m, cv, e in hstates]
    for o, (path_c, score_c, bests_c) in zip((hobs, hobs0), compat_runs):
        bests = []
        rpath, rscore = reference_hmm_decode(o, states4, htrans, bests)
        assert np.array_equal(path_c.cpu().numpy(), rpath)
        assert _same_value(float(score_c), rscore, VIT_RTOL)
        assert all(_same_value(g, w, VIT_RTOL) for g, w in zip(bests_c.cpu().numpy()[1:][::-1],
                                                                 bests))
        if o is hobs:
            ref_bests, ref_path = bests, rpath
    vals = [float(v) for v in re.findall(r"max accumulated prob (\S+)", printed_vit)]
    assert len(vals) == HMM_T - 1
    assert all(_same_value(g, w, VIT_RTOL, PRINTED_ATOL) for g, w in zip(vals, ref_bests))
    assert printed_vit.splitlines()[-1] == "".join("%d ," % d for d in ref_path)
    assert "decoding result ! " in printed_vit
    (path_s, score_s), (path_a, score_a) = corrected["f64"]
    assert torch.equal(path_s, path_a)
    assert abs(float(score_s) - float(score_a)) <= ASSOC_ATOL + ASSOC_RTOL * abs(float(score_a))
    f32_rtol = HMM_T * 2.0 ** -24  # a sum of HMM_T f32 terms, rounded at every step
    P64 = reference_forward(*(t.cpu().numpy().astype(np.float64) for t in dec32))
    p64 = path_s.cpu().numpy()
    for p32, s32 in corrected["f32"]:
        diff = np.flatnonzero(p32.cpu().numpy() != p64)
        a, b = p32.cpu().numpy()[diff], p64[diff]
        ulps = np.abs(P64[diff, a] - P64[diff, b]) / np.spacing(np.float32(abs(float(score_s))))
        assert (ulps <= F32_TIE_ULPS).all()
        assert abs(float(s32) - float(score_s)) <= f32_rtol * abs(float(score_s))
    for u in np.linspace(0, VIT_U - 1, 8).astype(int):
        p1, s1 = H.viterbi(corpus[u], *dec32[1:], compat=False)
        assert torch.equal(p1, paths_b[u])
        assert abs(float(s1) - float(scores_b[u])) / abs(float(s1)) <= ASSOC_RTOL
    # awgn
    got = np.fromfile(awgn_out, "<i2")
    noise = (got.astype(np.int32) - awgn_x[: len(got)]).astype(np.int16)
    n = noise.astype(np.float64)
    assert len(got) == T_FULL * 512 and abs(n.mean()) < 0.5 and 8.5 < n.std() < 11.5
    assert np.all(got[: 20 * 512][n[: 20 * 512] > 7] < 0)  # the 32760 stretch wraps
    ratios = AW.whiteness_ratio(torch.from_numpy(noise.reshape(-1, 512)).to(dev)).cpu().numpy()
    u = noise.reshape(-1, 512).astype(np.float64)
    frames = np.concatenate([np.concatenate([np.zeros((1, 512)), u[:-1]]), u], 1)
    X = np.fft.fft(frames, axis=1)
    ac = np.fft.ifft(X.real ** 2 + X.imag ** 2, axis=1).real[:, :512]
    want_r = np.abs(ac[:, 1:]).max(1) / np.maximum(ac[:, 0], 1e-30)
    assert ratios[1:].max() < 0.25 and np.allclose(ratios, want_r, rtol=1e-9, atol=0)


LPC_F64_RTOL = 1e-9   # lpc solve f64 against reference_lpc, of the largest coefficient


def test_lpc_run_at_full_size_on_the_card(cuda):
    """``lpc_run`` over LPC_T frames of 512 on the card: ``solve`` in f64
    within 1e-9 of reference_lpc's largest coefficient; ``levinson`` in f32
    finite, its per-frame error median and count of frames above 1e-2
    within LPC_F32_MEDIAN and LPC_F32_LOST, 4x JAX's f32 op on these frames
    (tests/test_torch_lpc.py holds these limits to JAX's reading)."""
    x = lpc_signal()
    want = reference_lpc(x)
    got64 = F.lpc_run(x, dtype=torch.float64, solver="solve", device=cuda)
    got32 = F.lpc_run(x, dtype=torch.float32, solver="levinson", device=cuda)
    assert got64.shape == got32.shape == want.shape
    assert np.abs(got64 - want).max() / np.abs(want).max() <= LPC_F64_RTOL
    e32 = np.abs(got32 - want).max(1) / np.abs(want).max(1)
    assert np.isfinite(got32).all() and np.median(e32) <= LPC_F32_MEDIAN
    assert int((e32 > 1e-2).sum()) <= LPC_F32_LOST


GEQ_FAST_FLIPS = 1e-3  # c_short(geq_apply_fast f64) against reference_geq_linear: share of
                       # samples one step off (the scan groups its f64 sums otherwise)


def test_geq_apply_fast_at_full_size_on_the_card(cuda):
    """``geq_apply_fast`` in f64 over 2048 x 49,152 in one call on the card,
    finite, against reference_geq_linear on a wrap-stress stream and a tone:
    c_short of the output one step off on under GEQ_FAST_FLIPS of the
    samples."""
    from jeicyboodsp_tpu_torch.utils.cnum import c_short as t_c_short

    geq = make_geq_streams(GEQ_B, GEQ_T, cuda)
    b, a = G.geq_coefficients()
    y = G.geq_apply_fast(geq, b, a, dtype=torch.float64)
    assert bool(torch.isfinite(y).all())
    for s in (0, GEQ_B - 1):
        want = reference_geq_linear(geq[s].cpu().numpy(), b, a)
        d = np.abs(t_c_short(y[s]).cpu().numpy().astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1 and (d != 0).mean() <= GEQ_FAST_FLIPS, (s, int(d.max()))


ENHANCE_MODES = ("wiener", "specsub")
COMPAT_F32 = {"xla": 95.0, "mxu": 90.0}  # f32 with the log-depth scan (test_engine_matrix.py:39-55)


@functools.lru_cache(maxsize=1)
def _chain_cases():
    """The chain's probe (T_PROBE blocks), its full-size signal (T_FULL
    blocks), the probe less its last 100 samples and an empty payload, and
    ``reference_enhance`` of each in each mode."""
    probe, x_full = chain_signals()
    cases = {"probe": probe, "full": x_full, "partial": probe[: T_PROBE * 512 - 100],
             "empty": probe[:0]}
    return cases, {(c, m): reference_enhance(x, m) for c, x in cases.items() for m in ENHANCE_MODES}


def test_file_pipelines_of_the_int8_engines_at_their_floors(cuda, tmp_path):
    """The ``wiener`` and ``specsub`` file pipelines of engines mxu8f, mxu8t,
    mxu8 and mxu3 on the chain's probe, full-size, partial and empty cases
    (:func:`_chain_cases`), each against ``reference_enhance`` at the
    engine's floor (the empty payload gives 0 samples); K1-K5, the noise
    latch and K14 each launched."""
    cases, refs = _chain_cases()
    counted = {"K1": K.enhance_full8, "K2": K2.enhance_fwd_int8, "K3": K3.enhance_back_ola8,
               "K4": K4.enhance_fwd, "K5": K5.enhance_back_ola3, "latch": K.noise_latch,
               "K14": K14.vad_flags}
    before = {k: fn.launches for k, fn in counted.items()}
    for c, x in cases.items():
        inp = str(tmp_path / f"{c}.pcm")
        x.tofile(inp)
        for mode in ENHANCE_MODES:
            want = refs[c, mode]
            for eng, floor in FIDELITY.items():
                out = str(tmp_path / f"{c}_{mode}_{eng}.pcm")
                getattr(registry, mode)(inp, out, fft_engine=eng, device=cuda)
                got = np.fromfile(out, "<i2")
                assert got.shape == want.shape, (c, mode, eng)
                if len(want):
                    assert snr_db(want, got) >= floor, (c, mode, eng)
    torch.cuda.synchronize()
    assert [k for k, fn in counted.items() if fn.launches == before[k]] == []


def test_compat_cli_at_full_size_on_the_card(cuda, tmp_path):
    """The ``wiener`` and ``specsub`` CLI's default command (float64 ``xla``:
    torch ops, no kernel) on the card on each of :func:`_chain_cases`, within
    one step of ``reference_enhance`` on under 0.1% of the samples; on the
    probe, f32 ``xla`` >= 95 dB and ``mxu`` >= 90 dB with the log-depth scan,
    and ``wiener --fast --engine mxu8f`` from the CLI at mxu8f's floor; K1,
    the noise latch and K14 launched."""
    cases, refs = _chain_cases()
    counted = {"K1": K.enhance_full8, "latch": K.noise_latch, "K14": K14.vad_flags}
    before = {k: fn.launches for k, fn in counted.items()}
    out = {}
    for c, x in cases.items():
        inp = str(tmp_path / f"{c}.pcm")
        x.tofile(inp)
        for mode in ENHANCE_MODES:
            path = str(tmp_path / f"{c}_{mode}_compat.pcm")
            cli.main([mode, inp, path, "--device", str(cuda)])
            out[c, mode] = np.fromfile(path, "<i2")
    f32 = {(mode, eng): E.run_stream(cases["probe"], mode, dtype=torch.float32,
                                     use_assoc_scan=True, fft_engine=eng, device=cuda)
           for mode in ENHANCE_MODES for eng in COMPAT_F32}
    fast = str(tmp_path / "probe_wiener_fast_mxu8f.pcm")
    cli.main(["wiener", str(tmp_path / "probe.pcm"), fast, "--fast", "--engine", "mxu8f",
              "--device", str(cuda)])
    torch.cuda.synchronize()
    assert [k for k, fn in counted.items() if fn.launches == before[k]] == []
    for key, got in out.items():
        _flip_count(got, refs[key], COMPAT_FLIPPED)
    for (mode, eng), got in f32.items():
        assert snr_db(refs["probe", mode], got) >= COMPAT_F32[eng], (mode, eng)
    assert snr_db(refs["probe", "wiener"], np.fromfile(fast, "<i2")) >= FIDELITY["mxu8f"]


STREAM_CHUNK = 4                     # blocks per chunk: JAX's default (stream --chunk-blocks)
STREAM_RAGGED = (1, 3, 5, 7, 4, 11)  # chunk sizes in turn


def _session_run(sess, blocks, sizes):
    """Blocks through an EnhanceSession in chunks cycling through sizes: the
    output and the number of chunks."""
    outs, s, i = [], 0, 0
    while s < len(blocks):
        k = sizes[i % len(sizes)]
        outs.append(sess.process(blocks[s: s + k]))
        s, i = s + k, i + 1
    return np.concatenate(outs), i


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_enhance_sessions_at_full_size_on_the_card(cuda, dtype, tmp_path):
    """EnhanceSession ``wiener`` over the full-size chain signal (T_FULL
    blocks) on the card, in chunks of 4 with a checkpoint at the middle
    block restored into a fresh session, and in ragged chunks: the restored
    session's second half equal to the first session's.  f64: both runs and
    the one-shot ``run_stream`` within one step on under 0.1% of
    ``reference_enhance``, the chunks of 4 so of the one-shot run too, one
    K15 launch a chunk.  f32: both runs equal to the one-shot f32
    ``run_stream``, no K15 launch."""
    from jeicyboodsp_tpu_torch.io import stream as ST
    from jeicyboodsp_tpu_torch.kernels import enhance_chunk64 as K15

    x_full = chain_signals()[1]
    blocks = x_full.reshape(T_FULL, 512)
    half = T_FULL // 2 // STREAM_CHUNK * STREAM_CHUNK
    ck = str(tmp_path / "ck.npz")

    def make():
        return ST.EnhanceSession("wiener", dtype=dtype, device=cuda)

    one = E.run_stream(x_full, "wiener", dtype=dtype, device=cuda)
    before = K15.enhance_chunk64.launches
    sess = make()
    first, n_first = _session_run(sess, blocks[:half], [STREAM_CHUNK])
    sess.checkpoint(ck)
    second, n_second = _session_run(sess, blocks[half:], [STREAM_CHUNK])
    fresh = make()
    fresh.restore(ck)
    assert fresh.sample_offset == half * 512
    again, n_again = _session_run(fresh, blocks[half:], [STREAM_CHUNK])
    ragged, n_ragged = _session_run(make(), blocks, STREAM_RAGGED)
    torch.cuda.synchronize()
    launches = K15.enhance_chunk64.launches - before
    np.testing.assert_array_equal(again, second)
    out = np.concatenate([first, second])
    if dtype == torch.float64:
        assert launches == n_first + n_second + n_again + n_ragged
        want = reference_enhance(x_full, "wiener")
        _flip_count(out, want, COMPAT_FLIPPED)
        _flip_count(ragged, want, COMPAT_FLIPPED)
        _flip_count(out, one, COMPAT_FLIPPED)
    else:
        assert launches == 0
        np.testing.assert_array_equal(out, one)
        np.testing.assert_array_equal(ragged, one)


AEC_SNR_FLOORS = (60.0, 40.0)  # est, err dB against the f64 references (tests/test_nlms.py:24-26)
AEC_SAMPLED = (0, AEC_B - 1)   # an echo stream and a double-talk stream


def _aec_floors(pairs):
    """(f64 reference, f32 output) of est and err at AEC_SNR_FLOORS."""
    s = [snr_db(w, g) for w, g in pairs]
    assert s[0] >= AEC_SNR_FLOORS[0] and s[1] >= AEC_SNR_FLOORS[1], s


def test_f32_aec_at_full_size_against_the_f64_references(cuda, tmp_path):
    """``nlms_apply`` and ``bnlms_apply`` in f32 (K8's and K9's f32
    instances) over AEC_B x AEC_T streams, 64 blocks of 1024 a stream: an
    echo stream and a double-talk stream, every block, against
    reference_nlms_blocks / reference_bnlms_blocks at 60 dB (est) and 40 dB
    (err), the states f32; the ``nlms`` and ``bnlms`` CLI with ``--fast`` on
    the echo probe against reference_nlms at the same floors; the ``nlms
    --verbose`` CLI's lines equal to the reference's coefficient trajectory
    under %f, its estimate int16-equal; both f32 kernels launched."""
    from jeicyboodsp_tpu_torch.oracle.cnum import stale_blocks
    from jeicyboodsp_tpu_torch.oracle.nlms import (
        reference_bnlms_blocks, reference_nlms, reference_nlms_blocks,
    )

    work, f32 = str(tmp_path), torch.float32
    px, pr = probe_signals()[1]["echo"]
    inp = _write_probe(work, "aec_in", px)
    refp = os.path.join(work, "aec_ref.pcm")
    pr.astype("<i2").tofile(refp)
    outs = {k: os.path.join(work, f"aec_{k}.pcm") for k in ("n_est", "n_err", "b_est", "b_err",
                                                            "v_est", "v_err")}
    x, r = make_aec_streams(AEC_B, AEC_T, cuda)
    nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in TN.nlms_init_state(f32).items()}
    bz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in TN.bnlms_init_state(f32).items()}
    n8, n9 = K8.nlms_f32.launches, K9.bnlms_f32.launches
    e8, r8, s8 = TN.nlms_apply(x, r, nz, dtype=f32)
    e9, r9, s9 = TN.bnlms_apply(x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024), bz,
                                dtype=f32)
    cli.main(["nlms", inp, refp, outs["n_est"], outs["n_err"], "--fast", "--device", str(cuda)])
    cli.main(["bnlms", inp, refp, outs["b_est"], outs["b_err"], "--fast", "--device", str(cuda)])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(["nlms", inp, refp, outs["v_est"], outs["v_err"], "--verbose",
                  "--device", str(cuda)])
    torch.cuda.synchronize()
    assert K8.nlms_f32.launches > n8 and K9.bnlms_f32.launches > n9
    assert s8["coeff"].dtype == s9["coeff"].dtype == f32
    xs, rs = x[list(AEC_SAMPLED)].cpu().numpy(), r[list(AEC_SAMPLED)].cpu().numpy()
    for i, s in enumerate(AEC_SAMPLED):
        xb, rb = xs[i].reshape(-1, 1024), rs[i].reshape(-1, 1024)
        _aec_floors(zip([v.reshape(-1) for v in reference_nlms_blocks(xb, rb)],
                        (e8[s].cpu(), r8[s].cpu())))
        _aec_floors(zip([v.reshape(-1) for v in reference_bnlms_blocks(xb, rb)[:2]],
                        (e9[s].reshape(-1).cpu(), r9[s].reshape(-1).cpu())))
    for kind, tag in (("nlms", "n"), ("bnlms", "b")):
        want = reference_nlms(px, pr, bnlms=kind == "bnlms")[:2]
        _aec_floors(zip(want, [np.fromfile(outs[f"{tag}_{k}"], "<i2") for k in ("est", "err")]))
    traj = []
    nb = -(-len(px) // 1024)
    ve, _ = reference_nlms_blocks(stale_blocks(px, 1024)[:nb], stale_blocks(pr, 1024)[:nb], traj)
    want = "".join("rgsdCoefficient[0] %f, rgsdCoefficient[1] %f, rgsdCoefficient[2] %f \n" % c
                   for c in traj)
    assert out.getvalue() == want
    np.testing.assert_array_equal(np.fromfile(outs["v_est"], "<i2"), ve[1:].reshape(-1))


GEQ_LINEAR_DB = 55.0  # K7's f32 cascade against a float64 one (tests/test_pallas_kernels.py:17)


def test_recursion_pipelines_and_ops_at_full_size(cuda, tmp_path):
    """The GEQ, NLMS and BNLMS paths on the card against the port's float64
    oracles: the ``geq`` pipeline (f64) byte-identical to reference_geq and
    ``geq --fast`` from the CLI to reference_geq_f32 on the probe, a partial
    and an empty payload; the ``nlms`` and ``bnlms`` pipelines int16-equal to
    reference_nlms on the echo, partial, shut-gate and empty probes; at full
    size K7 >= 55 dB of a float64 linear cascade on a wrap-stress stream and
    a tone; ``geq_apply`` (f64 and the f32 default) over GEQ_B x GEQ_T,
    ``nlms_apply`` and ``bnlms_apply`` over AEC_B x AEC_T, each as one call
    and as two chained with state, equal; sampled streams equal to the
    references (GEQ's wrap-stress stream and tone, f64 and f32; every block
    of an echo and a double-talk stream, est and err), and ``geq_apply`` at
    B = 3072 too; the BNLMS gates (float64 FFT) equal to the direct float64
    sums on the probes and on every block of 8 full-size double-talk
    streams; K6-K9 each launched."""
    from jeicyboodsp_tpu_torch.oracle.cnum import stale_blocks
    from jeicyboodsp_tpu_torch.oracle.geq import reference_geq, reference_geq_f32
    from jeicyboodsp_tpu_torch.oracle.nlms import (
        _double_talk, reference_bnlms_blocks, reference_nlms, reference_nlms_blocks,
    )

    work, dev = str(tmp_path), cuda
    geq, (x, r) = make_geq_streams(GEQ_B, GEQ_T, dev), make_aec_streams(AEC_B, AEC_T, dev)
    counted = {"K6": K6.geq_cascade_quant, "K7": K7.geq_cascade, "K8": K8.nlms, "K9": K9.bnlms}
    b, a = G.geq_coefficients()
    c32 = torch.from_numpy(K7.pack_coefficients(b, a)).to(dev)
    gprobe, pairs = probe_signals()
    geq_cases = {"probe": gprobe, "partial": gprobe[: 5 * 512 + 300], "empty": gprobe[:0]}
    hdr = np.arange(22, dtype=np.int16)  # 44 header bytes, skipped by geq and for IN
    for c, v in geq_cases.items():
        np.concatenate([hdr, v]).tofile(os.path.join(work, f"geq_{c}.wav"))
    for c, (xp, rp) in pairs.items():
        np.concatenate([hdr, xp]).tofile(os.path.join(work, f"aec_{c}_in.wav"))
        rp.tofile(os.path.join(work, f"aec_{c}_ref.pcm"))
    zeros = {"xh": torch.zeros(GEQ_B, 2, dtype=torch.int32),
             "yh": torch.zeros(GEQ_B, 7, 2, dtype=torch.int32)}
    half = GEQ_T // 2
    before = {k: fn.launches for k, fn in counted.items()}
    out = {}
    for c in geq_cases:
        path = os.path.join(work, f"geq_{c}.pcm")
        registry.geq(os.path.join(work, f"geq_{c}.wav"), path, device=dev)
        out["geq", c] = np.fromfile(path, "<i2")
        path = os.path.join(work, f"geq_fast_{c}.pcm")  # K6's f32 instance, from the CLI
        cli.main(["geq", os.path.join(work, f"geq_{c}.wav"), path, "--fast", "--device", str(dev)])
        out["geq --fast", c] = np.fromfile(path, "<i2")
    for prog in ("nlms", "bnlms"):
        for c in pairs:
            est, errp = (os.path.join(work, f"{prog}_{c}_{k}.pcm") for k in ("est", "err"))
            getattr(registry, prog)(os.path.join(work, f"aec_{c}_in.wav"),
                                    os.path.join(work, f"aec_{c}_ref.pcm"), est, errp, device=dev)
            out[prog, c] = (np.fromfile(est, "<i2"), np.fromfile(errp, "<i2"))
    yl = K7.geq_cascade(geq.float(), c32)
    f64 = torch.float64
    yw, sw = G.geq_apply(geq, b, a, zeros, dtype=f64)
    y1, s1 = G.geq_apply(geq[:, :half], b, a, zeros, dtype=f64)
    y2, s2 = G.geq_apply(geq[:, half:], b, a, s1, dtype=f64)
    fw, fsw = G.geq_apply(geq, b, a, zeros)  # the op's default, f32: K6's f32 instance
    f1, fs1 = G.geq_apply(geq[:, :half], b, a, zeros)
    f2, fs2 = G.geq_apply(geq[:, half:], b, a, fs1)
    nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in TN.nlms_init_state().items()}
    ew, rw, nw = TN.nlms_apply(x, r, nz)
    e1, r1, ns = TN.nlms_apply(x[:, :AEC_T // 2], r[:, :AEC_T // 2], nz)
    e2, r2, ns = TN.nlms_apply(x[:, AEC_T // 2:], r[:, AEC_T // 2:], ns)
    bz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in TN.bnlms_init_state().items()}
    xb, rb = x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024)
    nb2 = xb.shape[1] // 2
    bw, bew, bsw = TN.bnlms_apply(xb, rb, bz)
    b1, be1, bs = TN.bnlms_apply(xb[:, :nb2], rb[:, :nb2], bz)
    b2, be2, bs = TN.bnlms_apply(xb[:, nb2:], rb[:, nb2:], bs)
    g3 = geq.repeat(-(-3072 // len(geq)), 1)[:3072, :2048]  # B = 3072: the streams repeated
    z3 = {k: torch.zeros(3072, *v.shape[1:], dtype=v.dtype) for k, v in zeros.items()}
    y3, _ = G.geq_apply(g3, b, a, z3, dtype=f64)
    torch.cuda.synchronize()
    assert [k for k, fn in counted.items() if fn.launches == before[k]] == []

    for c, v in geq_cases.items():
        np.testing.assert_array_equal(out["geq", c], reference_geq(v, b, a), err_msg=c)
        np.testing.assert_array_equal(out["geq --fast", c], reference_geq_f32(v, b, a), err_msg=c)
    for i in (0, GEQ_B - 1):  # a wrap-stress stream and a tone
        want = reference_geq_linear(geq[i].cpu().numpy(), b, a)
        assert snr_db(want, c_short(yl[i].cpu().numpy())) >= GEQ_LINEAR_DB, i
    for prog in ("nlms", "bnlms"):
        for c, (xp, rp) in pairs.items():
            for g, w in zip(out[prog, c], reference_nlms(xp, rp, bnlms=prog == "bnlms")):
                np.testing.assert_array_equal(g, w, err_msg=f"{prog} {c}")
    gdiff = 0  # the gate: the port's float64 FFT against the direct float64 sums
    for c, (xp, rp) in pairs.items():
        nb = -(-min(len(xp), len(rp)) // 1024)
        if nb == 0:
            continue
        xs = torch.from_numpy(stale_blocks(xp, 1024)[:nb].reshape(1, -1)).to(dev)
        rs = torch.from_numpy(stale_blocks(rp, 1024)[:nb].reshape(1, -1)).to(dev)
        keep = torch.zeros(1, 127, dtype=torch.int16, device=dev)
        got = K9.bnlms_gates(xs, rs, keep, keep)[0, 1:].tolist()  # the written blocks
        gdiff += sum(g != w for g, w in zip(got, reference_nlms(xp, rp, bnlms=True)[2][1:]))
    n_dt = 8  # full-size double-talk streams whose every gate is checked
    keep = torch.zeros(n_dt, 127, dtype=torch.int16, device=dev)
    xs8, rs8 = x[-n_dt:].contiguous(), r[-n_dt:].contiguous()
    got8 = K9.bnlms_gates(xs8, rs8, keep, keep).cpu().numpy()
    for i in range(n_dt):
        u = np.concatenate([np.zeros(127), xs8[i].cpu().numpy().astype(np.float64)])
        v = np.concatenate([np.zeros(127), rs8[i].cpu().numpy().astype(np.float64)])
        for k in range(AEC_T // 1024):
            want = not _double_talk(u[k * 1024:k * 1024 + 1151], v[k * 1024:k * 1024 + 1151])
            gdiff += int(bool(got8[i, k]) != want)
    assert gdiff == 0
    assert torch.equal(torch.cat([y1, y2], 1), yw) and all(torch.equal(s2[k], sw[k]) for k in sw)
    assert torch.equal(torch.cat([f1, f2], 1), fw) and all(torch.equal(fs2[k], fsw[k]) for k in fsw)
    assert torch.equal(torch.cat([e1, e2], 1), ew) and torch.equal(torch.cat([r1, r2], 1), rw)
    assert all(torch.equal(ns[k], nw[k]) for k in nw)
    assert torch.equal(torch.cat([b1, b2], 1), bw) and torch.equal(torch.cat([be1, be2], 1), bew)
    assert all(torch.equal(bs[k], bsw[k]) for k in bsw)
    sampled = {
        "geq stream 0 (wrap stress)": (yw[0], reference_geq(geq[0].cpu().numpy(), b, a)),
        f"geq stream {GEQ_B - 1} (tone)": (yw[-1], reference_geq(geq[-1].cpu().numpy(), b, a)),
        "geq f32 stream 0 (wrap stress)": (fw[0], reference_geq_f32(geq[0].cpu().numpy(), b, a)),
    }
    for i in (0, 2047, 2048, 3071):
        sampled[f"geq B=3072 stream {i}"] = (y3[i], reference_geq(g3[i].cpu().numpy(), b, a))
    for i in (0, AEC_B - 1):  # every block of an echo stream and of a double-talk stream
        xi, ri = (v[i].cpu().numpy().reshape(-1, 1024) for v in (x, r))
        ref_n, ref_b = reference_nlms_blocks(xi, ri), reference_bnlms_blocks(xi, ri)
        sampled[f"nlms stream {i}"] = (torch.cat([ew[i], rw[i]]),
                                       np.concatenate([ref_n[0].reshape(-1), ref_n[1].reshape(-1)]))
        sampled[f"bnlms stream {i}"] = (torch.cat([bw[i].reshape(-1), bew[i].reshape(-1)]),
                                        np.concatenate([ref_b[0].reshape(-1), ref_b[1].reshape(-1)]))
    for what, (got, want) in sampled.items():
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=what)


def test_recursion_sessions_at_full_size_against_the_references(cuda, tmp_path):
    """GEQSession over one GEQ_T stream (three quarters of a tone, then a
    wrap-stress stream's last quarter) in chunks of 512 with a checkpoint at
    the middle, and AECSession ``nlms`` over an echo stream and ``bnlms``
    over a double-talk stream of AEC_T samples in chunks of 1024 with a
    checkpoint at the middle, each on the card: with the checkpoint,
    uninterrupted, and restored into a fresh session, equal to reference_geq
    / reference_nlms_blocks / reference_bnlms_blocks, the restored session's
    second half equal to the first session's; K6, K8 and K9 launched."""
    from jeicyboodsp_tpu_torch.io import stream as ST
    from jeicyboodsp_tpu_torch.oracle.geq import reference_geq
    from jeicyboodsp_tpu_torch.oracle.nlms import reference_bnlms_blocks, reference_nlms_blocks

    work, dev = str(tmp_path), cuda
    geq, aec = make_geq_streams(GEQ_B, GEQ_T, dev), make_aec_streams(AEC_B, AEC_T, dev)
    counted = {"K6": K6.geq_cascade_quant, "K8": K8.nlms, "K9": K9.bnlms}
    b, a = G.geq_coefficients()
    gx = np.concatenate([geq[GEQ_B // 8, : 3 * GEQ_T // 4].cpu().numpy(),
                         geq[0, 3 * GEQ_T // 4:].cpu().numpy()])  # a tone, then wrap stress
    ax, ar = aec[0][0].cpu().numpy(), aec[1][0].cpu().numpy()  # an echo
    bx, br = aec[0][-1].cpu().numpy(), aec[1][-1].cpu().numpy()  # double talk
    before = {k: fn.launches for k, fn in counted.items()}
    g1 = ST.GEQSession(device=dev)
    ya = np.concatenate([g1.process(gx[s: s + 512]) for s in range(0, GEQ_T // 2, 512)])
    g1.checkpoint(os.path.join(work, "geq_session.npz"))
    yb = np.concatenate([g1.process(gx[s: s + 512]) for s in range(GEQ_T // 2, GEQ_T, 512)])
    g2 = ST.GEQSession(device=dev)
    g2.restore(os.path.join(work, "geq_session.npz"))
    geq_runs = [np.concatenate([ya, yb]), g2.process(gx[GEQ_T // 2:]), yb,
                ST.GEQSession(device=dev).process(gx)]
    aec_runs = {}
    for variant, (xv, rv) in (("nlms", (ax, ar)), ("bnlms", (bx, br))):
        s1 = ST.AECSession(variant, device=dev)
        half = AEC_T // 2
        pa = [s1.process(xv[s: s + 1024], rv[s: s + 1024]) for s in range(0, half, 1024)]
        s1.checkpoint(os.path.join(work, f"{variant}_session.npz"))
        pb = [s1.process(xv[s: s + 1024], rv[s: s + 1024]) for s in range(half, AEC_T, 1024)]
        s2 = ST.AECSession(variant, device=dev)
        s2.restore(os.path.join(work, f"{variant}_session.npz"))
        aec_runs[variant] = ([np.concatenate([p[i] for p in pa + pb]) for i in (0, 1)],
                             s2.process(xv[half:], rv[half:]),
                             [np.concatenate([p[i] for p in pb]) for i in (0, 1)],
                             ST.AECSession(variant, device=dev).process(xv, rv))
    torch.cuda.synchronize()
    assert [k for k, fn in counted.items() if fn.launches == before[k]] == []
    want_geq = reference_geq(gx, b, a)
    np.testing.assert_array_equal(geq_runs[0], want_geq)
    np.testing.assert_array_equal(geq_runs[1], want_geq[GEQ_T // 2:])
    np.testing.assert_array_equal(geq_runs[3], want_geq)
    np.testing.assert_array_equal(geq_runs[1], geq_runs[2])
    wants = {"nlms": reference_nlms_blocks(ax.reshape(-1, 1024), ar.reshape(-1, 1024)),
             "bnlms": reference_bnlms_blocks(bx.reshape(-1, 1024), br.reshape(-1, 1024))}
    for variant, want in wants.items():
        whole_run, again, cont, uninterrupted = aec_runs[variant]
        for i in (0, 1):  # est, err
            ref = want[i].reshape(-1)
            np.testing.assert_array_equal(whole_run[i], ref, err_msg=variant)
            np.testing.assert_array_equal(uninterrupted[i], ref, err_msg=variant)
            np.testing.assert_array_equal(again[i], cont[i], err_msg=variant)


@pytest.mark.parametrize("n", sorted({STREAM_CHUNK, *STREAM_RAGGED}))
def test_k14_in_the_stream_chunk_sizes_bit_equal_to_vad_rows(cuda, n):
    """K14 at the row counts an EnhanceSession gives it: the full-size chain
    signal (T_FULL blocks) cut into chunks of ``n`` rows, each chunk's flags
    from the wrapper bit-equal to ``vad_rows`` on the same rows (the f32
    window the stream's VAD reads)."""
    w = E._vad_window(cuda)
    blocks = torch.from_numpy(chain_signals()[1].reshape(T_FULL, 512)).to(cuda)
    cuts = range(0, T_FULL, n)
    got = torch.cat([K14.vad_flags(blocks[s: s + n], w) for s in cuts])
    want = torch.cat([K2.vad_rows(blocks[s: s + n], w) for s in cuts])
    assert torch.equal(got, want), (got != want).nonzero()[:10, 0].tolist()


TP_LSB, TP_DB = 2, 60.0   # time-parallel against the f64 sequential path (tests/test_nlms.py:39-65)
TP_HEAD = 16              # blocks held to those bounds: the linearized recursion drifts after
                          # them (ROADMAP R20)


def test_timeparallel_session_at_full_size_on_the_card(cuda):
    """``bnlms_apply_timeparallel`` (f32) over the TP_T blocks of
    torch_inputs.tp_inputs on the card: its first 16 blocks within 2 steps of
    the f64 sequential path (the gates and K9 f64, int16-equal to the
    reference) and its error signal there >= 60 dB of the sequential one,
    as JAX's benchmark checks it (bench/all_configs.py:542-559); the whole
    session within one step on under 1% of the samples of the same op on the
    CPU."""
    x, r = tp_inputs(cuda)
    est, err = TN.bnlms_apply_timeparallel(x, r)
    e_seq, r_seq, _ = TN.bnlms_apply(x, r, TN.bnlms_init_state())
    d_e = (e_seq.to(torch.int64) - est.to(torch.int64)).abs()
    d_r = (r_seq.to(torch.int64) - err.to(torch.int64)).double()
    a = r_seq.double()[:TP_HEAD]
    db = float(10 * torch.log10((a ** 2).sum().clamp_min(1e-30)
                                / (d_r[:TP_HEAD] ** 2).sum().clamp_min(1e-30)))
    assert int(d_e[:TP_HEAD].max()) <= TP_LSB and int(d_r[:TP_HEAD].abs().max()) <= TP_LSB
    assert db >= TP_DB, db
    c_est, c_err = TN.bnlms_apply_timeparallel(x.cpu(), r.cpu())
    for g, w in ((est, c_est), (err, c_err)):
        d = (g.cpu().to(torch.int64) - w.to(torch.int64)).abs()
        assert int(d.max()) <= 1 and float((d != 0).double().mean()) < 0.01


K4_F64_TOL = 2.0 ** -18   # K4's re/im vs f64 products: of each row's largest sum of |a*b|
K4_PLAIN_TOL = 2.0 ** -16  # K4 vs its plain version: of each row's largest sum of |a*b|
LATCH_RTOL = 1e-6


def _inverse_bit_equal(pk, C, hq):
    """The int8 inverse pass (K1's and K3's): uv bit-equal to the plain
    inverse of the kernel's own q8 and rowsc."""
    want = K.inv8_plain(pk["q8"], pk["rowsc"], C, hq)
    assert torch.equal(pk["uv"].view(torch.int32), want.view(torch.int32))


def test_enhance_kernels_against_plain_on_the_full_chain_signal(cuda):
    """K1-K5, K13, K14 and the noise latch against their plain versions on the chain's
    full-size signal (T_FULL blocks): K1 in both modes, hq and turbo, >= 90
    dB, its forward planes bit-equal and its inverse's uv bit-equal to the
    plain inverse of its own q8 and rowsc; K2's re/im/|X| bit-equal, K4's
    within 2^-16 of each row's largest sum of |a*b| of the plain version and,
    against float64 products with the f64 bases, within 1e-5 of each
    plane's row max and 2^-18 of that sum; both forward kernels' speech and
    frame flags equal; the noise latch over each one's planes within 1e-6
    of the plain latch's max; K3 (on K2's planes) and K5 (on K4's) >= 90 dB
    in both modes, K3's inverse uv bit-equal, hq and turbo; K13 on K4's
    planes within 1e-5 of each frame row's max, NaN masks equal; K14's flags
    on the signal's rows and the threshold rows equal to ``vad_rows`` with
    the f32 window and the f64-built w2, the same at an odd offset."""
    blocks = torch.from_numpy(chain_signals()[1].reshape(T_FULL, 512)).to(cuda)
    C = E.enhance_constants(cuda)
    rowpack = E._latch_rowpack(E.vad_flags(blocks, torch.float32))
    for mode in ENHANCE_MODES:
        for hq in (True, False):
            got, pk = K.enhance_full8(blocks, rowpack, C, mode, hq, return_planes=True)
            want, pp = K.enhance_full8_plain(blocks, rowpack, C, mode, hq, return_planes=True)
            assert torch.equal(pk["re"], pp["re"]) and torch.equal(pk["im"], pp["im"]), (mode, hq)
            assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= KERNEL_VS_PLAIN_DB, (mode, hq)
            _inverse_bit_equal(pk, C, hq)
    back_ins = {}
    for name, (kernel, plain) in FWD.items():
        got, want = kernel(blocks, C), plain(blocks, C)
        assert torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]), name
        if name == "K2":
            assert all(torch.equal(got[i], want[i]) for i in (0, 1, 3))
        else:
            WC, WS = k4_f64_bases(cuda)
            frames = K4.frames_f32(blocks).double()
            scale = _k4_row_scale(blocks, C, (WC, WS)).clamp_min(1e-30)
            exact = (frames @ WC, frames @ WS)
            exact += (torch.sqrt(exact[0] ** 2 + exact[1] ** 2),)
            for i, w in zip((0, 1, 3), exact):
                assert float(((got[i].double() - want[i].double()).abs() / scale).max()) \
                    <= K4_PLAIN_TOL, i
                assert _rel(got[i].double(), w) <= F32_RTOL, i
            for i in (0, 1):
                assert float(((got[i].double() - exact[i]).abs() / scale).max()) <= K4_F64_TOL, i
        re, im, re_n, mag, mag_n, sp, nz = got
        rp = E._latch_rowpack(sp[:, 0] > 0.5)
        ns, ns_n = K.noise_latch(rp, mag, mag_n)
        want_ns = K.latch_from_rowpack(rp, torch.cat([mag, mag_n], 1), 64)
        assert float((torch.cat([ns, ns_n], 1) - want_ns).abs().max()
                     / want_ns.abs().max().clamp_min(1e-30)) <= LATCH_RTOL, name
        back_ins[name] = (re, im, re_n, ns, ns_n, nz)
    for name, (kernel, plain, fwd) in BACK.items():
        for mode in ENHANCE_MODES:
            got, want = kernel(*back_ins[fwd], C, mode), plain(*back_ins[fwd], C, mode)
            assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= KERNEL_VS_PLAIN_DB, (name, mode)
    for hq in (True, False):
        got, pk = K3.enhance_back_ola8(*back_ins["K2"], C, "wiener", hq, return_planes=True)
        want = K3.enhance_back_ola8_plain(*back_ins["K2"], C, "wiener", hq)
        assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= KERNEL_VS_PLAIN_DB, hq
        _inverse_bit_equal(pk, C, hq)
    for mode in ENHANCE_MODES:
        _row_check(K13.enhance_back(*back_ins["K4"], C, mode),
                   K13.enhance_back_plain(*back_ins["K4"], C, mode), f"K13 {mode}")
    for w2 in (E._vad_window(cuda), C["w2"]):
        rows = torch.cat([blocks, torch.from_numpy(vad_threshold_rows(w2.cpu().numpy())).to(cuda)])
        got = K14.vad_flags(rows, w2)
        assert torch.equal(got, K2.vad_rows(rows, w2))
        assert got[-6:].tolist() == [False, False, True, True, False, False]
        odd = torch.empty(rows.numel() + 1, dtype=rows.dtype, device=cuda)[1:].view(rows.shape)
        odd.copy_(rows)  # K14's 2-byte-load variant
        assert torch.equal(K14.vad_flags(odd, w2), got)


PLAIN_T = {"K6": 4096, "K7": 4096, "K8": 2048, "K9": 8 * 1024}  # samples of the plain loops


def _bit_equal(pairs):
    """Every (kernel, plain) pair of tensors equal."""
    assert all(torch.equal(g, w) for g, w in pairs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_recursion_kernels_against_plain_at_the_benchmark_streams(cuda, dtype):
    """K6-K9 (``dtype`` f64, or their f32 instances) against their plain
    versions, bit for bit, on the benchmark's streams (GEQ_B x GEQ_T GEQ
    streams, AEC_B x AEC_T echo and double-talk streams) cut to the plain
    loops' lengths: K6 at 2048 x 4096 and at B = 3072 x 512 (f64), K7 at
    2048 x 4096 (f64 only: it is f32), K8 both update pairings at 1024 x
    2048 and at T = 257 from a nonzero state (the 255 far-end samples
    before it as history, small coefficients, every fifth -0.0), K9 over 8
    blocks of 1024 streams with every third stream's odd gates shut; the
    outputs and the carried state."""
    f64 = dtype == torch.float64
    geq, aec = make_geq_streams(GEQ_B, GEQ_T, cuda), make_aec_streams(AEC_B, AEC_T, cuda)
    b, a = G.geq_coefficients()
    coef = torch.from_numpy(K7.pack_coefficients(b, a, np.float64 if f64 else np.float32)).to(cuda)
    x = geq[:, :PLAIN_T["K6"]].contiguous()
    _bit_equal(zip(K6.geq_cascade_quant(x, coef),
                   K6.geq_cascade_quant_plain(x, coef, K6.init_state(len(x), cuda))))
    if f64:
        x3 = geq.repeat(-(-3072 // len(geq)), 1)[:3072, :512].contiguous()
        _bit_equal(zip(K6.geq_cascade_quant(x3, coef),
                       K6.geq_cascade_quant_plain(x3, coef, K6.init_state(len(x3), cuda))))
        c32 = torch.from_numpy(K7.pack_coefficients(b, a)).to(cuda)
        xf = geq[:, :PLAIN_T["K7"]].float().contiguous()
        _bit_equal([(K7.geq_cascade(xf, c32), K7.geq_cascade_plain(xf, c32))])
    nlms, nlms_plain = (K8.nlms, K8.nlms_plain) if f64 else (K8.nlms_f32, K8.nlms_f32_plain)

    def state_pairs(got, want):  # f64: the values; f32: the coefficients' bits
        if f64:
            return list(zip(got, want))
        return [(got[0].view(torch.int32), want[0].view(torch.int32)), (got[1], want[1])]

    xa, ra = (v[:, :PLAIN_T["K8"]].contiguous() for v in aec)
    for compat in (True, False):
        got = nlms(xa, ra, compat=compat)
        want = nlms_plain(xa, ra, *K8.init_state(len(xa), cuda, dtype), compat=compat)
        _bit_equal(list(zip(got[:2], want[:2])) + state_pairs(got[2], want[2]))
    t0 = PLAIN_T["K8"]
    xa, ra = (v[:, t0:t0 + 257].contiguous() for v in aec)
    hist = aec[0][:, t0 - 255:t0].contiguous()
    g = torch.Generator(device=cuda).manual_seed(SEED + (2 if f64 else 3))
    c0 = 1e-3 * torch.randn(len(xa), 256, generator=g, dtype=dtype, device=cuda)
    c0[:, ::5] = -0.0
    bits = torch.int64 if f64 else torch.int32
    for compat in ((True, False) if f64 else (True,)):
        got = nlms(xa, ra, (c0, hist), compat=compat)
        want = nlms_plain(xa, ra, c0, hist, compat=compat)
        pairs = list(zip(got[:2], want[:2])) + [(got[2][0].view(bits), want[2][0].view(bits))]
        _bit_equal(pairs + ([(got[2][1], want[2][1])] if f64 else []))
    xa, ra = (v[:, :PLAIN_T["K9"]].contiguous() for v in aec)
    keep = torch.zeros(len(xa), 127, dtype=torch.int16, device=cuda)
    gates = K9.bnlms_gates(xa, ra, keep, keep)
    gates[::3, 1::2] = False  # random audio opens every gate: shut some for the other path
    bnlms, bnlms_plain = (K9.bnlms, K9.bnlms_plain) if f64 else (K9.bnlms_f32, K9.bnlms_f32_plain)
    got = bnlms(xa, ra, gates)
    want = bnlms_plain(xa, ra, gates, *K9.init_state(len(xa), cuda, dtype))
    _bit_equal(list(zip(got[:2], want[:2])) + state_pairs(got[2], want[2]))


AMDF_LO = 96  # K11's first lag on the pitch path


def test_feature_kernels_against_plain_on_the_feature_inputs(cuda):
    """K10 and K11 against their plain versions on the speech features'
    full-size inputs (torch_inputs.feature_inputs): K10 over 16,384 frames
    >= 90 dB over the finite features, the NaN and infinity masks equal;
    K11 in f64 bit-equal over PITCH_T frames at lo = 96 and lo = 0, and over
    PITCH_T frames of random full-scale extremes (sums past 2^24, where an
    f32 sum would round) at lo = 96."""
    _, rows, frames = feature_inputs(cuda)
    _finite_db(K10.mfcc_fused(rows[:-1], rows[1:]).cpu(),
               K10.mfcc_fused_plain(rows[:-1], rows[1:]).cpu(), KERNEL_VS_PLAIN_DB)
    rng = np.random.default_rng(SEED + 6)
    extremes = torch.from_numpy(np.where(rng.random((PITCH_T, 1024)) < 0.5, -32768, 32767)
                                .astype(np.int16)).to(cuda)
    for x, lo in ((frames, AMDF_LO), (frames, 0), (extremes, AMDF_LO)):
        got, want = K11.amdf(x, lo), K11.amdf_plain(x, lo)
        assert got.dtype == torch.float64 and torch.equal(got, want), lo
