"""K15 (``kernels/enhance_chunk64.py``, ``csrc/enhance_chunk64.cu``): one
chunk of the float64 compat stream in one launch, against its plain
version, the torch-op chain ``ops.enhance.enhance_chunk_ops``.  Imports
neither jax nor the JAX package, so it runs on a card's host too:

    python -m pytest --noconftest -q -s tests/test_torch_enhance_chunk64.py

Everywhere: the wrapper's checks, the route (a CPU chunk never reaches the
kernel), the constants (the twiddle table, the window's bits), and a numpy
model of the kernel's arithmetic (its radix-4 Stockham passes with the
table's twiddles, the VAD on integers, the per-bin noise step, the gain, the
OLA), row by row as the kernel walks them, against the plain chain.  On a
card (skipped without CUDA): the kernel against the plain chain on the card
over streams built with numpy, in both modes and chunks of 1, 2, 3 and 17
blocks, from a checkpoint restored mid-stream, its launches counted.
"""

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.io import stream as ST
from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels import enhance_chunk64 as K15
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.utils.cnum import c_short, hamming_ref

MODES = ("wiener", "specsub")
CHUNKS = (1, 2, 3, 17)
FLOAT_KEYS = ("avg", "latched", "prev_tail")
EXACT_KEYS = ("cnt", "t", "prev_block")
STATE_RTOL = 1e-12


def stream_blocks(seed=11):
    """96 blocks built with numpy: 4 silent (the warm-up rows and, before
    any latch, Wiener's NaN rows), 16 of N(0, 50) noise (a run that latches
    at its tenth block), 20 of a gated 313 Hz tone over N(0, 20), 6 silent
    after the latch, 14 more of noise (another latch), 36 of the tone (whose
    gate's pauses latch too)."""
    rng = np.random.default_rng(seed)
    n = 512
    t = np.arange(56 * n) / 16000.0
    tone = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    tone = tone + rng.normal(0, 20, len(t))
    parts = [np.zeros(4 * n), rng.normal(0, 50, 16 * n), tone[: 20 * n], np.zeros(6 * n),
             rng.normal(0, 50, 14 * n), tone[20 * n:]]
    x = np.clip(np.round(np.concatenate(parts)), -32768, 32767).astype(np.int16)
    return x.reshape(-1, n)


def _host(state):
    return {k: v.cpu().numpy() for k, v in state.items()}


def _compare(got, want, what):
    """(out, mask, state) against the plain version's: written samples
    within one step (the count of differing samples returned), the mask and
    the integer leaves exact, the float leaves within STATE_RTOL of each
    leaf's largest finite value, NaN where the plain version has NaN."""
    (go, gm, gs), (wo, wm, ws) = got, want
    go, wo = np.asarray(go, np.int64), np.asarray(wo, np.int64)
    np.testing.assert_array_equal(np.asarray(gm), np.asarray(wm), err_msg=f"{what}: mask")
    d = np.abs(go - wo)
    assert d.max(initial=0) <= 1, f"{what}: {int(d.max())} LSB"
    assert sorted(gs) == sorted(ws)
    for k in EXACT_KEYS:
        assert gs[k].dtype == ws[k].dtype and gs[k].shape == ws[k].shape, k
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=f"{what}: {k}")
    for k in FLOAT_KEYS:
        g, w = gs[k], ws[k]
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what}: {k} NaN")
        fin = ~np.isnan(w)
        scale = max(float(np.abs(w[fin]).max(initial=0.0)), 1.0)
        assert np.abs(g[fin] - w[fin]).max(initial=0.0) <= STATE_RTOL * scale, f"{what}: {k}"
    return int((d > 0).sum())


# ---------------------------------------------------------------- the kernel's model


def _stockham(x, tw, inverse):
    """The kernel's 1024-point transform, written as it computes it: five
    radix-4 Stockham passes, thread j's inputs src[j + 256 r], twiddled by
    W^(r k 256 / NS) (conjugated for the inverse), outputs to dst[(j / NS)
    4 NS + k + r NS]; each product and sum rounded on its own."""
    re, im = x.real.copy(), x.imag.copy()
    wr, wi = tw[:, 0], (tw[:, 1] if not inverse else -tw[:, 1])
    j = np.arange(256)
    for ns in (1, 4, 16, 64, 256):
        k = j % ns
        vr = [re[j + 256 * r] for r in range(4)]
        vi = [im[j + 256 * r] for r in range(4)]
        if ns > 1:
            for r in (1, 2, 3):
                idx = r * k * (256 // ns)
                a, b = vr[r], vi[r]
                vr[r], vi[r] = a * wr[idx] - b * wi[idx], a * wi[idx] + b * wr[idx]
        ar, ai, br, bi = vr[0] + vr[2], vi[0] + vi[2], vr[0] - vr[2], vi[0] - vi[2]
        cr, ci, dr, di = vr[1] + vr[3], vi[1] + vi[3], vr[1] - vr[3], vi[1] - vi[3]
        mid, pid = (br + di, bi - dr), (br - di, bi + dr)  # b - i d, b + i d
        y = [(ar + cr, ai + ci), pid if inverse else mid, (ar - cr, ai - ci),
             mid if inverse else pid]
        base = (j // ns) * 4 * ns + k
        re, im = np.empty(1024), np.empty(1024)
        for r in range(4):
            re[base + r * ns], im[base + r * ns] = y[r]
    return re + 1j * im


def _c_short(v):
    return c_short(torch.from_numpy(np.asarray(v, np.float64))).numpy().astype(np.int64)


def model_chunk(state, blocks, mode):
    """K15's arithmetic in numpy, row by row as the kernel walks the chunk."""
    st = _host(state)
    w = hamming_ref(1024, torch.float64).numpy()
    tw = K15.twiddle_table()
    cnt, avg, lat = int(st["cnt"]), st["avg"].copy(), st["latched"].copy()
    tail, t0, prev = st["prev_tail"].copy(), int(st["t"]), st["prev_block"].astype(np.int64)
    out = np.zeros(blocks.shape, np.int16)
    mask = np.zeros(len(blocks), bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        for row, cur in enumerate(blocks.astype(np.int64)):
            p = np.concatenate([prev, cur]).astype(np.float64) * w
            X = _stockham(p + 0j, tw, inverse=False)
            s = _c_short(p[512:])
            e, z = int((s * s).sum()), int((s * np.append(cur[1:], 0) < 0).sum())
            speech = e > 700 * 1024 or z < 200
            cnt = 0 if speech else cnt + 1
            mag = np.hypot(X.real, X.imag)
            if not speech and cnt >= 2:
                avg = avg + mag
                if cnt >= 3:
                    avg = avg / 2.0
                if cnt == 10:
                    lat = avg.copy()
            if mode == "wiener":
                P = X.real * X.real + X.imag * X.imag
                v = lat * lat / P
                v = np.where(v >= 1.0, 1.0, v)
                amp = np.abs(np.sqrt(P)) * (1.0 - v)
            else:
                amp = mag - lat
            ph = np.arctan2(X.imag, X.real)
            y = _stockham(amp * np.cos(ph) + 1j * (amp * np.sin(ph)), tw, inverse=True).real
            y = y * (1.0 / 1024)
            mask[row] = t0 + row >= 2
            if mask[row]:
                out[row] = _c_short(y[:512] + tail)
            tail, prev = y[512:], cur
    new = {"cnt": np.array(cnt, np.int32), "avg": avg, "latched": lat,
           "prev_block": prev.astype(np.int16), "prev_tail": tail,
           "t": np.array(t0 + len(blocks), np.int32)}
    return out, mask, new


# ---------------------------------------------------------------- CPU


def test_twiddle_table_is_w_k_to_one_ulp():
    """The table the kernel reads: W^k = exp(-2 pi i k / 1024) as (re, im),
    within one ulp of 1.0 of the long-double values (the octant's symmetries
    make W^256 = -i and W^512 = -1 exact); numpy's exp of the rounded angle
    lies within 3 ulps of them (its angle 2 pi k / 1024 is rounded first)."""
    t = K15.twiddle_table()
    assert t.shape == (1024, 2) and t.dtype == np.float64 and t.flags.c_contiguous
    pi = np.longdouble("3.14159265358979323846264338327950288")
    ang = 2 * pi * np.arange(1024).astype(np.longdouble) / 1024
    exact = np.stack([np.cos(ang), -np.sin(ang)], 1)
    ulp = 2.0 ** -52
    assert np.abs(t.astype(np.longdouble) - exact).max() <= ulp
    w = np.exp(-2j * np.pi * np.arange(1024) / 1024)
    assert np.abs(np.stack([w.real, w.imag], 1) - t).max() <= 4 * ulp
    assert tuple(t[256]) == (0.0, -1.0) and tuple(t[512]) == (-1.0, 0.0)
    assert tuple(t[0]) == (1.0, 0.0) and tuple(t[768]) == (0.0, 1.0)


def test_window_is_hamming_ref_s_bits():
    window, tw = K15.constants(torch.device("cpu"))
    want = hamming_ref(1024, torch.float64)
    assert window.dtype == torch.float64 and window.is_contiguous()
    assert window.numpy().tobytes() == want.numpy().tobytes()
    assert tw.numpy().tobytes() == K15.twiddle_table().tobytes()


def _good():
    state = E.stream_init_state(torch.float64, device="cpu")
    return state, torch.zeros(2, 512, dtype=torch.int16)


def _bad_blocks_dtype(s, b):
    return s, b.to(torch.int32)


def _bad_blocks_shape(s, b):
    return s, torch.zeros(2, 256, dtype=torch.int16)


def _empty_chunk(s, b):
    return s, b[:0]


def _bad_state_dtype(s, b):
    return dict(s, avg=s["avg"].float()), b


def _bad_state_shape(s, b):
    return dict(s, prev_tail=torch.zeros(1024, dtype=torch.float64)), b


def _device_mismatch(s, b):
    return dict(s, latched=torch.zeros(1024, dtype=torch.float64, device="meta")), b


def _not_contiguous(s, b):
    return s, torch.zeros(512, 2, dtype=torch.int16).t()


@pytest.mark.parametrize("bad", [_bad_blocks_dtype, _bad_blocks_shape, _empty_chunk,
                                 _bad_state_dtype, _bad_state_shape, _device_mismatch,
                                 _not_contiguous])
def test_wrapper_checks_raise(bad):
    before = K15.enhance_chunk64.launches
    with pytest.raises(ValueError):
        K15.enhance_chunk64(*bad(*_good()))
    assert K15.enhance_chunk64.launches == before


def test_wrapper_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        K15.enhance_chunk64(*_good(), mode="median")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_chunks_never_reach_the_kernel(dtype, monkeypatch):
    """enhance_chunk on CPU tensors runs the plain chain: no launch (the
    launch path would raise), the count unchanged, the output and state
    byte-equal to the plain chain's and the wrapper's CPU route."""
    def no_launch(*a):
        raise AssertionError("a CPU chunk reached the kernel")

    monkeypatch.setattr(_build, "launch", no_launch)
    before = K15.enhance_chunk64.launches
    blocks = torch.from_numpy(stream_blocks()[:24].copy())
    a = E.stream_init_state(dtype, device="cpu")
    b = E.stream_init_state(dtype, device="cpu")
    c = E.stream_init_state(dtype, device="cpu")
    for s in range(0, 24, 3):
        oa, ma, a = E.enhance_chunk(a, blocks[s: s + 3], "wiener", dtype)
        ob, mb, b = E.enhance_chunk_ops(b, blocks[s: s + 3], "wiener", dtype)
        assert torch.equal(oa, ob) and torch.equal(ma, mb)
        for k in a:
            assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k
        if dtype == torch.float64:
            oc, _, c = K15.enhance_chunk64(c, blocks[s: s + 3], "wiener")
            assert torch.equal(oa, oc)
    assert K15.enhance_chunk64.launches == before


def test_stockham_model_is_the_dft():
    """The kernel's passes with the table's twiddles: the forward transform
    and the unscaled inverse within 1e-14 of numpy's FFT, relative to the
    largest bin."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1000, 1024) + 1j * rng.normal(0, 1000, 1024)
    tw = K15.twiddle_table()
    fwd = _stockham(x, tw, inverse=False)
    assert np.abs(fwd - np.fft.fft(x)).max() <= 1e-14 * np.abs(np.fft.fft(x)).max()
    inv = _stockham(x, tw, inverse=True)
    assert np.abs(inv - 1024 * np.fft.ifft(x)).max() <= 1e-14 * np.abs(inv).max()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", MODES)
def test_model_equals_the_plain_chain(mode, chunk):
    """The model of K15's arithmetic against the plain chain on the CPU,
    chunk by chunk, each from its own carried state, over the whole stream:
    the warm-up rows, Wiener's NaN rows, two latches, runs across chunks."""
    blocks = stream_blocks()
    ms = E.stream_init_state(torch.float64, device="cpu")
    ps = E.stream_init_state(torch.float64, device="cpu")
    flipped, latched = 0, False
    for s in range(0, len(blocks), chunk):
        b = blocks[s: s + chunk]
        mo, mm, mst = model_chunk(ms, b, mode)
        po, pm, ps = E.enhance_chunk_ops(ps, torch.from_numpy(b.copy()), mode)
        flipped += _compare((mo, mm, mst), (po.numpy(), pm.numpy(), _host(ps)), f"rows {s}+")
        ms = {k: torch.from_numpy(np.array(v)) for k, v in mst.items()}
        latched |= bool(np.abs(mst["latched"]).max() > 0)
    assert latched and flipped <= 2


def test_stream_has_nan_rows_and_latches():
    """The stream reaches what the card tests hold the kernel to."""
    blocks = torch.from_numpy(stream_blocks())
    state = E.stream_init_state(torch.float64, device="cpu")
    out, mask, state = E.enhance_chunk_ops(state, blocks, "wiener")
    speech = E.vad_flags(blocks, torch.float64)
    cnt, run = E._run_counts(speech)
    assert int((run & (cnt == E.NOISE_FRAMES)).sum()) >= 2
    _, _, first = E.enhance_chunk_ops(E.stream_init_state(torch.float64, device="cpu"),
                                      blocks[:3], "wiener")
    assert torch.isnan(first["prev_tail"]).all()  # the silent rows before any latch
    assert mask[:2].tolist() == [False, False] and bool(mask[2:].all())


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_state(state, dev):
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in state.items()}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", MODES)
def test_k15_matches_the_plain_chain_on_the_card(cuda, mode, chunk):
    """K15 and the plain chain on the card, each carrying its own state over
    the whole stream in chunks of ``chunk``: every chunk's written samples
    within one step (the differing count printed, 0 expected), the mask,
    cnt, t and prev_block exact, avg, latched and prev_tail within 1e-12 of
    their largest value, NaN where the plain chain has NaN; one launch a
    chunk."""
    blocks = stream_blocks()
    ks = E.stream_init_state(torch.float64, device=cuda)
    ps = E.stream_init_state(torch.float64, device=cuda)
    flipped, chunks = 0, 0
    before = K15.enhance_chunk64.launches
    for s in range(0, len(blocks), chunk):
        b = torch.from_numpy(blocks[s: s + chunk].copy()).to(cuda)
        ko, km, ks = E.enhance_chunk(ks, b, mode)
        po, pm, ps = E.enhance_chunk_ops(ps, b, mode)
        flipped += _compare((ko.cpu().numpy(), km.cpu().numpy(), _host(ks)),
                            (po.cpu().numpy(), pm.cpu().numpy(), _host(ps)), f"rows {s}+")
        chunks += 1
    torch.cuda.synchronize()
    assert K15.enhance_chunk64.launches == before + chunks
    print(f"\n[K15 {mode} chunks of {chunk}] {flipped} written samples differ from the plain "
          f"chain over {len(blocks)} blocks")
    assert np.isnan(_host(ks)["prev_tail"]).sum() == 0  # the NaN rows are behind it


@pytest.mark.parametrize("mode", MODES)
def test_k15_from_the_first_rows_carries_nan(cuda, mode):
    """The silent rows at the start, before any latch: Wiener's 0/0 gain
    makes the rows and the carried tail NaN, written as zeros; spectral
    subtraction keeps them finite.  As the plain chain, chunk by chunk."""
    blocks = stream_blocks()[:6]
    ks = E.stream_init_state(torch.float64, device=cuda)
    ps = E.stream_init_state(torch.float64, device=cuda)
    for s in range(0, 6, 2):
        b = torch.from_numpy(blocks[s: s + 2].copy()).to(cuda)
        got, want = E.enhance_chunk(ks, b, mode), E.enhance_chunk_ops(ps, b, mode)
        _compare(*((o.cpu().numpy(), m.cpu().numpy(), _host(st)) for o, m, st in (got, want)),
                 f"rows {s}+")
        ks, ps = got[2], want[2]
        if s == 2:
            assert bool(torch.isnan(ks["prev_tail"]).all()) == (mode == "wiener")


@pytest.mark.parametrize("mode", MODES)
def test_k15_resumes_from_a_checkpoint_mid_stream(cuda, mode, tmp_path):
    """A checkpoint in the JAX layout (``save_pytree``), written by a CPU
    session in the middle of the first noise run, restored into a card
    session: its continuation within one step of the CPU session's (the
    count printed), its state as the plain chain's."""
    blocks = stream_blocks()
    cpu = ST.EnhanceSession(mode, device="cpu")
    cpu.process(blocks[:11])
    cpu.checkpoint(str(tmp_path / "ck.npz"))
    card = ST.EnhanceSession(mode, device=cuda)
    card.restore(str(tmp_path / "ck.npz"))
    assert card.sample_offset == 11 * 512 and int(card.state["cnt"]) == 7
    before = K15.enhance_chunk64.launches
    got = np.concatenate([card.process(blocks[s: s + 3]) for s in range(11, len(blocks), 3)])
    want = np.concatenate([cpu.process(blocks[s: s + 3]) for s in range(11, len(blocks), 3)])
    assert K15.enhance_chunk64.launches == before + len(range(11, len(blocks), 3))
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want)
    print(f"\n[K15 {mode} restored at block 11] {int((d > 0).sum())} of {len(got)} samples "
          f"differ from the CPU session")
    assert d.max() <= 1
    cs, ws = _host(card.state), _host(cpu.state)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(cs[k], ws[k])
    for k in FLOAT_KEYS:
        scale = max(np.abs(ws[k]).max(), 1.0)
        assert np.abs(cs[k] - ws[k]).max() <= STATE_RTOL * scale, k


def test_k15_session_launches_under_the_profiler(cuda):
    """20 chunks of a card session under torch.profiler: K15 once a chunk
    (its counter and the trace agree), at most 10 device activities a chunk
    (the copy in, K15, ``out[mask]``'s work, the copy out)."""
    from torch.profiler import ProfilerActivity, profile

    blocks = stream_blocks()
    sess = ST.EnhanceSession("wiener", device=cuda)
    for s in range(0, 8, 2):  # build and warm up
        sess.process(blocks[s: s + 2])
    torch.cuda.synchronize()
    before = K15.enhance_chunk64.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(8, 48, 2):
            sess.process(blocks[s: s + 2])
        torch.cuda.synchronize()
    assert K15.enhance_chunk64.launches == before + 20
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k15 = [e for e in acts if "chunk64" in e.name]
    print(f"\n[K15 session] {len(acts) / 20:.2f} device activities a chunk; "
          f"{sorted({e.name[:40] for e in acts})}")
    assert len(k15) == 20
    assert len(acts) / 20 <= 10
