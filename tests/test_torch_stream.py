"""CPU parity of the port's streaming with checkpoint/resume
(``jeicyboodsp_tpu_torch.io.stream``, ``ops.enhance.enhance_chunk``,
``models.serialization``) with the JAX package and the f64 oracles.

Sessions run with ``device="cpu"``, so the kernels (K6, K8, K9, K14) run
their plain versions; tests/test_torch_cuda.py and chip_smoke.py hold the
sessions on the card.  The JAX sessions run in this process with x64 on
(tests/conftest.py), the GEQ and AEC ones through the JAX package's native
kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.io import stream as JS
from jeicyboodsp_tpu.models import serialization as JSER
from jeicyboodsp_tpu.oracle import enhance as oenh
from jeicyboodsp_tpu.oracle import geq as ogeq
from jeicyboodsp_tpu.oracle import nlms as onl
from jeicyboodsp_tpu.ops import enhance as JE
from jeicyboodsp_tpu_torch.io import stream as TS
from jeicyboodsp_tpu_torch.models import serialization as TSER
from jeicyboodsp_tpu_torch.ops import enhance as TE

MODES = ("wiener", "specsub")


def _latch_signal():
    """64 blocks: 16 of N(0, 50) noise, which the VAD calls noise block after
    block so the run reaches the 10-frame latch, then the gated 313 Hz tone
    over N(0, 20) (the latch probe of tests/test_torch_enhance_compat.py)."""
    rng = np.random.default_rng(11)
    t = np.arange(64 * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    noise = rng.normal(0, 20, 64 * 512)
    sp[: 16 * 512] = 0.0
    noise[: 16 * 512] *= 2.5
    return np.clip(sp + noise, -32768, 32767).astype(np.int16).reshape(-1, 512)


@pytest.fixture(scope="module")
def blocks():
    b = _latch_signal()
    speech = TE.vad_flags(torch.from_numpy(b), torch.float64)
    cnt, run = TE._run_counts(speech)
    assert int((run & (cnt == TE.NOISE_FRAMES)).sum()) >= 1  # the latch is reached
    return b


def _chunked(sess, blocks, sizes):
    """Feed ``blocks`` to ``sess`` in chunks cycling through ``sizes``."""
    outs, s, i = [], 0, 0
    while s < len(blocks):
        outs.append(sess.process(blocks[s: s + sizes[i % len(sizes)]]))
        s += sizes[i % len(sizes)]
        i += 1
    return np.concatenate(outs)


@pytest.mark.parametrize("chunk", [1, 3, 5, 7])
@pytest.mark.parametrize("mode", MODES)
def test_ragged_chunking_byte_identical_to_oracle(blocks, mode, chunk):
    want = oenh.run(blocks.reshape(-1), mode)
    got = _chunked(TS.EnhanceSession(mode, device="cpu"), blocks, [chunk])
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_mixed_chunks_f32_equal_one_shot(blocks):
    """In f32 (``stream --fast``: the VAD through K14's wrapper) chunked
    output equals the one-shot f32 ``xla`` chain bit for bit."""
    want = TE.run_stream(blocks.reshape(-1), "wiener", dtype=torch.float32, device="cpu")
    got = _chunked(TS.EnhanceSession("wiener", dtype=torch.float32, device="cpu"), blocks,
                   [2, 7, 1, 4])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checkpoint_resume(blocks, tmp_path, dtype):
    ck = str(tmp_path / "state.npz")
    sess = TS.EnhanceSession("wiener", dtype=dtype, device="cpu")
    sess.process(blocks[:13])
    sess.checkpoint(ck)
    a2 = sess.process(blocks[13:])
    sess2 = TS.EnhanceSession("wiener", dtype=dtype, device="cpu")
    sess2.restore(ck)
    assert sess2.sample_offset == 13 * 512
    assert {k: v.dtype for k, v in sess2.state.items()} == {k: v.dtype for k, v in sess.state.items()}
    np.testing.assert_array_equal(sess2.process(blocks[13:]), a2)


@pytest.mark.parametrize("split", [1, 2, 9, 10, 11, 14, 17, 30])
def test_noise_scan_from_mid_run_equals_one_shot(blocks, split):
    """The scan carried across a cut at ``split`` (inside the first noise
    run, at and after its latch, and in speech) equals the one-shot scan
    row for row."""
    speech = TE.vad_flags(torch.from_numpy(blocks), torch.float64)
    mags = torch.from_numpy(np.abs(np.fft.fft(
        np.random.default_rng(3).normal(0, 1e3, (len(blocks), 1024)))))
    want = TE._noise_scan(speech, mags)
    carry = (torch.zeros((), dtype=torch.int32), torch.zeros(1024, dtype=torch.float64),
             torch.zeros(1024, dtype=torch.float64))
    ns1, carry = TE._noise_scan_carry(speech[:split], mags[:split], carry)
    ns2, _ = TE._noise_scan_carry(speech[split:], mags[split:], carry)
    assert torch.equal(torch.cat([ns1, ns2]), want)
    assert want.abs().max() > 0


@pytest.mark.parametrize("mode", MODES)
def test_enhance_chunk_equals_jax(blocks, mode):
    """Chunk by chunk from the same state: output, mask and the integer
    leaves equal JAX's; the float leaves (sums of FFT magnitudes, the
    synthesis tail) within 1e-12 of their largest value, as torch.fft and
    XLA's FFT round the last bit apart."""
    js = JE.stream_init_state(jnp.float64)
    ts = TE.stream_init_state(torch.float64, device="cpu")
    for s in range(0, len(blocks), 3):
        out, mask, js = JE.enhance_chunk(js, jnp.asarray(blocks[s: s + 3]), mode=mode)
        tout, tmask, ts = TE.enhance_chunk(ts, torch.from_numpy(blocks[s: s + 3].copy()), mode)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(out))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
        port = TE.state_to_jax(ts)
        assert sorted(port) == sorted(js)
        for k, v in js.items():
            v = np.asarray(v)
            assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
            if v.dtype.kind == "f":
                np.testing.assert_allclose(port[k], v, rtol=0, atol=1e-12 * max(np.abs(v).max(), 1))
            else:
                np.testing.assert_array_equal(port[k], v)
    assert np.abs(np.asarray(js["latched"])).max() > 0


def test_state_conversions_round_trip():
    js = {k: np.asarray(v) for k, v in JE.stream_init_state(jnp.float32).items()}
    ts = TE.state_to_port(js, device="cpu")
    back = TE.state_to_jax(ts)
    assert {k: (v.dtype, v.shape) for k, v in back.items()} == {
        k: (v.dtype, v.shape) for k, v in js.items()}
    assert {k: v.dtype for k, v in TE.stream_init_state(torch.float32, "cpu").items()} == {
        k: v.dtype for k, v in ts.items()}


def test_save_pytree_layout_is_jax(tmp_path):
    """The same leaves in the same order, and the same treedef bytes."""
    state = TE.stream_init_state(torch.float64, device="cpu")
    state["avg"] += torch.arange(1024, dtype=torch.float64)
    TSER.save_pytree(str(tmp_path / "port.npz"), state)
    JSER.save_pytree(str(tmp_path / "jax.npz"), TE.state_to_jax(state))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_interchange_with_jax(blocks, tmp_path, mode):
    """A checkpoint JAX's session writes restores into the port's session,
    and the reverse; each continuation equals the uninterrupted output."""
    whole = oenh.run(blocks.reshape(-1), mode)
    head = len(JS.EnhanceSession(mode).process(blocks[:20]))
    js = JS.EnhanceSession(mode)
    js.process(blocks[:20])
    js.checkpoint(str(tmp_path / "jax.npz"))
    ts = TS.EnhanceSession(mode, device="cpu")
    ts.restore(str(tmp_path / "jax.npz"))
    assert ts.sample_offset == js.sample_offset == 20 * 512
    np.testing.assert_array_equal(ts.process(blocks[20:]), whole[head:])

    ts = TS.EnhanceSession(mode, device="cpu")
    ts.process(blocks[:20])
    ts.checkpoint(str(tmp_path / "port.npz"))
    js = JS.EnhanceSession(mode)
    js.restore(str(tmp_path / "port.npz"))
    assert js.sample_offset == 20 * 512
    np.testing.assert_array_equal(js.process(blocks[20:]), whole[head:])


def _geq_signal():
    rng = np.random.default_rng(5)
    t = np.arange(3 * 1024) / 48000.0
    tone = 8000 * np.sin(2 * np.pi * 440 * t) + 4000 * np.sin(2 * np.pi * 3000 * t)
    tone = np.clip(tone + rng.normal(0, 500, len(t)), -32768, 32767).astype(np.int16)
    return np.concatenate([tone, rng.integers(-32768, 32768, 1024).astype(np.int16)])


def test_geq_session_bit_equal_to_jax_and_oracle(tmp_path):
    """K6 (f64) at B = 1 against the JAX session's native kernel, across a
    checkpoint, with a full-scale stretch that wraps; the npz files
    interchange both ways."""
    x = _geq_signal()
    cut = 1500
    js, ts = JS.GEQSession(), TS.GEQSession(device="cpu")
    ya = ts.process(x[:cut])
    np.testing.assert_array_equal(ya, js.process(x[:cut]))
    ts.checkpoint(str(tmp_path / "port.npz"))
    js.checkpoint(str(tmp_path / "jax.npz"))
    for k in ("keep_in", "keep_out"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    yb = ts.process(x[cut:])
    np.testing.assert_array_equal(np.concatenate([ya, yb]), ogeq.run(x))
    np.testing.assert_array_equal(yb, js.process(x[cut:]))
    for src, dst in (("jax.npz", TS.GEQSession(device="cpu")), ("port.npz", JS.GEQSession())):
        dst.restore(str(tmp_path / src))
        np.testing.assert_array_equal(dst.process(x[cut:]), yb)


@pytest.mark.parametrize("variant", ["nlms", "bnlms"])
def test_aec_session_bit_equal_to_jax(tmp_path, variant):
    """K8 / K9 (with its f64 FFT gate) at B = 1 against the JAX session's
    native kernels, across a checkpoint; the npz files interchange both
    ways, and the stream equals the oracle's."""
    rng = np.random.default_rng(6)
    n = 1024 * 4
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 16)
    h[0] = 0.5
    ref = np.clip(np.convolve(x.astype(np.float64), h)[:n], -32768, 32767).astype(np.int16)
    js, ts = JS.AECSession(variant), TS.AECSession(variant, device="cpu")
    a = ts.process(x[:2048], ref[:2048])
    for g, w in zip(a, js.process(x[:2048], ref[:2048])):
        np.testing.assert_array_equal(g, w)
    ts.checkpoint(str(tmp_path / "port.npz"))
    js.checkpoint(str(tmp_path / "jax.npz"))
    pa, ja = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(pa.files) == sorted(ja.files)
    for k in ja.files:
        assert pa[k].dtype == ja[k].dtype and pa[k].tobytes() == ja[k].tobytes(), k
    b = ts.process(x[2048:], ref[2048:])
    for g, w in zip(b, js.process(x[2048:], ref[2048:])):
        np.testing.assert_array_equal(g, w)
    oe, oerr = (onl.run_nlms if variant == "nlms" else onl.run_bnlms)(x, ref)
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]])[1024:], oe)
    np.testing.assert_array_equal(np.concatenate([a[1], b[1]])[1024:], oerr)
    for src, dst in (("jax.npz", TS.AECSession(variant, device="cpu")),
                     ("port.npz", JS.AECSession(variant))):
        dst.restore(str(tmp_path / src))
        for g, w in zip(dst.process(x[2048:], ref[2048:]), b):
            np.testing.assert_array_equal(g, w)


def test_aec_session_takes_whole_blocks():
    with pytest.raises(ValueError):
        TS.AECSession("nlms", device="cpu").process(np.zeros(1000, np.int16),
                                                    np.zeros(1000, np.int16))
