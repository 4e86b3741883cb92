"""``io.stream.AECSession``'s state and its card route.  Imports neither jax
nor the JAX package, so it runs on a card's host too:

    python -m pytest --noconftest -q -s tests/test_torch_aec_session.py

An ``nlms`` session on a CUDA card keeps its state there in K8's layout
(``io.stream._K8State``): a chunk is one copy in from pinned memory, K8 and
one copy out, and ``state`` converts on demand.  Everywhere: ``state`` keeps
the JAX op's layout on the host route, hands back copies and takes them, and
an assignment equals a restore of the same dict's npz; the card route's
bookkeeping (its staging rows, two state slots in turn, the cached read, its
counters and spans) runs on the CPU with pinned buffers as plain ones and K8
as its plain version over the pointers the route hands it.  On a card
(skipped without CUDA): the route against the CPU session bit for bit over
24 chunks of 1,024 and 3,072 samples, from an assigned state and a restored
npz; one K8 launch and three device activities a chunk; no memory growth
over 1,000 chunks; its spans.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_inputs import make_aec_streams

from jeicyboodsp_tpu_torch.io import stream as ST
from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels import nlms as K8
from jeicyboodsp_tpu_torch.ops import nlms as N
from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY

VARIANTS = ("nlms", "bnlms")
LENGTHS = [1024, 3072, 1024, 1024, 3072, 1024] * 4  # 24 chunks, 45,056 samples
CARD_TREE = [  # (name, kind, parent's name) of a chunk on the card route
    ("session.process", "stage", None),
    ("session.chunk_in", "stage", "session.process"),
    ("nlms.kernel", "stage", "session.process"),
    ("session.drain", "wait", "session.process"),  # recorded runs only
    ("session.out", "copy", "session.process"),
]


def _streams(n=sum(LENGTHS)):
    """Row 0 of the card tests' echo streams (an echo with no near-end
    talker) and row 3 (double talk), as numpy int16."""
    x, r = make_aec_streams(4, n, "cpu")
    return x.numpy(), r.numpy()


def _chunks(x, r, lengths=LENGTHS):
    a = 0
    for n in lengths:
        yield x[a:a + n], r[a:a + n]
        a += n


def _counts():
    return {k: REGISTRY.counters[k] for k in ("session.staged", "session.state_reads")}


def _equal_states(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _shape(spans):
    return [(s.name, s.kind, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


def _npz(path, state, variant):
    keep = "hist" if variant == "nlms" else "keep_in"
    extra = {"keep_ref": state["keep_ref"].numpy().astype(np.int16)} if variant == "bnlms" else {}
    np.savez(path, coeff=state["coeff"].numpy(), keep=state[keep].numpy().astype(np.int16), **extra)


# ---------------------------------------------------------------- the host route


@pytest.mark.parametrize("variant", VARIANTS)
def test_host_route_state_keeps_the_jax_layout(variant):
    """Fresh and after a chunk: the JAX op's keys, int32 histories, float64
    coefficients, on the CPU."""
    want = N.nlms_init_state() if variant == "nlms" else N.bnlms_init_state()
    s = ST.AECSession(variant, device="cpu")
    x, r = _streams(2048)
    for _ in range(2):
        st = s.state
        assert st.keys() == want.keys()
        for k, v in st.items():
            assert (v.dtype, v.shape, v.device.type) == (want[k].dtype, want[k].shape, "cpu"), k
        s.process(x[0, :1024], r[0, :1024])
    assert s.state["coeff"].abs().sum() > 0  # the chunk adapted


@pytest.mark.parametrize("variant", VARIANTS)
def test_host_route_state_is_the_caller_s_own(variant):
    """A dict the getter returned, or one the caller assigned, changed
    afterwards leaves the session as it was."""
    x, r = _streams(4096)
    s, twin = ST.AECSession(variant, device="cpu"), ST.AECSession(variant, device="cpu")
    for v in (s, twin):
        v.process(x[0, :2048], r[0, :2048])
    got = s.state
    for v in got.values():
        v.fill_(7)
    given = twin.state
    s.state = given
    for v in given.values():
        v.fill_(3)
    _equal_states(s.state, twin.state)
    for a, b in zip(s.process(x[0, 2048:], r[0, 2048:]), twin.process(x[0, 2048:], r[0, 2048:])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_host_route_assignment_equals_a_restore_of_its_npz(tmp_path, variant):
    """A state from another session assigned, then a chunk: equal to a
    session restored from an npz of that dict, outputs and state."""
    x, r = _streams(4096)
    src = ST.AECSession(variant, device="cpu")
    src.process(x[3, :2048], r[3, :2048])
    st = src.state
    _npz(tmp_path / "st.npz", st, variant)
    a, b = ST.AECSession(variant, device="cpu"), ST.AECSession(variant, device="cpu")
    a.state = st
    b.restore(str(tmp_path / "st.npz"))
    for u, v in zip(a.process(x[3, 2048:], r[3, 2048:]), b.process(x[3, 2048:], r[3, 2048:])):
        np.testing.assert_array_equal(u, v)
    _equal_states(a.state, b.state)


def test_host_route_reads_no_card():
    """The host route counts no state read and stages nothing; its getter
    records no span."""
    s, (x, r), before = ST.AECSession("nlms", device="cpu"), _streams(1024), _counts()
    with REGISTRY.recording():
        s.process(x[0], r[0])
        s.state
    assert "session.state" not in [sp.name for sp in REGISTRY.take_spans()]
    assert _counts() == before


@pytest.mark.parametrize("variant", VARIANTS)
def test_host_route_none_releases_the_state(variant):
    """``state = None`` (what the benchmark does before its check) leaves
    the session without a state: the getter gives None."""
    s = ST.AECSession(variant, device="cpu")
    s.state = None
    assert s.state is None


# ---------------------------------------------------------------- the card route on the CPU


def _at(ptr, ctype, n):
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(ptr)))


@pytest.fixture
def card_on_cpu(monkeypatch):
    """The card route with its buffers on the CPU: a device that reads as a
    card, torch.empty without pinning or device, no stream to drain, and
    ``jb_nlms`` as K8's plain version over the pointers handed to it (each
    launch logged with its state slots).  Returns the launch log."""
    empty, log = torch.empty, []

    def fake_empty(*a, pin_memory=False, device=None, **k):
        return empty(*a, **k)

    def fake_launch(entry, dev, x, r, ci, hi, est, err, co, ho, B, T, compat):
        assert (entry, B, compat) == ("jb_nlms", 1, 1)
        i16, f64 = ctypes.c_int16, ctypes.c_double
        ins = [_at(p, t, n)[None].clone() for p, t, n in
               ((x, i16, T), (r, i16, T), (ci, f64, K8.TAPS), (hi, i16, K8.KEEP))]
        e, er, (c, h) = K8.nlms_plain(*ins)
        for p, t, n, v in ((est, i16, T, e), (err, i16, T, er), (co, f64, K8.TAPS, c),
                           (ho, i16, K8.KEEP, h)):
            _at(p, t, n)[:] = v[0]
        log.append((ci, co))

    monkeypatch.setattr(torch, "empty", fake_empty)
    monkeypatch.setattr(_build, "launch", fake_launch)
    card = SimpleNamespace(type="cuda", index=None)
    monkeypatch.setattr(ST, "entry_device",
                        lambda d: card if d == "cuda" else torch.device(d))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(synchronize=lambda: None))
    return log


def test_card_route_on_the_cpu_equals_the_host_route(card_on_cpu):
    """24 chunks of 1,024 and 3,072 samples: est, err and the state equal
    the host route's after every chunk; one launch, one staged chunk and,
    with two reads of the state a chunk, one state read a chunk; the two
    slots in turn; the outputs the caller's own."""
    card, cpu = ST.AECSession("nlms", device="cuda"), ST.AECSession("nlms", device="cpu")
    x, r = _streams()
    before, launches = _counts(), K8.nlms.launches
    for k, (xc, rc) in enumerate(_chunks(x[3], r[3])):
        est, err = card.process(xc, rc)
        want = cpu.process(xc, rc)
        np.testing.assert_array_equal(est, want[0])
        np.testing.assert_array_equal(err, want[1])
        assert est.base is err.base and est.base.base is None  # an array of the caller's own
        _equal_states(card.state, cpu.state)
        _equal_states(card.state, cpu.state)
        ci, co = card_on_cpu[-1]
        assert ci != co and (k == 0 or ci == card_on_cpu[-2][1])  # reads the slot it last wrote
    assert K8.nlms.launches == launches + len(LENGTHS)
    assert _counts() == {"session.staged": before["session.staged"] + len(LENGTHS),
                         "session.state_reads": before["session.state_reads"] + len(LENGTHS)}


def test_card_route_on_the_cpu_assignment_and_restore(card_on_cpu, tmp_path):
    """A state assigned mid-stream, and a restore of a host-route npz,
    continue as the host route does; an assignment reads nothing back; a
    float32 state is refused; the checkpoint equals the host route's."""
    x, r = _streams()
    cpu = ST.AECSession("nlms", device="cpu")
    cpu.process(x[0, :4096], r[0, :4096])
    card = ST.AECSession("nlms", device="cuda")
    card.process(x[3, :2048], r[3, :2048])  # another stream first
    reads = REGISTRY.counters["session.state_reads"]
    card.state = cpu.state
    _equal_states(card.state, cpu.state)
    assert REGISTRY.counters["session.state_reads"] == reads
    cpu.checkpoint(str(tmp_path / "cpu.npz"))
    again = ST.AECSession("nlms", device="cuda")
    again.restore(str(tmp_path / "cpu.npz"))
    for xc, rc in _chunks(x[0, 4096:], r[0, 4096:], [1024, 3072, 1024]):
        want = cpu.process(xc, rc)
        for got in (card.process(xc, rc), again.process(xc, rc)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    card.checkpoint(str(tmp_path / "card.npz"))
    cpu.checkpoint(str(tmp_path / "cpu.npz"))
    a, b = np.load(tmp_path / "card.npz"), np.load(tmp_path / "cpu.npz")
    assert a.files == b.files
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in b.files)
    with pytest.raises(ValueError, match="float64"):
        card.state = N.nlms_init_state(torch.float32)


def test_card_route_on_the_cpu_spans(card_on_cpu):
    """A chunk's spans are the card route's tree, one request id; the state
    read after it is a ``session.state`` copy of the same request id,
    outside ``session.process``; a second read records nothing."""
    card, (x, r) = ST.AECSession("nlms", device="cuda"), _streams(2048)
    card.process(x[0, :1024], r[0, :1024])
    REGISTRY.take_spans()
    with REGISTRY.recording():
        card.process(x[0, 1024:], r[0, 1024:])
        card.state
        card.state
    spans = REGISTRY.take_spans()
    assert _shape(spans) == CARD_TREE + [("session.state", "copy", None)]
    assert len({s.request for s in spans}) == 1 and spans[0].request[1] == 2


def test_card_route_on_the_cpu_none_releases_the_card_s_buffers(card_on_cpu):
    """``state = None`` drops the resident state and the staging buffers
    with it, reading nothing back; the getter gives None."""
    card, (x, r) = ST.AECSession("nlms", device="cuda"), _streams(1024)
    card.process(x[0], r[0])
    reads = REGISTRY.counters["session.state_reads"]
    card.state = None
    assert card.state is None and card._card is None and card._staging is None
    assert REGISTRY.counters["session.state_reads"] == reads


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the route runs K8, which has no CPU mode")
    return torch.device("cuda")


def test_card_session_equals_the_cpu_session_chunk_by_chunk(cuda):
    """24 chunks of 1,024 and 3,072 samples of a double-talk stream: est,
    err and the state bit-equal to the CPU session's after every chunk; one
    K8 launch, one staged chunk and one state read a chunk."""
    card, cpu = ST.AECSession("nlms", device=cuda), ST.AECSession("nlms", device="cpu")
    x, r = _streams()
    before, launches = _counts(), K8.nlms.launches
    for xc, rc in _chunks(x[3], r[3]):
        got, want = card.process(xc, rc), cpu.process(xc, rc)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        _equal_states(card.state, cpu.state)
        _equal_states(card.state, cpu.state)  # from the cache
    assert K8.nlms.launches == launches + len(LENGTHS)
    assert _counts() == {"session.staged": before["session.staged"] + len(LENGTHS),
                         "session.state_reads": before["session.state_reads"] + len(LENGTHS)}


def test_card_session_continues_from_an_assigned_state_and_a_restore(cuda, tmp_path):
    """A state assigned mid-stream (a CPU session's dict), and a restore of
    an npz the CPU session wrote, each continue exactly as the CPU session;
    the card's checkpoint equals the CPU session's byte for byte."""
    x, r = _streams()
    cpu = ST.AECSession("nlms", device="cpu")
    for xc, rc in _chunks(x[0, :8192], r[0, :8192], [3072, 1024, 3072, 1024]):
        cpu.process(xc, rc)
    card = ST.AECSession("nlms", device=cuda)
    card.process(x[3, :3072], r[3, :3072])
    card.state = cpu.state
    cpu.checkpoint(str(tmp_path / "cpu.npz"))
    again = ST.AECSession("nlms", device=cuda)
    again.restore(str(tmp_path / "cpu.npz"))
    for xc, rc in _chunks(x[0, 8192:], r[0, 8192:], LENGTHS[:12]):
        want = cpu.process(xc, rc)
        for got in (card.process(xc, rc), again.process(xc, rc)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    _equal_states(card.state, cpu.state)
    for s, name in ((card, "card.npz"), (cpu, "cpu.npz")):
        s.checkpoint(str(tmp_path / name))
    a, b = np.load(tmp_path / "card.npz"), np.load(tmp_path / "cpu.npz")
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in b.files)


def test_card_session_three_device_activities_a_chunk(cuda):
    """20 chunks under torch.profiler: K8 once a chunk, and exactly three
    device activities a chunk: the copy in from pinned memory, K8 and the
    copy out into pinned memory; a state read between chunks adds one copy
    into pinned memory."""
    from torch.profiler import ProfilerActivity, profile

    s, (x, r) = ST.AECSession("nlms", device=cuda), _streams()
    chunks = list(_chunks(x[0], r[0], [1024] * 24))
    for xc, rc in chunks[:4]:  # build and warm up
        s.process(xc, rc)
    torch.cuda.synchronize()
    before = K8.nlms.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for xc, rc in chunks[4:]:
            s.process(xc, rc)
        s.state
        torch.cuda.synchronize()
    assert K8.nlms.launches == before + 20
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = sorted({e.name for e in acts})
    print(f"\n[AEC card session] {len(acts) / 20:.2f} device activities a chunk; {names}")
    kinds = [[e for e in acts if key in e.name] for key in ("HtoD", "nlms_kernel", "DtoH")]
    assert [len(k) for k in kinds] == [20, 20, 21] and len(acts) == 61, names
    assert all("Pinned" in e.name for e in kinds[0] + kinds[2]), names


def test_card_session_allocates_nothing_over_1000_chunks(cuda):
    """After its first chunk, 1,000 chunks of 1,024 samples leave the
    card's allocated memory where it was."""
    s, (x, r) = ST.AECSession("nlms", device=cuda), _streams(8192)
    s.process(x[0, :1024], r[0, :1024])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    for k in range(1000):
        a = 1024 * (k % 8)
        s.process(x[0, a:a + 1024], r[0, a:a + 1024])
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == held


def test_card_session_spans(cuda):
    """A recorded chunk on the card: the card route's tree with its drain,
    one request id, and no ``nlms.apply`` or ``nlms.state_*``; the state
    read after it a ``session.state`` copy outside ``session.process``."""
    s, (x, r) = ST.AECSession("nlms", device=cuda), _streams(2048)
    s.process(x[0, :1024], r[0, :1024])
    REGISTRY.take_spans()
    with REGISTRY.recording():
        s.process(x[0, 1024:], r[0, 1024:])
        s.state
    spans = REGISTRY.take_spans()
    assert _shape(spans) == CARD_TREE + [("session.state", "copy", None)]
    assert len({sp.request for sp in spans}) == 1
