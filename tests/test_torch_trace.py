"""The port's spans (``utils.metrics``: ``Metrics.span``, ``REGISTRY``) in
the sessions and ops that record them: ``EnhanceSession.process`` and
``enhance_chunk``, ``AECSession.process`` and ``nlms_apply``.  Imports
neither jax nor the JAX package, so it runs on a card's host too:

    python -m pytest --noconftest -q tests/test_torch_trace.py

Off, a site records nothing and reads no clock; on, each call's spans form
the trees below (on a card a Wiener chunk runs as one kernel, K15, so its
``enhance.chunk`` holds ``enhance.kernel`` alone, and its copy in from
pinned memory is a ``stage``; an NLMS chunk there is K8 on the state the
session keeps on the card, with no ``nlms.apply``, and a read of that state
a ``session.state`` copy of its own), children inside their
parents, one request id a chunk, copies and waits apart, the outputs
bit-equal to an unrecorded run.  The
card tests (skipped without CUDA) hold every synchronising call that torch
flags inside a ``copy`` or ``wait`` span, and print what the spans cost
(``-s``), each line naming the card.
"""

import gc
import json
import subprocess
import time
import warnings
from collections import defaultdict
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jeicyboodsp_tpu_torch.io import stream as TS
from jeicyboodsp_tpu_torch.ops import nlms as N
from jeicyboodsp_tpu_torch.utils import metrics as M
from jeicyboodsp_tpu_torch.utils import profiling as P
from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY

ENHANCE_TREE = [  # (name, kind, parent's name)
    ("session.process", "stage", None),
    ("session.chunk_in", "copy", "session.process"),
    ("enhance.chunk", "stage", "session.process"),
    ("enhance.fft", "stage", "enhance.chunk"),
    ("enhance.vad", "stage", "enhance.chunk"),
    ("enhance.noise", "stage", "enhance.chunk"),
    ("enhance.cnt", "wait", "enhance.noise"),
    ("enhance.latch_rows", "wait", "enhance.noise"),
    ("enhance.noise_rows", "wait", "enhance.noise"),
    ("enhance.halve", "wait", "enhance.noise"),
    ("enhance.resynth", "stage", "enhance.chunk"),
    ("enhance.ola", "stage", "enhance.chunk"),
    ("enhance.t", "wait", "enhance.ola"),
    ("session.drain", "wait", "session.process"),  # on a card only
    ("session.out", "copy", "session.process"),
]
# a float64 chunk on a card runs as one kernel, K15 (ops.enhance.enhance_chunk), and
# its copy in, from pinned memory, does not block
ENHANCE_CARD_TREE = (ENHANCE_TREE[:1] + [("session.chunk_in", "stage", "session.process")]
                     + ENHANCE_TREE[2:3] + [("enhance.kernel", "stage", "enhance.chunk")]
                     + ENHANCE_TREE[-2:])
APPLY_TREE = [
    ("nlms.apply", "stage", None),
    ("nlms.state_in", "copy", "nlms.apply"),
    ("nlms.kernel", "stage", "nlms.apply"),
    ("nlms.drain", "wait", "nlms.apply"),  # on a card only
    ("nlms.state_out", "copy", "nlms.apply"),
]
AEC_TREE = ([("session.process", "stage", None), ("session.chunk_in", "copy", "session.process")]
            + [(n, k, p or "session.process") for n, k, p in APPLY_TREE]
            + ENHANCE_TREE[-1:])  # nlms_apply leaves nothing queued: no session.drain
CARD_ONLY = ("session.drain", "nlms.drain")
# an NLMS session on a card keeps its state there (io.stream._K8State): a chunk is its copy
# in from pinned memory, K8 and its copy out, and the state read after it is a root of its own
AEC_CARD_TREE = (ENHANCE_CARD_TREE[:2] + [("nlms.kernel", "stage", "session.process")]
                 + ENHANCE_TREE[-2:] + [("session.state", "copy", None)])


def _signal(n, seed):
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    gate = (np.sin(2 * np.pi * t / 8000) > 0.2)
    x = 3000 * np.sin(2 * np.pi * 300 * t / 16000) * gate + rng.normal(0, 20, n)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


class Case:
    """One kind of call, ``call(k)`` its k-th (chunks of one session, or
    ``nlms_apply`` calls threading one state) and ``run(k)`` the same with
    its outputs and the state after it on the host; ``tree`` its spans'
    shape."""

    def __init__(self, name, device):
        self.name, self.dev = name, torch.device(device)
        self.chunks = 4 if name == "apply" else 16  # the k that have input
        if name == "enhance":
            self.tree, sess = ENHANCE_TREE, TS.EnhanceSession("wiener", device=device)
            x = _signal(16 * 1024, 1)
            self.call = lambda k: sess.process(x[k * 1024:(k + 1) * 1024].reshape(2, 512))
            self._state = lambda: {k: v.cpu().numpy() for k, v in sess.state.items()}
        elif name == "aec":
            self.tree, sess = AEC_TREE, TS.AECSession("nlms", device=device)
            x, r = _signal(16 * 1024, 2), _signal(16 * 1024, 3) // 2
            self.call = lambda k: sess.process(x[k * 1024:(k + 1) * 1024],
                                               r[k * 1024:(k + 1) * 1024])
            self._state = lambda: {k: v.numpy() for k, v in sess.state.items()}
        else:
            self.tree = APPLY_TREE
            x = torch.from_numpy(np.stack([_signal(4096, 4), _signal(4096, 5)])).to(device)
            r = torch.from_numpy(np.stack([_signal(4096, 6), _signal(4096, 7)]) // 2).to(device)
            st = {"s": {"hist": torch.zeros(2, N.NLMS_KEEP, dtype=torch.int32),
                        "coeff": torch.zeros(2, N.NLMS_TAPS, dtype=torch.float64)}}

            def call(k):
                est, err, st["s"] = N.nlms_apply(x[:, k * 1024:(k + 1) * 1024],
                                                 r[:, k * 1024:(k + 1) * 1024], st["s"])
                return est, err
            self.call = call
            self._state = lambda: {k: v.numpy() for k, v in st["s"].items()}

    def run(self, k):
        out = self.call(k)
        if self.name == "apply":
            out = tuple(v.cpu().numpy() for v in out)
        return out, self._state()

    def expected(self):
        card = self.dev.type == "cuda"
        if card and self.name != "apply":
            return ENHANCE_CARD_TREE if self.name == "enhance" else AEC_CARD_TREE
        return [t for t in self.tree if card or t[0] not in CARD_ONLY]


CASES = ("enhance", "aec", "apply")


@pytest.fixture(autouse=True)
def _clean_registry():
    REGISTRY.take_spans()
    yield
    REGISTRY.take_spans()


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype


def _shape(spans, a, b):
    return [(s.name, s.kind, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans[a:b]]


def _check_tree(spans, want, chunks):
    roots = [i for i, s in enumerate(spans) if s.parent < 0 and s.name == want[0][0]]
    assert len(roots) == chunks
    for a, b in zip(roots, roots[1:] + [len(spans)]):
        assert _shape(spans, a, b) == [(n, k, p) for n, k, p in want]
        assert len({s.request for s in spans[a:b]}) == 1  # one request id a chunk
    for s in spans:
        assert s.kind in M.KINDS and s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns  # inside its parent
    blocking = sorted((s.start_ns, s.end_ns) for s in spans if s.kind != "stage")
    for (_, e), (s2, _) in zip(blocking, blocking[1:]):
        assert e <= s2  # copies and waits never overlap


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("case", CASES)
def test_off_records_nothing_and_reads_no_clock(case, monkeypatch):
    c = Case(case, "cpu")
    monkeypatch.setattr(M, "time", SimpleNamespace())  # any clock read raises
    assert not REGISTRY.enabled
    c.run(0)
    assert REGISTRY.spans() == []


@pytest.mark.parametrize("case", CASES)
def test_on_records_the_tree_and_leaves_outputs_bit_equal(case):
    off, on = Case(case, "cpu"), Case(case, "cpu")
    want = [off.run(k) for k in range(3)]
    with REGISTRY.recording():
        got = [on.run(k) for k in range(3)]
    assert not REGISTRY.enabled
    assert _equal(got, want)
    spans = REGISTRY.spans()
    _check_tree(spans, on.expected(), chunks=3)
    ids = [s.request for s in spans if s.parent < 0]
    if case == "apply":
        assert ids == [None] * 3
    else:
        assert [i[1] for i in ids] == [1, 2, 3] and len({i[0] for i in ids}) == 1


def test_sessions_have_serials_of_their_own():
    a, b = TS.EnhanceSession(device="cpu"), TS.EnhanceSession(device="cpu")
    x = _signal(1024, 8).reshape(2, 512)
    with REGISTRY.recording():
        a.process(x)
        b.process(x)
        a.process(x)
    ids = [s.request for s in REGISTRY.spans() if s.parent < 0]
    assert ids[0][0] == ids[2][0] != ids[1][0] and [i[1] for i in ids] == [1, 1, 2]


def test_drain_waits_inside_a_wait_span_on_a_card_only(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(synchronize=lambda: calls.append(d)))
    card = SimpleNamespace(type="cuda")
    REGISTRY.drain("x.drain", card)  # off: nothing
    with REGISTRY.recording():
        REGISTRY.drain("x.drain", torch.device("cpu"))  # no queue to drain
        with REGISTRY.span("x", "stage", 7, 1):
            REGISTRY.drain("x.drain", card)
    assert calls == [card]
    assert [(s.name, s.kind, s.parent, s.request) for s in REGISTRY.spans()] == [
        ("x", "stage", -1, (7, 1)), ("x.drain", "wait", 0, (7, 1))]


def test_a_running_profiler_records_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        with REGISTRY.span("a"):
            pass
    with REGISTRY.span("b"):
        pass
    assert [s.name for s in REGISTRY.spans()] == ["a"]


def test_past_max_spans_nothing_more_is_recorded(monkeypatch):
    monkeypatch.setattr(M, "MAX_SPANS", 2)
    with REGISTRY.recording():
        for name in "abc":
            with REGISTRY.span(name):
                pass
        REGISTRY.drain("x.drain", SimpleNamespace(type="cuda"))  # no sync: it would raise here
    assert [s.name for s in REGISTRY.spans()] == ["a", "b"]


def test_ended_spans_drop_out_of_the_garbage_collector_s_lists():
    """A traced window's spans add nothing to the collector's work: an
    ended span is kept as a plain tuple, which collections untrack (its
    request id first, then the span: two passes at most)."""
    with REGISTRY.recording():
        with REGISTRY.span("a", "stage", 3, 1):
            with REGISTRY.span("b", "copy"):  # running spans read as ending at None
                assert [(s.name, s.end_ns) for s in REGISTRY.spans()] == [("a", None),
                                                                           ("b", None)]
        gc.collect()
        gc.collect()
        assert not any(gc.is_tracked(s) for s in REGISTRY._spans)
    assert [(s.name, s.parent, s.request) for s in REGISTRY.spans()] == [
        ("a", -1, (3, 1)), ("b", 0, (3, 1))]


def test_a_drain_is_named_as_recording_s_own():
    with REGISTRY.recording(), pytest.raises(ValueError, match="ends in"):
        REGISTRY.drain("x.wait", SimpleNamespace(type="cuda"))
    assert REGISTRY.spans() == []


def test_take_spans_since_renumbers_parents():
    with REGISTRY.recording():
        with REGISTRY.span("outer"):
            with REGISTRY.span("before"):
                pass
            first = len(REGISTRY.spans())
            with REGISTRY.span("mine"):
                with REGISTRY.span("child", "copy"):
                    pass
        taken = REGISTRY.take_spans(first)
    assert [(s.name, s.parent) for s in taken] == [("mine", -1), ("child", 0)]
    assert [s.name for s in REGISTRY.spans()] == ["outer", "before"]


def test_a_mapped_span_holds_the_profiler_s_event():
    """The harness's mapping (``to_ns``: the wall clock and the host clock
    read side by side) puts a program span around ``torch.mm`` around the
    profiler's ``aten::mm`` event."""
    a = torch.ones(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wall0, clk0 = time.time_ns(), time.perf_counter()
        with REGISTRY.span("mm"):
            a @ a
    to_ns = lambda t: wall0 + int((t - clk0) * 1e9)  # noqa: E731
    (s,) = REGISTRY.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert to_ns(s.start_ns / 1e9) <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= to_ns(s.end_ns / 1e9)
    off = M.clock_offset_ns()
    assert s.start_ns + off <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= s.end_ns + off


def test_trace_writes_the_block_s_spans_on_the_trace_s_clock(tmp_path):
    sess = TS.AECSession("nlms", device="cpu")
    x, r = _signal(1024, 2), _signal(1024, 3) // 2
    with REGISTRY.span("outside"):  # neither recorded nor written
        pass
    with P.trace(str(tmp_path)):
        sess.process(x, r)
    assert REGISTRY.spans() == []  # the block's spans went to the file
    (spans_file,) = tmp_path.glob("spans_*.json")
    (trace_file,) = tmp_path.glob("trace_*.json")
    spans = json.loads(spans_file.read_text())["spans"]
    assert [(s["name"], s["kind"]) for s in spans] == [
        (n, k) for n, k, _ in AEC_TREE if n not in CARD_ONLY]
    doc = json.loads(trace_file.read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    ops = [(base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3))
           for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"].startswith("aten::")]
    root = spans[0]  # every op of the block ran inside the chunk's span
    assert ops and all(root["start_ns"] - 1000 <= a <= b <= root["end_ns"] + 1000 for a, b in ops)


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the drain and the flagged syncs are the card's")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
def test_card_every_flagged_sync_lies_in_a_copy_or_wait_span(case, cuda):
    c = Case(case, "cuda")
    c.run(0)  # build and warm up
    flagged = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            flagged.append(time.perf_counter_ns())

    REGISTRY.take_spans()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        runs = range(1, 21 if case != "apply" else 2)
        try:
            with REGISTRY.recording():
                for k in runs:
                    c.run(k % 16)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    spans = [s for s in REGISTRY.spans()]
    roots = [s for s in spans if s.parent < 0]
    blocking = [(s.start_ns, s.end_ns) for s in spans if s.kind != "stage"]
    inside = [t for t in flagged if any(a <= t <= b for a, b in blocking)]
    in_roots = [t for t in flagged if any(r.start_ns <= t <= r.end_ns for r in roots)]
    assert in_roots and len(inside) == len(in_roots), (len(inside), len(in_roots))
    _check_tree(spans, c.expected(), chunks=len(runs))


SITES = 200_000


def _card(dev):
    """The card's name and power limit, as every printed number carries them."""
    try:
        rows = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        rows = []
    return rows[dev.index or 0] if len(rows) > (dev.index or 0) else torch.cuda.get_device_name(dev)


def _site_ns(dev):
    """ns a ``span`` site and a ``drain`` site cost with nothing recording,
    and a ``span`` site recording, each less the empty loop's."""
    def loop(body):
        t0 = time.perf_counter_ns()
        for _ in range(SITES):
            body()
        return (time.perf_counter_ns() - t0) / SITES

    def span():
        with REGISTRY.span("x"):
            pass

    empty = loop(lambda: None)
    out = {"span_off": loop(span) - empty,
           "drain_off": loop(lambda: REGISTRY.drain("x.drain", dev)) - empty}
    with REGISTRY.recording():
        out["span_on"] = loop(span) - empty
    REGISTRY.take_spans()
    return out


@pytest.mark.parametrize("case", CASES)
def test_card_span_costs(case, cuda):
    """What the spans cost the card's host, printed on one line that names
    the card (run with ``-s``): a site with nothing recording and with spans
    recorded, the disabled sites' share of a call, and 2,000 calls timed one
    by one with spans recorded and no profiler running, in turns off, on,
    on, off of 500.  Holds the disabled sites under 2% of a call (they read
    0.17-0.80% on an H100's host, whose speed varies by tens of %), and a
    recorded call's outputs and state bit-equal to an unrecorded one's."""
    off, on = Case(case, "cuda"), Case(case, "cuda")
    want = [off.run(k) for k in range(3)]
    with REGISTRY.recording():
        got = [on.run(k) for k in range(3)]
    assert _equal(got, want)
    REGISTRY.take_spans()
    site = _site_ns(cuda)
    c, n, k = Case(case, "cuda"), 500, 0
    for j in range(3):  # build and warm up
        c.call(j)
    torch.cuda.synchronize(cuda)
    sides, turns, per_name, roots = {False: [], True: []}, [], defaultdict(list), 0
    for rec in (False, True, True, False):
        ts = []
        with REGISTRY.recording() if rec else nullcontext():
            for _ in range(n):
                t0 = time.perf_counter_ns()
                c.call(k % c.chunks)
                torch.cuda.synchronize(cuda)
                ts.append(time.perf_counter_ns() - t0)
                k += 1
        sides[rec] += ts
        turns.append(float(np.median(ts)) / 1e6)
        for s in REGISTRY.take_spans():
            per_name[s.name].append(s.end_ns - s.start_ns)
            roots += s.parent < 0
    assert roots == 2 * n
    off_ms, on_ms = (float(np.median(sides[r])) / 1e6 for r in (False, True))
    spans_a_call = sum(map(len, per_name.values())) / roots
    drains = sum(len(v) for name, v in per_name.items() if name.endswith(M.DRAIN)) / roots
    idle_ns = (spans_a_call - drains) * site["span_off"] + drains * site["drain_off"]
    share = idle_ns / (off_ms * 1e6)
    mean_us = {name: round(float(np.mean(v)) / 1e3, 2) for name, v in per_name.items()}
    print(f"\n[{_card(cuda)}] {case}: a site with nothing recording {site['span_off']:.0f} ns "
          f"(span), {site['drain_off']:.0f} ns (drain); recording {site['span_on']:.0f} ns; "
          f"{spans_a_call:.0f} sites a call ({drains:.0f} drains) = {100 * share:.3f}% of its "
          f"{off_ms:.4f} ms; recorded, no profiler: {on_ms:.4f} ms "
          f"({100 * (on_ms / off_ms - 1):+.2f}%), turns off/on/on/off "
          f"{' '.join(f'{t:.4f}' for t in turns)} ms; mean us a span {json.dumps(mean_us)}")
    assert share < 0.02
