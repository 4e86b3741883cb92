"""The readers of the port's spans, and the idle gaps named by them, on
made-up spans and profiler events (CPU), then one traced run of each live
configuration on the CPU at a tiny size.
Run: ``python -m pytest portbench -q``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import devtrace, harness, spans
from portbench.test_portbench_trace import Ev


def _span(name, kind, start, end, parent=-1):
    return SimpleNamespace(name=name, kind=kind, start_ns=start, end_ns=end, parent=parent)


def _chunk(t, first):
    """One recorded chunk starting at ``t`` ns, its root at index ``first``:
    1,000 ns long, copies 100 + 50 ns, waits 190 + 30 ns (one inside a stage)."""
    return [_span("session.process", "stage", t, t + 1000),
            _span("session.chunk_in", "copy", t + 10, t + 110, first),
            _span("enhance.chunk", "stage", t + 120, t + 800, first),
            _span("enhance.cnt", "wait", t + 300, t + 330, first + 2),
            _span("session.drain", "wait", t + 810, t + 1000, first),
            _span("session.out", "copy", t + 940, t + 990, first)]


def _call(t, first):
    return [_span("nlms.apply", "stage", t, t + 10_000),
            _span("nlms.state_in", "copy", t + 100, t + 600, first),
            _span("nlms.kernel", "stage", t + 700, t + 800, first),
            _span("nlms.drain", "wait", t + 800, t + 8_800, first),
            _span("nlms.state_out", "copy", t + 8_800, t + 9_800, first)]


@pytest.fixture
def made_up(monkeypatch):
    recorded = []
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    return recorded


def _live(made_up, n_chunks, read_chunks):
    old = _call(0, 0)  # an earlier window's root of another name
    made_up.extend(old)
    for k in range(n_chunks):
        made_up.extend(_chunk(100_000 * (k + 1), len(made_up)))
    return harness.Reading(None, chunks=read_chunks)


def test_live_readers(made_up):
    r = _live(made_up, 3, 2)  # the window's last 2 chunks
    assert harness.reader("copy_ms.live")(r) == pytest.approx(150 / 1e6)
    assert harness.reader("wait_ms.live")(r) == pytest.approx(190 / 1e6 + 30 / 1e6)
    assert harness.reader("syncs_per_chunk.live")(r) == 3  # not the drain: recording's
    # 1,000 less the union of copies and waits: 100 + 30 + 190, the out copy
    # inside the drain
    assert harness.reader("issue_ms.live")(r) == pytest.approx((1000 - 100 - 30 - 190) / 1e6)


def test_live_readers_take_the_window_s_chunks_only(made_up):
    r = _live(made_up, 3, 1)
    made_up[-6].end_ns += 1000  # the last chunk's root: 2,000 ns
    assert harness.reader("issue_ms.live")(r) == pytest.approx((2000 - 100 - 30 - 190) / 1e6)


def test_batch_readers(made_up):
    made_up.extend(_chunk(0, 0))
    for k in range(3):
        made_up.extend(_call(100_000 * (k + 1), len(made_up)))
    r = harness.Reading(None, calls=3)
    assert harness.reader("copy_ms.batch")(r) == pytest.approx(1500 / 1e6)
    assert harness.reader("wait_ms.batch")(r) == pytest.approx(8000 / 1e6)


@pytest.mark.parametrize("name", ["copy_ms.live", "wait_ms.live", "issue_ms.live",
                                  "syncs_per_chunk.live", "copy_ms.batch", "wait_ms.batch"])
@pytest.mark.parametrize("recorded", [None, []], ids=["no recorder", "no spans"])
def test_readers_find_nothing_where_the_port_records_nothing(monkeypatch, name, recorded):
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    assert harness.reader(name)(harness.Reading(None, calls=4, chunks=4)) is None


def test_recorded_is_none_for_a_registry_without_spans(monkeypatch):
    from jeicyboodsp_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "REGISTRY", SimpleNamespace(counters={}))
    assert spans.recorded() is None


def test_innermost_under_a_parent_that_outlives_a_later_child():
    tree = [("process", 0, 100), ("chunk", 10, 60), ("fft", 12, 20), ("cnt", 30, 35),
            ("out", 70, 90), ("next", 200, 300)]
    t = [5, 15, 25, 32, 40, 65, 80, 95, 150, 250]
    assert spans.innermost(tree, t) == ["process", "fft", "chunk", "cnt", "chunk", "process",
                                        "out", "process", None, "next"]
    # the latest span started (out, 70) has ended at 95 while its parent runs:
    # the latest start alone names nothing there
    import numpy as np
    assert devtrace._names_at([x[0] for x in tree], np.array([x[1] for x in tree]),
                              np.array([x[2] for x in tree]), np.array([95]))[0] is None


EVENTS = [Ev("k1", 100, 300), Ev("k2", 200, 300), Ev("Memcpy HtoD", 700, 100),
          Ev("Context Sync", 800, 150), Ev("k3", 950, 200),
          Ev("cudaLaunchKernel", 520, 100, cuda=False)]
HARNESS = [("process", 500, 700)]


def test_without_program_spans_the_gaps_are_devtrace_s():
    tr = devtrace.read(EVENTS, (0, 1000), HARNESS)
    assert sorted(spans.split_gaps(EVENTS, (0, 1000), HARNESS, [])) == sorted(tr.idle_gaps)
    assert dict(tr.idle_gaps) == pytest.approx({"idle: host": 250e-9,
                                                "process: cudaLaunchKernel": 200e-9})


def test_program_spans_name_the_gaps():
    prog = [("session.process", 450, 1000), ("nlms.kernel", 500, 560),
            ("nlms.state_out", 560, 1000)]
    got = dict(spans.split_gaps(EVENTS, (0, 1000), HARNESS, prog))
    # [500, 700): middle 600, inside state_out, while cudaLaunchKernel runs;
    # [800, 950): middle 875, inside state_out, outside the harness's span
    assert got == pytest.approx({"idle: host": 100e-9,
                                 "process > nlms.state_out: cudaLaunchKernel": 200e-9,
                                 "idle > nlms.state_out: host": 150e-9})
    shares = spans.named_shares(list(got.items()))
    assert shares["idle: host"]["named_pct"] == pytest.approx(60.0)
    assert shares["process: cudaLaunchKernel"]["named_pct"] == pytest.approx(100.0)


@pytest.mark.parametrize("name", ["wiener16k.live", "nlms256.live"])
def test_a_traced_live_run_reports_the_new_metrics(name):
    """The port records its spans under the harness's profiler on the CPU
    too: the live readers find them, and a chunk's copies, waits and issue
    time add up to its span."""
    from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY

    REGISTRY.take_spans()
    cell = harness.Cell(name)
    wiener = name.startswith("wiener")
    # service_ms.live cuts the last chunk at the window's close: enough chunks
    # that one cut chunk moves it little (the CPU's NLMS chunk takes ~0.1 s)
    res, _, _ = harness.run_cell(cell, 2 ** 31 + 99, 0.6 if wiener else 3.0, trace=True,
                                 device="cpu", traffic=dict(cell.traffic, streams=2,
                                                            warm_chunks=1))
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for k in ("copy_ms.live", "issue_ms.live", "syncs_per_chunk.live") + (
            ("wait_ms.live",) if wiener else ()):  # the CPU's NLMS chunk reads no card value
        assert m[k] > 0, k
    total = m["copy_ms.live"] + m["wait_ms.live"] + m["issue_ms.live"]
    assert 0.9 * m["service_ms.live"] <= total <= 1.1 * m["service_ms.live"]
    assert m["syncs_per_chunk.live"] == (7 if wiener else 4)  # no drain on the CPU
    assert len(REGISTRY.take_spans()) > 0
