"""The load drivers on a fake clock (CPU).  Run: ``python -m pytest portbench -q``."""

from __future__ import annotations

import numpy as np

from portbench.drivers import files, live


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def wait(self, t):
        self.now = max(self.now, t)


U = 2.0 ** -8  # a tick of the fake clock, exact in binary


def _serve(clock, service_s, fail=()):
    served = []

    def serve(i):
        clock.now += service_s
        served.append(i)
        if len(served) in fail:
            raise RuntimeError("a chunk that fails")
    return serve, served


def test_live_serves_every_stream_each_round_in_a_seeded_order():
    clock = FakeClock()
    serve, served = _serve(clock, U)
    run = live.run(5, serve, 50 * U, seed=11, clock=clock)
    assert len(served) == 50 and run.who.tolist() == served
    rounds = np.array(served).reshape(10, 5)
    assert all(sorted(r) == list(range(5)) for r in rounds.tolist())
    assert len({tuple(r) for r in rounds.tolist()}) > 1  # the order changes from round to round
    clock2 = FakeClock()
    again = live.run(5, _serve(clock2, U)[0], 50 * U, seed=11, clock=clock2)
    assert np.array_equal(run.who, again.who)  # the same seed, the same order
    clock3 = FakeClock()
    other = live.run(5, _serve(clock3, U)[0], 50 * U, seed=12, clock=clock3)
    assert not np.array_equal(run.who, other.who)
    assert np.allclose(run.done - run.start, U) and run.completed() == 50


def test_live_rate_is_the_servers_and_counts_chunks_done_by_the_close():
    """Back to back: halving the service time doubles the chunks served,
    with no offered rate to cap it; the chunk running at the close is
    served but not counted."""
    counts = {}
    for svc in (3 * U, 1.5 * U):
        clock = FakeClock()
        run = live.run(4, _serve(clock, svc)[0], 100 * U, seed=3, clock=clock)
        counts[svc] = run.completed()
        assert len(run.who) == run.completed() + 1 and run.done[-1] > run.t_end
    assert counts[3 * U] == 33 and counts[1.5 * U] == 66


def test_live_failed_chunk_counts_and_the_streams_go_on():
    clock = FakeClock()
    run = live.run(3, _serve(clock, 4 * U, fail=(2,))[0], 40 * U, seed=5, clock=clock)
    assert (~run.ok).sum() == 1 and not run.ok[1] and len(run.who) == 10
    assert run.completed() == 9


def test_live_trace_closes_at_its_share_of_the_window():
    """``on_close`` runs once, before the first chunk that starts at
    ``close_at`` or later, and a slow hook's time is the window's."""
    clock, hits = FakeClock(), []

    def close():
        hits.append(clock.now - 100.0)
        clock.now += 8 * U

    run = live.run(4, _serve(clock, 4 * U)[0], 40 * U, seed=1, clock=clock, close_at=20 * U,
                   on_close=close)
    assert hits == [20 * U]  # after 5 chunks; 3 more fit after the hook's 8 ticks
    assert len(run.who) == 8 and run.completed() == 8


class _Item:
    def __init__(self, samples):
        self.samples = samples


def test_files_counts_calls_complete_in_the_window():
    """Calls complete after the window's close are not counted; in_flight
    calls are held open; the held sample includes the longest item's."""
    clock = FakeClock()
    items = [_Item(100), _Item(300)]
    device_done = []

    def call(item):
        clock.now += 0.001  # the host's issue time
        return item.samples

    def fence():
        device_done.append(clock.now + 0.010)
        return len(device_done) - 1

    def wait(f):
        clock.now = max(clock.now, device_done[f])

    run = files.run(items, call, 0.1, seed=3, fence=fence, wait=wait, in_flight=2, hold=2,
                    clock=clock)
    assert run.failed == 0 and run.issued >= run.completed > 0
    assert run.completed <= run.issued and run.samples <= 300 * run.completed
    assert any(out == 300 for _, out in run.held)
    waits = [e for n, s, e in run.spans if n == "wait"]
    assert run.completed == sum(e <= run.t_end for e in waits)
