"""The closed loop of live sessions: N streams, each with a session of its
own, and one server that hands every stream its next chunk in turn, back to
back, with no wait between chunks.  The streams' order within each round
is drawn from the seed, so every seed serves the same work in another
order.  The server is never idle, so the rate it serves is its capacity,
whatever that is: no offered rate caps it and no backlog has to drain.

A chunk counts when its output is in host memory by the window's close; the
chunk running at the close is served to its end and judged, but not
counted.  A chunk whose call raised has failed, and the streams go on.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np


class LiveRun:
    """Per chunk served, in order: its stream (``who``), start and done
    (clock seconds) and whether it succeeded; ``t0`` and ``t_end`` bound the
    window."""

    def __init__(self, t0, t_end, who, start, done, ok):
        self.t0, self.t_end = t0, t_end
        self.who, self.start, self.done, self.ok = who, start, done, ok

    def completed(self):
        """Chunks that succeeded with their output in host memory by the close."""
        return int((self.ok & (self.done <= self.t_end)).sum())

    def spans(self):
        return [("process", a, b) for a, b in zip(self.start, self.done)]


def run(n_streams, serve, seconds, seed, clock=time.perf_counter, close_at=None,
        on_close=None):
    """Serve stream i's next chunk (``serve(i)``) round after round for
    ``seconds``.  ``on_close()`` runs once, before the first chunk that
    starts ``close_at`` seconds or more into the window (a trace stops
    there), or at the end."""
    rng = np.random.default_rng(seed)
    who, start, done, ok = [], [], [], []
    close_at = seconds if close_at is None else close_at
    t0 = clock()
    t_end = t0 + seconds
    failed = 0
    while True:
        for i in rng.permutation(n_streams).tolist():
            s = clock()
            if on_close is not None and s >= t0 + close_at:
                on_close()
                on_close = None
                s = clock()
            if s >= t_end:
                break
            try:
                serve(i)
                good = True
            except Exception:  # a failed chunk counts and the streams go on
                good = False
                failed += 1
                if failed == 1:
                    traceback.print_exc(file=sys.stderr)
            who.append(i)
            start.append(s)
            done.append(clock())
            ok.append(good)
        else:
            continue
        break
    if on_close is not None:
        on_close()
    return LiveRun(t0, t_end, np.array(who, np.int64), np.array(start), np.array(done),
                   np.array(ok, bool))
