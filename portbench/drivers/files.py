"""The closed loop: one caller makes back-to-back calls of the system's
offline entry, one pool item a call, in an order drawn from the seed, with
at most ``in_flight`` calls issued and not yet complete (the caller hands
over the next recording while the previous one finishes).  A call is
complete when the host sees the device's fence after it pass; the work of
the calls complete within the window, over the window, is the throughput.
A sample of the calls issued in the window, drawn from the seed as a
reservoir, and the last call of the longest item, keep their outputs for
the check."""

from __future__ import annotations

import sys
import time
import traceback
from collections import deque

import numpy as np


class FilesRun:
    """What the window did: calls issued in it and failed, the calls and
    samples complete within it, the held (item, output) pairs, and the host
    spans ``("issue" | "wait", start, end)`` in the clock's seconds."""

    def __init__(self):
        self.t0 = self.t_end = 0.0
        self.issued = self.failed = self.completed = self.samples = 0
        self.held, self.spans = [], []


def run(items, call, seconds, seed, fence, wait, in_flight=2, hold=4,
        clock=time.perf_counter):
    """Drive ``call(item)`` for ``seconds``.  ``fence()`` marks the device's
    progress after a call and ``wait(f)`` blocks until it has passed."""
    rng = np.random.default_rng(seed)
    longest = max(range(len(items)), key=lambda k: items[k].samples)
    res = FilesRun()
    reservoir, last_longest = [], None
    pending = deque()
    order = rng.permutation(len(items))

    def retire():
        k, item, f = pending.popleft()
        s = clock()
        wait(f)
        e = clock()
        res.spans.append(("wait", s, e))
        if e <= res.t_end:
            res.completed += 1
            res.samples += item.samples

    res.t0 = clock()
    res.t_end = res.t0 + seconds
    n = 0
    while clock() < res.t_end:
        if n and n % len(items) == 0:
            order = rng.permutation(len(items))
        k = int(order[n % len(items)])
        item = items[k]
        s = clock()
        try:
            out = call(item)
        except Exception:  # a failed call counts and the loop goes on
            res.failed += 1
            if res.failed == 1:
                traceback.print_exc(file=sys.stderr)
            out = None
        else:
            pending.append((k, item, fence()))
        res.spans.append(("issue", s, clock()))
        if out is not None:
            if len(reservoir) < hold:
                reservoir.append((item, out))
            else:
                j = int(rng.integers(0, n + 1))
                if j < hold:
                    reservoir[j] = (item, out)
            if k == longest:
                last_longest = (item, out)
        n += 1
        while len(pending) >= in_flight:
            retire()
    while pending:
        retire()
    res.issued = n
    res.held = reservoir + ([last_longest] if last_longest is not None else [])
    return res
