"""Metrics registry, program spans and the fidelity metric (counterpart of
``jeicyboodsp_tpu/utils/metrics.py``).

:class:`Metrics` collects named counters, gauges and host-clock timers into
one JSON report; :data:`REGISTRY` is the process-wide instance.
:func:`snr_db` is the SNR the port's tests share.

The port also records **spans** in :data:`REGISTRY`: named, nested host
intervals of the session and op layers (:meth:`Metrics.span`), each of one
kind:

- ``stage``: a piece of an op, or a whole call;
- ``copy``: a blocking transfer between the host and the card;
- ``wait``: the host blocked until the card has done queued work.

Spans are recorded while the registry is enabled (:meth:`Metrics.recording`)
or while a ``torch.profiler`` records, so that a profiled window carries them
as ``torch.profiler.record_function`` ranges are carried, and kept in memory
until taken (:meth:`Metrics.take_spans`), at most :data:`MAX_SPANS` of them:
past that the program runs as when nothing records, so that a profiler left
running cannot grow the list without end.  Otherwise a site costs one test
of two flags: no clock is read, nothing is allocated, nothing waits.  Times
are ``time.perf_counter_ns()``; ``+ clock_offset_ns()`` puts them on the
profiler's clock (Unix nanoseconds).  Spans nest per thread.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

KINDS = ("stage", "copy", "wait")
MAX_SPANS = 1_000_000  # spans kept untaken (about 100 MB)
DRAIN = ".drain"  # the name's end of each wait that recording adds (Metrics.drain)
_OFF = nullcontext()


class _Stack(threading.local):
    """Each thread's open spans (indices into the list), innermost last."""

    def __init__(self):
        self.stack = []


class Span(NamedTuple):
    """One recorded span: ``name``, ``kind``, ``start_ns`` and ``end_ns``
    (``perf_counter_ns``; None while it runs), ``parent`` (the index of the
    enclosing span in the list it was taken with, -1 for a root) and
    ``request`` (its root's request id).  The registry keeps an ended span
    as a plain tuple of these, which the garbage collector stops tracking,
    so that a traced window's many spans add nothing to its collections."""

    name: str
    kind: str
    start_ns: int
    end_ns: int | None
    parent: int
    request: tuple | None

    def as_dict(self, offset_ns=0):
        return {"name": self.name, "kind": self.kind, "start_ns": self.start_ns + offset_ns,
                "end_ns": self.end_ns + offset_ns, "parent": self.parent,
                "request": list(self.request) if isinstance(self.request, tuple)
                else self.request}


class _Open:
    """A span being recorded: the context manager, and its place in the
    list until it ends as a tuple of :class:`Span`'s fields."""

    __slots__ = ("_m", "_i", "name", "kind", "start_ns", "parent", "request")

    def __init__(self, m, name, kind, request=None):
        self._m, self.name, self.kind, self.request = m, name, kind, request

    def __enter__(self):
        m = self._m
        stack, spans = m._local.stack, m._spans
        self.parent = stack[-1] if stack else -1
        if self.parent >= 0:
            self.request = spans[self.parent].request
        self._i = len(spans)
        stack.append(self._i)
        spans.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        m = self._m
        m._local.stack.pop()
        m._spans[self._i] = (self.name, self.kind, self.start_ns, end, self.parent, self.request)
        return False

    def as_span(self, parent):
        return Span(self.name, self.kind, self.start_ns, None, parent, self.request)


class Metrics:
    def __init__(self):
        self.counters = defaultdict(float)
        self.gauges = {}
        self.timings = defaultdict(list)
        self.enabled = False  # spans are recorded while True (or a torch.profiler records)
        self._spans = []
        self._local = _Stack()

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    @contextmanager
    def timer(self, name: str):
        """Times the block on the host clock; a caller timing device work
        synchronizes inside it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def report(self) -> dict:
        out = {"counters": dict(self.counters), "gauges": dict(self.gauges)}
        out["timings"] = {
            k: {"n": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
            for k, v in self.timings.items()
            if v
        }
        return out

    def dump(self, path: str | None = None) -> str:
        s = json.dumps(self.report(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    # ------------------------------------------------------------ spans

    def span(self, name: str, kind: str = "stage", serial=None, seq=None):
        """A context manager that records the block as a span of ``kind``
        (one of :data:`KINDS`) while spans are recorded, and does nothing
        otherwise.  A root span's request id is ``(serial, seq)`` (a
        session's serial and its chunk number; None without them); a child
        takes its root's."""
        if not (self.enabled or _profiler._is_profiler_enabled) or len(self._spans) >= MAX_SPANS:
            return _OFF
        return _Open(self, name, kind, None if serial is None else (serial, seq))

    def drain(self, name: str, device) -> None:
        """While spans are recorded, wait for the work queued on a CUDA
        ``device``'s current stream inside a ``wait`` span, so that a
        blocking copy after it holds the transfer alone; otherwise nothing.
        Such a wait is recording's, not the program's: its ``name`` ends in
        :data:`DRAIN`, so that a count of the program's blocking points can
        leave it out."""
        if (not (self.enabled or _profiler._is_profiler_enabled) or device.type != "cuda"
                or len(self._spans) >= MAX_SPANS):
            return
        if not name.endswith(DRAIN):
            raise ValueError(f"a drain's name ends in {DRAIN!r}: {name!r}")
        with _Open(self, name, "wait"):
            torch.cuda.current_stream(device).synchronize()

    @contextmanager
    def recording(self):
        """Record spans inside the block (whatever records them outside it)."""
        was, self.enabled = self.enabled, True
        try:
            yield self
        finally:
            self.enabled = was

    def spans(self) -> list[Span]:
        """The spans recorded since they were last taken, in start order."""
        return _as_spans(self._spans, 0)

    def take_spans(self, since: int = 0) -> list[Span]:
        """The spans recorded since they were last taken, from the
        ``since``-th on, removed from the list; their parents count from
        ``since`` (-1 for a parent before it).  Call it with none of them
        open."""
        out = _as_spans(self._spans[since:], since)
        del self._spans[since:]
        return out


def _as_spans(kept, since):
    """The registry's entries as :class:`Span`, parents counted from ``since``."""
    out = []
    for s in kept:
        p = s.parent if type(s) is _Open else s[4]
        p = p - since if p >= since else -1
        out.append(s.as_span(p) if type(s) is _Open else Span(*s[:4], p, s[5]))
    return out


REGISTRY = Metrics()


def clock_offset_ns() -> int:
    """Nanoseconds to add to a ``perf_counter_ns`` time to put it on the
    profiler's clock (``time.time_ns``), read as the harness reads it: the
    two clocks side by side."""
    return time.time_ns() - time.perf_counter_ns()


def snr_db(ref, test) -> float:
    """SNR of `test` against `ref` in dB (the BASELINE fidelity metric)."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    p_err = float(np.sum((ref - test) ** 2))
    if p_err == 0:
        return float("inf")
    return 10.0 * np.log10(float(np.sum(ref**2)) / p_err)
