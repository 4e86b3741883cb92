"""The traced window, read from ``torch.profiler``'s device activity.

The profiler records the card's activity only (``ProfilerActivity.CUDA``:
kernels, copies and sets on the card's timeline, with the CUDA runtime
calls that launched them on the host's), so that it costs the host little.
Each idle gap is named by what the host was doing at its middle: the
harness's own span (``issue``, ``wait``, ``process``, else ``idle``) and
the runtime call running then (else ``host``: Python and the framework).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

TOP = 10


class Trace:
    """``window_s``, ``busy_s`` (the union of device activity inside the
    window), ``launches`` (device activities starting inside it),
    ``device_ops`` and ``idle_gaps`` (top ``TOP`` [name, seconds])."""

    def __init__(self, window_s, busy_s, launches, device_ops, idle_gaps):
        self.window_s, self.busy_s, self.launches = window_s, busy_s, launches
        self.device_ops, self.idle_gaps = device_ops, idle_gaps


def _kind(ev, cuda):
    """"device" for work on the card (a kernel, copy or set), "runtime" for a
    CUDA runtime or driver call on the host, "" for anything else (a
    synchronization record on the card's timeline is not work)."""
    name = ev.name()
    if ev.device_type() == cuda:
        return "" if "Sync" in name else "device"
    return "runtime" if name.startswith("cu") else ""


def _union(starts, ends):
    """Merged [start, end) intervals of sorted starts."""
    if not len(starts):
        return np.zeros(0), np.zeros(0)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    ends_m = np.maximum.reduceat(e, idx)
    return s[idx], ends_m


def _names_at(names, starts, ends, t):
    """For each time in t, the name of the latest interval started at or
    before it that still runs then (None outside every interval)."""
    if not len(starts):
        return [None] * len(t)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    j = np.searchsorted(s, t, side="right") - 1
    hit = (j >= 0) & (e[np.maximum(j, 0)] > t)
    return [names[o[k]] if h else None for k, h in zip(j, hit)]


def read(events, window_ns, spans_ns):
    """A :class:`Trace` of ``events`` (the profiler's kineto events) inside
    ``window_ns`` = (start, end), with the harness's spans
    ``[(name, start_ns, end_ns)]``."""
    from torch.autograd import DeviceType

    a, b = window_ns
    dev_s, dev_e, dev_n = [], [], []
    rt_s, rt_e, rt_n = [], [], []
    for ev in events:
        k = _kind(ev, DeviceType.CUDA)
        if k == "device":
            s = ev.start_ns()
            dev_s.append(s)
            dev_e.append(s + ev.duration_ns())
            dev_n.append(ev.name())
        elif k == "runtime":
            s = ev.start_ns()
            rt_s.append(s)
            rt_e.append(s + ev.duration_ns())
            rt_n.append(ev.name())
    dev_s, dev_e = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
    inside = (dev_s >= a) & (dev_s < b)
    launches = int(inside.sum())
    cs, ce = np.clip(dev_s, a, b), np.clip(dev_e, a, b)
    keep = ce > cs
    us, ue = _union(cs[keep], ce[keep])
    busy_ns = int((ue - us).sum())
    per_op = defaultdict(int)
    for n, s_, e_ in zip((dev_n[i] for i in np.nonzero(keep)[0]), cs[keep], ce[keep]):
        per_op[n] += int(e_ - s_)
    device_ops = sorted(([n[:160], v / 1e9] for n, v in per_op.items()), key=lambda x: -x[1])
    # idle gaps inside the window, each named by what the host was doing
    gs = np.concatenate([[a], ue])
    ge = np.concatenate([us, [b]])
    g = ge > gs
    gs, ge = gs[g], ge[g]
    mid = (gs + ge) // 2
    host = _names_at([x[0] for x in spans_ns], np.array([x[1] for x in spans_ns], np.int64),
                     np.array([x[2] for x in spans_ns], np.int64), mid)
    call = _names_at(rt_n, np.array(rt_s, np.int64), np.array(rt_e, np.int64), mid)
    per_gap = defaultdict(int)
    for h, r, d in zip(host, call, (ge - gs).tolist()):
        per_gap[f"{h or 'idle'}: {r or 'host'}"] += d
    idle_gaps = sorted(([n, v / 1e9] for n, v in per_gap.items()), key=lambda x: -x[1])
    return Trace((b - a) / 1e9, busy_ns / 1e9, launches, device_ops[:TOP], idle_gaps[:TOP])
