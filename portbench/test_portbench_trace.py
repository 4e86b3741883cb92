"""The traced window's reading on made-up profiler events (CPU).
Run: ``python -m pytest portbench -q``."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from portbench import devtrace


class Ev:
    def __init__(self, name, start, dur, cuda=True):
        self._n, self._s, self._d = name, start, dur
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_busy_is_the_union_inside_the_window():
    events = [Ev("k1", 100, 300), Ev("k2", 200, 300),  # overlap: busy 100-500
              Ev("Memcpy HtoD", 700, 100), Ev("Context Sync", 800, 150),  # a sync is no work
              Ev("k3", 950, 200),  # cut at the window's end
              Ev("cudaLaunchKernel", 520, 100, cuda=False)]
    tr = devtrace.read(events, (0, 1000), [("process", 500, 700)])
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx((400 + 100 + 50) * 1e-9)
    assert tr.launches == 4
    ops = dict(tr.device_ops)
    assert ops["k1"] == pytest.approx(300e-9) and ops["k3"] == pytest.approx(50e-9)
    gaps = dict(tr.idle_gaps)
    assert gaps["idle: host"] == pytest.approx(100e-9 + 150e-9)  # [0, 100) and [800, 950)
    assert gaps["process: cudaLaunchKernel"] == pytest.approx(200e-9)  # [500, 700)
