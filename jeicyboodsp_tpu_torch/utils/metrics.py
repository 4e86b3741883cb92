"""Metrics registry and the fidelity metric (counterpart of
``jeicyboodsp_tpu/utils/metrics.py``).

:class:`Metrics` collects named counters, gauges and host-clock timers into
one JSON report; :data:`REGISTRY` is the process-wide instance.
:func:`snr_db` is the SNR shared by the port's tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


class Metrics:
    def __init__(self):
        self.counters = defaultdict(float)
        self.gauges = {}
        self.timings = defaultdict(list)

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


REGISTRY = Metrics()


def snr_db(ref, test) -> float:
    """SNR of `test` against `ref` in dB (the BASELINE fidelity metric)."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    p_err = float(np.sum((ref - test) ** 2))
    if p_err == 0:
        return float("inf")
    return 10.0 * np.log10(float(np.sum(ref**2)) / p_err)
