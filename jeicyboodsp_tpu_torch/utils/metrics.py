"""Fidelity metric shared by the port's tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np


def snr_db(ref, test) -> float:
    """SNR of `test` against `ref` in dB (the BASELINE fidelity metric)."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    p_err = float(np.sum((ref - test) ** 2))
    if p_err == 0:
        return float("inf")
    return 10.0 * np.log10(float(np.sum(ref**2)) / p_err)
