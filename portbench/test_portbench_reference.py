"""The frozen reference against the port's float64 oracles, the frozen work
counts against the port's rooflines, and the controls failing their limits
(CPU, small sizes).  Run: ``python -m pytest portbench -q``."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.oracle import enhance as oracle_enhance
from jeicyboodsp_tpu_torch.oracle import nlms as oracle_nlms
from jeicyboodsp_tpu_torch.oracle.cnum import stale_blocks
from jeicyboodsp_tpu_torch.utils import profiling
from portbench import harness
from portbench.reference import nlms as ref_nlms
from portbench.reference.enhance import reference_enhance_rows

HERE = os.path.dirname(os.path.abspath(__file__))


def _gated(n, seed, gate_hz=0.5, amp=5000, sd=20):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = amp * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * gate_hz * t) > 0.2)
    return np.clip(x + rng.normal(0, sd, n), -32768, 32767).astype(np.int16)


def _echo(S, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3000, (S, N)).clip(-32768, 32767).round().astype(np.int16)
    r = 0.5 * x + rng.normal(0, 50, (S, N))
    r[-1] += rng.normal(0, 2000, N)  # double talk
    return x, r.clip(-32768, 32767).astype(np.int16)


@pytest.mark.parametrize("mode", ["wiener", "specsub"])
@pytest.mark.parametrize("gate_hz,rows", [(0.5, 64), (4.0, 100), (8.0, 4096)])
def test_enhance_reference_equals_oracle(mode, gate_hz, rows):
    """In float64 the frozen chain writes the oracle's samples, in blocks of
    rows or whole."""
    x = _gated(512 * 500, 3, gate_hz)
    want = oracle_enhance.reference_enhance(x, mode)
    got = reference_enhance_rows(torch.from_numpy(stale_blocks(x, 512).copy()), mode, rows=rows)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


def test_nlms_sessions_equal_oracle():
    """The streams at once equal the oracle stream by stream: est and err,
    and the coefficients equal the frozen per-stream copy's, bit for bit."""
    x, r = _echo(3, 3 * 1024, 5)
    est, err, snaps, hist = ref_nlms.nlms_sessions(x, r, marks=[1024, 3072])
    for s in range(3):
        xb, rb = x[s].reshape(-1, 1024), r[s].reshape(-1, 1024)
        oe, oerr = oracle_nlms.reference_nlms_blocks(xb, rb)
        fe, ferr, fc = ref_nlms.reference_nlms_blocks(xb, rb)
        np.testing.assert_array_equal(est[s], oe.reshape(-1))
        np.testing.assert_array_equal(err[s], oerr.reshape(-1))
        np.testing.assert_array_equal(fe, oe)
        np.testing.assert_array_equal(ferr, oerr)
        assert snaps[1][s].tobytes() == fc.tobytes()
        _, _, c1 = ref_nlms.reference_nlms_blocks(xb[:1], rb[:1])
        assert snaps[0][s].tobytes() == c1.tobytes()
        np.testing.assert_array_equal(hist[s], x[s, -255:])


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_frozen_counts():
    """2,048 bytes and 64,015 operations a Wiener block, 1,796 operations and
    8 bytes an NLMS sample: the port's rooflines' counts, frozen."""
    w, n = _load("roofline_pct.wiener"), _load("roofline_pct.nlms")
    assert w.BYTES_PER_BLOCK == 2048
    chain = profiling.enhance_chain_roofline()
    assert (chain.flops_per_block, chain.hbm_bytes_per_block) == (w.OPS_PER_BLOCK, 2048)
    assert n.OPS_PER_SAMPLE == 1796 == profiling.nlms_roofline().flops_per_block
    assert n.BYTES_PER_SAMPLE == profiling.nlms_roofline().hbm_bytes_per_block == 8
    assert w.least_s(512e9) == pytest.approx(1e9 * 2048 / 3.35e12)  # bytes bound: 0.611 ns a block
    assert n.least_s(1e12) == pytest.approx(1e12 * 1796 / 34e12)  # operations: 52.8 ps a sample


def test_enhance_controls_fail():
    """The reference in the precision below each path's fails that path's
    limits: bfloat16 for the float32 engine (offline), float32 for the
    float64 compat session (live)."""
    cell = harness.Cell.unlisted("wiener16k", "files")
    lim = cell.config["checks"]
    x = torch.from_numpy(stale_blocks(_gated(512 * 1200, 7, 2.0), 512).copy())
    ref = reference_enhance_rows(x).to(torch.int64)
    bf = reference_enhance_rows(x, precision="bfloat16").to(torch.int64)
    snr = 10 * np.log10(float((ref ** 2).sum()) / float(((ref - bf) ** 2).sum()))
    assert snr < lim["offline"]["snr_db_min"]["limit"]
    assert int((ref - bf).abs().max()) > lim["offline"]["max_abs_lsb"]["limit"]
    f32 = reference_enhance_rows(x, precision="float32").to(torch.int64)
    ppm = 1e6 * float(((ref - f32) != 0).sum()) / ref.numel()
    assert ppm > lim["live"]["differing_ppm"]["limit"]


def test_nlms_control_fails():
    """float32 in place of float64 changes the coefficients handed back."""
    x, r = _echo(2, 4096, 9)
    _, _, (c64,), _ = ref_nlms.nlms_sessions(x, r, marks=[4096])
    _, _, (c32,), _ = ref_nlms.nlms_sessions(x, r, np.float32, marks=[4096])
    assert int((c32.astype(np.float64) != c64).sum()) > 0
