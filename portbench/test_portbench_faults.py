"""Whole runs on the CPU with the timed path broken underneath: ``correct``
comes out false for each fault the cell can have (an answer altered where
it is produced, half of a batch left out, a step that returns its state
unchanged), and true with nothing broken.  The kernels' plain versions run
in place of the card's; the look for a card is skipped.
Run: ``python -m pytest portbench -q``."""

from __future__ import annotations

import pytest
import torch

from jeicyboodsp_tpu_torch.io import stream
from jeicyboodsp_tpu_torch.ops import enhance, nlms
from portbench import harness

SMALL = {
    "wiener16k.files": dict(pool=3, min_s=1.0, max_s=6.0),
    "nlms256.calls": dict(pool=2, batch=8, min_s=0.128, max_s=0.128),
    "wiener16k.live": dict(streams=3, loop_chunks=3),
    "nlms256.live": dict(streams=2, warm_chunks=1, loop_chunks=2),
}
SECONDS = {"wiener16k.files": 0.5, "nlms256.calls": 0.2, "wiener16k.live": 0.6,
           "nlms256.live": 1.4}  # about 7 chunks on a CPU: each call loops its input


PAIRS = {"wiener16k.files": ("wiener16k", "files"), "nlms256.calls": ("nlms256", "calls"),
         "wiener16k.live": ("wiener16k", "live_streams"), "nlms256.live": ("nlms256", "live_calls")}


def _cell(name):
    """The configuration under its mix, whether the spec lists the pair or
    keeps it out for now (PERF.md, Open questions)."""
    return harness.Cell.unlisted(*PAIRS[name])


def _run(name):
    cell = _cell(name)
    res, checks, _ = harness.run_cell(cell, 2 ** 31 + 77, SECONDS[name], device="cpu",
                                      traffic=dict(cell.traffic, **SMALL[name]))
    return res, checks


def _altered_blocks(fn):
    def broken(blocks, *a, **k):
        out, mask = fn(blocks, *a, **k)
        out = out.clone()
        out[out.shape[0] // 2, 7] += 1000
        return out, mask
    return broken


def _half_blocks(fn):
    def broken(blocks, *a, **k):
        out, mask = fn(blocks, *a, **k)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, mask
    return broken


def _identity_blocks(fn):
    def broken(blocks, *a, **k):
        out, mask = fn(blocks, *a, **k)
        return blocks.clone(), mask
    return broken


def _altered_nlms(fn):
    def broken(x, ref, state, *a, **k):
        est, err, new = fn(x, ref, state, *a, **k)
        est = est.clone()
        est.view(-1)[est.numel() // 2] += 1
        return est, err, new
    return broken


def _half_nlms(fn):
    def broken(x, ref, state, *a, **k):
        h = x.shape[0] // 2
        est, err, new = fn(x[:h].contiguous(), ref[:h].contiguous(),
                           {k_: v[:h] for k_, v in state.items()}, *a, **k)
        pad = lambda v: torch.cat([v, torch.zeros_like(v)])  # noqa: E731
        return pad(est), pad(err), {k_: pad(v) for k_, v in new.items()}
    return broken


def _frozen_nlms(fn):
    def broken(x, ref, state, *a, **k):
        est, err, _ = fn(x, ref, state, *a, **k)
        return est, err, state
    return broken


def _altered_session(cls):
    class Broken(cls):
        calls = 0

        def process(self, *args):
            out = super().process(*args)
            self.calls += 1
            if self.calls == 2:  # each session's second chunk
                if isinstance(out, tuple):
                    out[0][3] += 1
                else:
                    out[3] += 1000
            return out
    return Broken


def _frozen_session(cls):
    class Broken(cls):
        def process(self, *args):
            before = self.state
            out = super().process(*args)
            self.state = before
            return out
    return Broken


FAULTS = [
    ("wiener16k.files", enhance, "enhance_blocks", _altered_blocks),
    ("wiener16k.files", enhance, "enhance_blocks", _half_blocks),
    ("wiener16k.files", enhance, "enhance_blocks", _identity_blocks),
    ("nlms256.calls", nlms, "nlms_apply", _altered_nlms),
    ("nlms256.calls", nlms, "nlms_apply", _half_nlms),
    ("nlms256.calls", nlms, "nlms_apply", _frozen_nlms),
    ("wiener16k.live", stream, "EnhanceSession", _altered_session),
    ("wiener16k.live", stream, "EnhanceSession", _frozen_session),
    ("nlms256.live", stream, "AECSession", _altered_session),
    ("nlms256.live", stream, "AECSession", _frozen_session),
]


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_run_is_correct(name):
    res, checks = _run(name)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name,module,attr,fault", FAULTS,
                         ids=[f"{f[0]}-{f[3].__name__[1:]}" for f in FAULTS])
def test_broken_run_is_not_correct(monkeypatch, name, module, attr, fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    res, checks = _run(name)
    assert not res["correct"], checks
    assert res["failed"] == 0 and not all(c["ok"] for c in checks.values())  # caught by a check
