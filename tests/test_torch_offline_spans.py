"""The port's spans on the offline route (``ops.enhance.enhance_blocks``):
one ``enhance.blocks`` root a call, and on the ``mxu8f``/``mxu8t`` route
(K14, the latch row pack, K1) its stages ``enhance.flags``,
``enhance.rowpack`` and ``enhance.full8``, with no ``copy`` or ``wait``:
the route reads nothing back from the card.  The benchmark's
``issue_ms.files`` reads these trees.  Imports neither jax nor the JAX
package, so it runs on a card's host too:

    python -m pytest --noconftest -q -s tests/test_torch_offline_spans.py

The card tests (skipped without CUDA) hold that no synchronising call runs
inside an offline call, and print what its disabled sites cost (``-s``).
"""

import subprocess
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.utils import metrics as M
from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY
from portbench import harness

FULL_TREE = [  # (name, kind, parent's name)
    ("enhance.blocks", "stage", None),
    ("enhance.flags", "stage", "enhance.blocks"),
    ("enhance.rowpack", "stage", "enhance.blocks"),
    ("enhance.full8", "stage", "enhance.blocks"),
]
FUSED = ("mxu8f", "mxu8t")


def _blocks(T, seed=3, device="cpu"):
    t = np.arange(T * 512)
    rng = np.random.default_rng(seed)
    x = 3000 * np.sin(2 * np.pi * 300 * t / 16000) * (np.sin(2 * np.pi * t / 8000) > 0.2)
    x = np.clip(np.round(x + rng.normal(0, 20, x.size)), -32768, 32767).astype(np.int16)
    return torch.from_numpy(x.reshape(T, 512)).to(device)


def _call(blocks, engine="mxu8f"):
    if engine == "xla":
        return E.enhance_blocks(blocks, "wiener")
    return E.enhance_blocks(blocks, "wiener", torch.float32, real_fft=True, resynth="ratio",
                            fft_engine=engine)


def _shape(spans):
    return [(s.name, s.kind, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


@pytest.fixture(autouse=True)
def _clean_registry():
    REGISTRY.take_spans()
    yield
    REGISTRY.take_spans()


@pytest.mark.parametrize("engine", FUSED)
def test_off_records_nothing_and_reads_no_clock(engine, monkeypatch):
    blocks = _blocks(72)
    monkeypatch.setattr(M, "time", SimpleNamespace())  # any clock read raises
    assert not REGISTRY.enabled
    _call(blocks, engine)
    assert REGISTRY.spans() == []


@pytest.mark.parametrize("engine", FUSED)
def test_on_records_one_tree_a_call_and_leaves_outputs_bit_equal(engine):
    blocks = [_blocks(T, seed=T) for T in (72, 130, 64)]
    want = [_call(b, engine) for b in blocks]
    with REGISTRY.recording():
        got = [_call(b, engine) for b in blocks]
    assert not REGISTRY.enabled
    assert all(torch.equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    spans = REGISTRY.spans()
    assert _shape(spans) == FULL_TREE * len(blocks)
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns and s.request is None
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns  # inside its parent
    kids = [s for s in spans if s.parent >= 0]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))  # one after another


@pytest.mark.parametrize("engine", ["mxu8", "mxu3", "mxu", "xla"])
def test_every_route_is_one_enhance_blocks_root(engine):
    with REGISTRY.recording():
        _call(_blocks(72), engine)
    roots = [s for s in REGISTRY.spans() if s.parent < 0]
    assert [s.name for s in roots] == ["enhance.blocks"]
    assert not {s.name for s in REGISTRY.spans()} & {n for n, _, _ in FULL_TREE[1:]}


def test_issue_ms_files_reads_the_recorded_calls():
    """``issue_ms.files``: the mean ``enhance.blocks`` span less its copy and
    wait spans (none here: all of it), in ms; None where nothing recorded."""
    read = harness.reader("issue_ms.files")
    assert read(harness.Reading(None, calls=2)) is None
    with REGISTRY.recording():
        for T in (72, 130):
            _call(_blocks(T, seed=T))
    spans = REGISTRY.spans()
    roots = [s for s in spans if s.parent < 0]
    got = read(harness.Reading(None, calls=2))
    want = sum(s.end_ns - s.start_ns for s in roots) / 1e6 / 2
    assert got == pytest.approx(want, rel=1e-12) and got > 0
    assert read(harness.Reading(None, calls=1)) == pytest.approx(
        (roots[-1].end_ns - roots[-1].start_ns) / 1e6, rel=1e-12)  # the latest call
    REGISTRY.take_spans()
    assert read(harness.Reading(None, calls=2)) is None


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flagged syncs and the sites' cost are the card's")
    return torch.device("cuda")


def _card(dev):
    """The card's name and power limit, as every printed number carries them."""
    try:
        rows = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        rows = []
    return rows[dev.index or 0] if len(rows) > (dev.index or 0) else torch.cuda.get_device_name(dev)


@pytest.mark.parametrize("engine", FUSED)
def test_card_no_sync_inside_an_offline_call(cuda, engine):
    blocks = _blocks(4096, device=cuda)
    _call(blocks, engine)  # build and warm up
    torch.cuda.synchronize(cuda)
    flagged = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            flagged.append(time.perf_counter_ns())

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with REGISTRY.recording():
                for _ in range(5):
                    _call(blocks, engine)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    spans = REGISTRY.spans()
    assert _shape(spans) == FULL_TREE * 5
    roots = [(s.start_ns, s.end_ns) for s in spans if s.parent < 0]
    assert not [t for t in flagged if any(a <= t <= b for a, b in roots)]


SITES = 200_000


def test_card_span_costs_offline(cuda):
    """What the offline call's four disabled sites cost, printed on one line
    that names the card (run with ``-s``): a site with nothing recording
    against an ``mxu8f`` call of 2,048 blocks timed one by one (the card
    drained after each), and the recorded call's stages.  Holds the
    disabled sites under 2% of a call."""
    def span():
        with REGISTRY.span("x"):
            pass

    t0 = time.perf_counter_ns()
    for _ in range(SITES):
        span()
    site_ns = (time.perf_counter_ns() - t0) / SITES
    blocks = _blocks(2048, device=cuda)
    for _ in range(3):
        _call(blocks)
    torch.cuda.synchronize(cuda)
    off = []
    for _ in range(200):
        t0 = time.perf_counter_ns()
        _call(blocks)
        torch.cuda.synchronize(cuda)
        off.append(time.perf_counter_ns() - t0)
    with REGISTRY.recording():
        for _ in range(50):
            _call(blocks)
            torch.cuda.synchronize(cuda)
    per_name = {}
    for s in REGISTRY.take_spans():
        per_name.setdefault(s.name, []).append(s.end_ns - s.start_ns)
    call_ns = float(np.median(off))
    share = len(FULL_TREE) * site_ns / call_ns
    mean_us = {n: round(float(np.mean(v)) / 1e3, 2) for n, v in per_name.items()}
    print(f"\n[{_card(cuda)}] enhance_blocks mxu8f, 2,048 blocks: a site with nothing "
          f"recording {site_ns:.0f} ns, {len(FULL_TREE)} sites = {100 * share:.3f}% of a call's "
          f"{call_ns / 1e6:.4f} ms (drained); recorded, mean us a span {mean_us}")
    assert share < 0.02
