"""Each cell on the card for a short window: correct, with every metric of
its trace (skips without a card).  Run on a card:
``python -m pytest portbench/test_portbench_card.py -q``."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, run

CELLS = [w["name"] for w in harness.load_json(f"{harness.ROOT}/BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.cache_env()
    return "cuda"


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = harness.Cell(name)
    res, checks, _ = harness.run_cell(cell, 2 ** 31 + 404, 2.0, trace=True, device=card)
    assert res["correct"], checks
    assert {m["name"] for m in cell.per_layer()} <= set(res["metrics"])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
