"""BENCHMARK.json against the benchmark's rules, every cell's files found by
name, the imports of the harness and the reference, and a run with no card
(CPU).  Run: ``python -m pytest portbench -q``."""

from __future__ import annotations

import ast
import glob
import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.systems import entry

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    n = 24  # the most cells a later check may hold
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and c["source"].startswith("https://") and c["reduced"] == []
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.add(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    """Each cell's configuration, traffic, system, driver, entries and
    per-layer readers are found by name, and it reports setup_s, another
    end-to-end metric and a per-layer metric."""
    cell = harness.Cell(name)
    importlib.import_module(f"portbench.systems.{cell.config['system']}")
    importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    for path in cell.config["paths"].values():
        assert callable(entry(path["entry"]))
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.per_layer()
    assert layer and all(callable(harness.reader(m["name"])) for m in layer)
    assert set(cell.limits()) and all(v["rule"] in ("<=", ">=") for v in cell.limits().values())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_nothing_forbidden():
    """No file of the benchmark imports JAX, Flax, the JAX package or the
    old benchmark (top-level names compared whole); the reference imports
    nothing of the program either."""
    for path in glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)
        if os.sep + "reference" + os.sep in path:
            assert "jeicyboodsp_tpu_torch" not in tops, path


def test_loaded_modules_after_a_run():
    """A whole run on the CPU at a tiny size loads no forbidden module, and
    the reference alone loads nothing of the program."""
    code = (
        "import sys, copy\n"
        "import portbench.reference.enhance, portbench.reference.nlms\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'jeicyboodsp_tpu_torch']\n"
        "from portbench import harness\n"
        "cell = harness.Cell('wiener16k.live')\n"
        "tr = dict(cell.traffic, streams=2)\n"
        "res, checks, _ = harness.run_cell(cell, 5, 0.5, device='cpu', traffic=tr)\n"
        "assert res['correct'], checks\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_fails():
    """The command on a machine with no card exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nlms256.calls",
                          "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr
