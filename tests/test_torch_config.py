"""The port's copies of the JAX package's jax-free ``config`` and metrics
registry: ``jeicyboodsp_tpu_torch.config`` and
``jeicyboodsp_tpu_torch.utils.metrics.Metrics`` / ``REGISTRY`` against
``jeicyboodsp_tpu.config`` and ``jeicyboodsp_tpu.utils.metrics``, and the
floors the port's tests read from the copy."""

import dataclasses
import json

import pytest

from jeicyboodsp_tpu import config as JC
from jeicyboodsp_tpu.utils import metrics as JM
from jeicyboodsp_tpu_torch import config as TC
from jeicyboodsp_tpu_torch.utils import metrics as TM

CONFIGS = ("GEQConfig", "FastConvConfig", "EnhanceConfig", "AECConfig", "MVDRConfig",
           "SpeechConfig")


def test_engine_keys_are_jax_s():
    assert set(TC.ENGINE_FIDELITY) == set(JC.ENGINE_FIDELITY)


@pytest.mark.parametrize("key", sorted(JC.ENGINE_FIDELITY), ids="/".join)
def test_engine_floor_and_typ_equal(key):
    want, got = JC.ENGINE_FIDELITY[key], TC.ENGINE_FIDELITY[key]
    assert set(got) == set(want) == {"floor", "typ", "note"}
    assert (got["floor"], got["typ"]) == (want["floor"], want["typ"])
    for word in ("TPU", "VPU", "Pallas", "~"):  # the port's notes name no TPU part or rate
        assert word not in got["note"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_equal(name):
    want, got = getattr(JC, name), getattr(TC, name)
    assert dataclasses.is_dataclass(got)
    fields = [(f.name, f.type) for f in dataclasses.fields(got)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


def _drive(m):
    m.count("frames")
    m.count("frames", 3.5)
    m.count("calls", 2)
    m.gauge("snr_db", 91.25)
    m.gauge("snr_db", 92)
    m.gauge("blocks", 16384)
    for name in ("enhance", "enhance", "geq"):
        with m.timer(name):
            pass
    with pytest.raises(RuntimeError):
        with m.timer("failed"):  # a block that raises is timed all the same
            raise RuntimeError
    return m.report()


def test_metrics_report_equal_to_jax_s():
    want, got = _drive(JM.Metrics()), _drive(TM.Metrics())
    assert got["counters"] == want["counters"] and got["gauges"] == want["gauges"]
    assert {k: v["n"] for k, v in got["timings"].items()} == {
        k: v["n"] for k, v in want["timings"].items()} == {"enhance": 2, "geq": 1, "failed": 1}
    for v in got["timings"].values():
        assert set(v) == {"n", "total_s", "mean_s"} and v["mean_s"] == v["total_s"] / v["n"]


def test_metrics_dump_and_registry(tmp_path):
    m = TM.Metrics()
    m.count("x")
    path = tmp_path / "m.json"
    s = m.dump(str(path))
    assert path.read_text() == s and json.loads(s) == m.report()
    assert json.loads(s) == json.loads(JM.Metrics().dump()) | {"counters": {"x": 1.0}}
    assert isinstance(TM.REGISTRY, TM.Metrics) and TM.REGISTRY is not JM.REGISTRY


def test_card_and_cpu_tests_read_the_floors_from_the_copy():
    import test_torch_cuda
    import test_torch_fused3

    assert test_torch_cuda.FIDELITY == {e: JC.ENGINE_FIDELITY["enhance", e]["floor"]
                                        for e in ("mxu8f", "mxu8t", "mxu8", "mxu3")}
    assert test_torch_cuda.MFCC_PIPE_DB == JC.ENGINE_FIDELITY["mfcc", "mxu3"]["floor"]
    assert test_torch_fused3.FLOOR == {e: JC.ENGINE_FIDELITY["enhance", e]["floor"]
                                       for e in ("mxu8", "mxu3")}
