"""``jeicyboodsp_tpu_torch.utils.gpu_checks`` against the JAX package's
``utils/tpu_checks.py``: the same keys, the same probes, and each
enhancement engine no worse than JAX's kernels (run in interpret mode, as
tests/test_engine_matrix.py runs them) on the same probe less 1 dB.
``run_checks("cpu")`` runs the kernels' plain versions; on a card it is
tests/test_torch_cuda.py's."""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from jeicyboodsp_tpu.oracle import enhance as oenh
from jeicyboodsp_tpu.utils import tpu_checks
from jeicyboodsp_tpu.utils.metrics import snr_db
from jeicyboodsp_tpu_torch.utils import gpu_checks

ENGINE_SLACK_DB = 1.0


def _jax_keys():
    """The keys JAX's run_checks writes, read from its source."""
    tree = ast.parse(inspect.getsource(tpu_checks))
    return {n.slice.value for n in ast.walk(tree)
            if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
            and n.value.id == "results" and isinstance(n.slice, ast.Constant)}


CPU_LAUNCHES = {}  # filled by the run of the fixture below


@pytest.fixture(scope="module")
def checks():
    return gpu_checks.run_checks("cpu", CPU_LAUNCHES)


def test_cpu_run_reports_no_launch(checks):
    """On the CPU every wrapper takes its plain version: the launches the
    call reports name each kernel, all at 0."""
    assert set(CPU_LAUNCHES) == set(gpu_checks.WRAPPERS)
    assert not any(CPU_LAUNCHES.values()), CPU_LAUNCHES


def test_keys_are_jax_s_and_all_ok(checks):
    keys = _jax_keys()
    assert "all_ok" in keys and len(keys) > 20
    assert set(checks) == keys
    assert checks["all_ok"] is True, checks
    assert all(isinstance(v, bool) for k, v in checks.items() if not k.endswith("_db"))


def _jax_probes(monkeypatch):
    """Run JAX's run_checks with its device calls replaced by stubs that
    record their inputs, the oracles as they are: the probes as JAX draws
    them."""
    from jeicyboodsp_tpu.kernels import nlms_pallas
    from jeicyboodsp_tpu.ops import enhance, fastconv, features, geq, mvdr

    seen = {}

    def quant(x):
        seen["stress"] = np.asarray(x)
        return np.zeros_like(x)

    def nlms(x, ref):
        seen["x"], seen["ref"] = np.asarray(x)[0], np.asarray(ref)[0]
        return np.zeros(np.shape(x), np.int16), None

    def bnlms(x, ref):
        return np.zeros(np.shape(x), np.int16), None

    def blocks(b, **kw):
        seen["probe"] = np.asarray(b).reshape(-1)
        return np.zeros(np.shape(b), np.int16), np.arange(len(b)) >= 2

    def stream(xl, xr, **kw):
        seen["xl"], seen["xr"] = xl, xr
        return np.zeros(len(xl) - 512, np.int16)

    def gemm8(b, terms):
        seen["xfc"] = np.asarray(b).reshape(-1)
        return np.zeros((len(b) - 7, 1024), np.int16)

    def pitch(x, **kw):
        seen["xp"] = x
        return np.zeros(len(x) // 512, np.int64), None, None

    for mod, name, fn in ((geq, "run_pallas_quant", quant), (nlms_pallas, "nlms_pallas", nlms),
                          (nlms_pallas, "bnlms_pallas", bnlms), (enhance, "enhance_blocks", blocks),
                          (mvdr, "run_stream", stream),
                          (fastconv, "fastconv_blocks_gemm_int8", gemm8),
                          (features, "pitch_run", pitch)):
        monkeypatch.setattr(mod, name, fn)
    tpu_checks.run_checks()
    return seen


def test_probes_are_jax_s_draws(monkeypatch):
    want = _jax_probes(monkeypatch)
    got = gpu_checks.probes()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int16 and got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def jax_engine_db():
    """JAX's four fused engines on the probe, its Pallas kernels in interpret
    mode (tests/test_engine_matrix.py's arguments), against the f64 oracle."""
    from jeicyboodsp_tpu.ops import enhance as E

    probe = gpu_checks.probes()["probe"]
    want = oenh.run(probe, "wiener")
    b = jnp.asarray(probe.reshape(-1, 512))
    runs = {
        "mxu3": lambda: E._enhance_fused3(b, "wiener", False, interpret=True, F=8),
        "mxu8": lambda: E._enhance_fused3(b, "wiener", False, interpret=True, F=8, int8=True),
        "mxu8f": lambda: E._enhance_fused_full(b, "wiener", False, interpret=True, F=8, L=4),
        "mxu8t": lambda: E._enhance_fused_full(b, "wiener", False, interpret=True, F=8, L=4,
                                               hq=False),
    }
    out = {}
    for engine, run in runs.items():
        got, mask = run()
        out[engine] = snr_db(want, np.asarray(got)[np.asarray(mask)].reshape(-1))
    return out


@pytest.mark.parametrize("engine", ["mxu3", "mxu8", "mxu8f", "mxu8t"])
def test_engine_no_worse_than_jax_s_kernels(checks, jax_engine_db, engine):
    got = checks[f"enhance_{engine}_snr_db"]
    print(f"{engine}: port {got} dB, JAX (interpret) {jax_engine_db[engine]:.2f} dB")
    assert got >= jax_engine_db[engine] - ENGINE_SLACK_DB


def test_mxu1_between_40_and_the_bar(checks):
    """The one-pass bf16 tier lands below the 60 dB bar, as the JAX package
    records it (typ 52), and well above noise."""
    assert 40.0 <= checks["enhance_mxu1_snr_db"] < gpu_checks.COMPAT_BAR_DB
    assert checks["mxu1_below_bar"] is True


def test_cuda_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the checks there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu_checks.run_checks()
