"""The port's linear GEQ scan (``ops.geq.geq_apply_fast``, ``_biquad_linear``)
against the JAX op (tests/test_sharded.py's tolerances), and the scan that
runs it (``utils.scan.associative_scan``) against ``jax.lax.associative_scan``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.ops import geq as JG
from jeicyboodsp_tpu_torch.ops import geq as TG
from jeicyboodsp_tpu_torch.utils.scan import associative_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 3000, shape), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("n", [1, 2, 3, 37, 512 * 16])
def test_geq_apply_fast_f64_against_jax(n):
    """f64 at rtol 1e-7, atol 1e-5 (tests/test_sharded.py:212-224)."""
    x = _x(n, n)
    b, a = JG.geq_coefficients()
    want = np.asarray(JG.geq_apply_fast(jnp.asarray(x), b, a, dtype=jnp.float64))
    got = TG.geq_apply_fast(torch.from_numpy(x), b, a, dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-5)


JAX_F32 = r"""
import sys
import numpy as np
import jax.numpy as jnp
from jeicyboodsp_tpu.ops import geq as G
b, a = G.geq_coefficients()
np.save(sys.argv[2], np.asarray(G.geq_apply_fast(jnp.asarray(np.load(sys.argv[1])), b, a,
                                                 dtype=jnp.float32)))
"""


def test_geq_apply_fast_f32_against_jax(tmp_path):
    """The f32 default at rtol 1e-5, atol 1e-3 where finite, with equal
    non-finite masks (the 44 Hz shelf's near-unity pole overflows f32 on
    long signals, on JAX's path too).  JAX runs in a subprocess with
    XLA_FLAGS=--xla_cpu_max_isa=AVX: on an FMA host XLA:CPU contracts the
    2x2 products the port rounds apart (ROADMAP R11); there the two are
    also bit-equal, which is printed."""
    x = np.concatenate([_x((3, 4096), 5), np.full((1, 4096), 32767, np.int16)])
    src, dst = tmp_path / "x.npy", tmp_path / "y.npy"
    np.save(src, x)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_cpu_max_isa=AVX",
           "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, "-c", JAX_F32, str(src), str(dst)], env=env, check=True,
                   capture_output=True, timeout=300)
    want = np.load(dst)
    b, a = JG.geq_coefficients()
    got = TG.geq_apply_fast(torch.from_numpy(x), b, a).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-3)
    print(f"geq_apply_fast f32: {np.mean(got[fin] == want[fin]):.4f} of the finite samples "
          f"bit-equal to JAX's, {int((~fin).sum())} non-finite")


def test_biquad_linear_is_the_recursion():
    """One band's scan equals the direct recursion y = b0 x + b1 x1 + b2 x2 -
    a1 y1 - a2 y2 in f64 (to rounding)."""
    x = _x(300, 2).astype(np.float64)
    b, a = JG.geq_coefficients()
    k = 3
    got = TG._biquad_linear(torch.from_numpy(x), *(torch.tensor(v, dtype=torch.float64) for v in
                                                   (b[k, 0], b[k, 1], b[k, 2], a[k, 1], a[k, 2])))
    y, x1, x2, y1, y2 = [], 0.0, 0.0, 0.0, 0.0
    for v in x:
        o = b[k, 0] * v + b[k, 1] * x1 + b[k, 2] * x2 - a[k, 1] * y1 - a[k, 2] * y2
        x2, x1, y2, y1 = x1, v, y1, o
        y.append(o)
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33, 100])
def test_associative_scan_groups_as_jax(n):
    """Sums and 2x2 affine compositions, bit-equal to jax.lax.associative_scan."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3))
    got = associative_scan(lambda l, r: (l[0] + r[0],), (torch.from_numpy(x),))[0]
    assert got.numpy().tobytes() == np.asarray(jax.lax.associative_scan(jnp.add,
                                                                        jnp.asarray(x))).tobytes()
    A = rng.normal(size=(n, 2, 2))

    def jc(l, r):
        return (jnp.einsum("nij,njk->nik", r[0], l[0]),)

    want = np.asarray(jax.lax.associative_scan(jc, (jnp.asarray(A),))[0])
    got = associative_scan(lambda l, r: (torch.matmul(r[0], l[0]),), (torch.from_numpy(A),))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
