"""The port's sharded paths (``jeicyboodsp_tpu_torch.parallel``) in worlds of
gloo ranks on the CPU, against the port's unsharded ops and the JAX
package's sharded ops.

The ranks are separate processes: this file run as a script is the worker
(``python tests/test_torch_parallel.py RANK WORLD STORE OUTDIR``), which
imports only torch and the port, joins its world through a ``FileStore``
under the test's temporary directory, runs every path on the inputs of
:func:`_inputs` and saves what each returns.  One launch of 2 ranks and one
of 4 run every path (the 4-rank world also runs ``enhance_sharded2d`` on a
2 x 2 mesh); each process has a timeout of its own, so a hung collective
fails the test.  In the test process the JAX side runs each sharded op once
at 4 shards, on a mesh of 4 of the 8 virtual devices of tests/conftest.py,
under tests/test_sharded.py's contracts: equal where it asserts equality,
one int16 step on under 1% of the samples where it allows that, em_step at
rtol 1e-10, the GEQ at rtol 1e-7 / atol 1e-5.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
PROC_TIMEOUT = 150  # seconds a worker may take before the test fails


def _speech(n, rng, f, start):
    t = np.arange(n) / 16000
    s = 5000 * np.sin(2 * np.pi * f * t) * (t > start)
    return np.clip(s + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


@functools.lru_cache(maxsize=1)
def _inputs():
    """Every path's inputs, tests/test_sharded.py's shapes, from one seed."""
    rng = np.random.default_rng(20261017)
    d = {}
    n = 512 * 32
    t = np.arange(n) / 16000
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (((t > 0.35) & (t < 0.6)) | (t > 0.8))
    d["enh"] = np.clip(sp + rng.normal(0, 20, n), -32768, 32767).astype(np.int16).reshape(-1, 512)
    d["enh2d"] = np.stack([_speech(32 * 512, rng, 200 + 100 * b, 0.3 + 0.1 * b).reshape(32, 512)
                           for b in range(4)])
    d["fc"] = np.clip(rng.normal(0, 2000, (16, 1024)), -32768, 32767).astype(np.int16)
    far = np.clip(rng.normal(0, 2000, (8, 4, 1024)), -32768, 32767).astype(np.int16)
    d["bn_far"] = far
    near = 0.5 * far + rng.normal(0, 100, far.shape)
    d["bn_near"] = np.clip(near, -32768, 32767).astype(np.int16)
    d["nl_far"] = d["bn_far"].reshape(8, -1)[:, :1024].copy()
    d["nl_near"] = d["bn_near"].reshape(8, -1)[:, :1024].copy()
    T = 16
    far = np.clip(rng.normal(0, 3000, (T, 1024)), -32768, 32767).astype(np.int16)
    echo = 0.5 * np.roll(far.reshape(-1), 5).reshape(T, 1024)
    d["tp_far"] = far
    d["tp_near"] = np.clip(echo + rng.normal(0, 150, (T, 1024)), -32768, 32767).astype(np.int16)
    n = 512 * 16
    t = np.arange(n) / 16000
    sp = 6000 * np.sin(2 * np.pi * 400 * t) * (((t > 0.12) & (t < 0.2)) | (t > 0.3))
    for key, gain in (("mv_l", 1.0), ("mv_r", 0.8)):
        ch = np.clip(gain * sp + rng.normal(0, 15, n), -32768, 32767)
        d[key] = ch.astype(np.int16).reshape(-1, 512)
    centers = rng.normal(0, 4, (4, 12))
    d["em_frames"] = np.array([centers[i % 4] + rng.normal(0, 2.0, 12) for i in range(128)])
    d["em_mask"] = np.ones(128, bool)
    d["em_mask"][::7] = False
    d["em_alpha"] = np.full(4, 0.25)
    d["em_mean"] = d["em_frames"][np.arange(4) * 4]
    d["em_cov"] = np.stack([np.eye(12) * 4.0] * 4)
    d["geq"] = np.clip(rng.normal(0, 3000, 512 * 16), -32768, 32767).astype(np.int16)
    d["dp"] = rng.normal(0, 1000, (8, 2048)).astype(np.float32)
    return d


def _geq_ba():
    from jeicyboodsp_tpu_torch.ops.geq import geq_coefficients

    return geq_coefficients()


def _run_paths(world: int, rank: int, store: str) -> dict:
    """Every sharded path on this rank (the worker's body); numpy results."""
    from jeicyboodsp_tpu_torch.ops import fastconv as FC
    from jeicyboodsp_tpu_torch.ops import geq as G
    from jeicyboodsp_tpu_torch.parallel import mesh as M
    from jeicyboodsp_tpu_torch.parallel import sharded as S

    assert M.init_distributed(f"file://{store}", world, rank, device="cpu")
    d = _inputs()
    t = M.make_mesh((world,), ("time",))
    data = M.make_mesh((world,), ("data",))
    model = M.make_mesh((world,), ("model",))
    dt = M.make_mesh((2, world // 2), ("data", "time"))
    f64, f32 = torch.float64, torch.float32
    b, a = _geq_ba()
    Hr, Hi = FC.filter_spectrum()
    out = {}
    for mode in ("wiener", "specsub"):
        out[f"enhance_{mode}"] = S.enhance_sharded(d["enh"], t, mode=mode)
    out["enhance_f32"] = S.enhance_sharded(d["enh"], t, dtype=f32)
    out["enhance2d"] = S.enhance_sharded2d(d["enh2d"], dt, dtype=f64)
    out["fastconv"] = S.fastconv_sharded(d["fc"], Hr, Hi, t)
    out["bnlms"] = S.bnlms_sharded(d["bn_far"], d["bn_near"], data)
    out["bnlms_f32"] = S.bnlms_sharded(d["bn_far"], d["bn_near"], data, dtype=f32)
    for compat in (True, False):
        out[f"nlms_{compat}"] = S.nlms_sharded(d["nl_far"], d["nl_near"], data, compat=compat)
    out["nlms_f32"] = S.nlms_sharded(d["nl_far"], d["nl_near"], data, dtype=f32)
    out["bnlms_time"] = S.bnlms_sharded_time(d["tp_far"], d["tp_near"], t)
    out["mvdr"] = S.mvdr_sharded(d["mv_l"], d["mv_r"], t)
    out["mvdr_bins"] = S.mvdr_sharded_bins(d["mv_l"], d["mv_r"], model)
    out["em_step"] = S.em_step_sharded(d["em_frames"], d["em_mask"], d["em_alpha"],
                                       d["em_mean"], d["em_cov"], data)
    out["geq"] = (S.geq_sharded(d["geq"], b, a, t),)
    dp = S.data_parallel_sharding(data)
    for name, dty in (("dp_geq_f32", f32), ("dp_geq_f64", f64)):
        out[name] = (dp.gather(G.geq_apply_fast(dp.local(d["dp"]), b, a, dtype=dty)),)
    return {f"{k}.{i}": v.cpu().numpy() for k, vs in out.items() for i, v in enumerate(vs)}


def _worker(argv):
    rank, world, store, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    res = _run_paths(world, rank, store)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's results]} from one launch of each world."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    found = {}
    for world in WORLDS:
        work = tmp_path_factory.mktemp(f"world{world}")
        store = str(work / "store")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                                   store, str(work)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, env=env, cwd=ROOT)
                 for r in range(world)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=PROC_TIMEOUT)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"a rank of the {world}-rank world ran past {PROC_TIMEOUT} s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-3000:]}"
        found[world] = [dict(np.load(work / f"rank{r}.npz")) for r in range(world)]
    return found


PATHS = ("enhance_wiener", "enhance_specsub", "enhance_f32", "enhance2d", "fastconv", "bnlms",
         "bnlms_f32", "nlms_True", "nlms_False", "nlms_f32", "bnlms_time", "mvdr", "mvdr_bins",
         "em_step", "geq", "dp_geq_f32", "dp_geq_f64")


def _lsb_equal(want, got, frac=0.01):
    """Within one int16 step on under ``frac`` of the samples
    (tests/test_sharded.py:_assert_lsb_equal)."""
    d = np.asarray(want).astype(np.int64) - np.asarray(got).astype(np.int64)
    assert np.abs(d).max(initial=0) <= 1, np.abs(d).max()
    assert (d != 0).mean() <= frac, (d != 0).mean()
    return int((d != 0).sum())


@functools.lru_cache(maxsize=None)
def _unsharded(path):
    """The port's unsharded op on the same inputs (CPU), as tuples of numpy."""
    from jeicyboodsp_tpu_torch.models import gmm as GM
    from jeicyboodsp_tpu_torch.ops import enhance as E
    from jeicyboodsp_tpu_torch.ops import fastconv as FC
    from jeicyboodsp_tpu_torch.ops import geq as G
    from jeicyboodsp_tpu_torch.ops import mvdr as MV
    from jeicyboodsp_tpu_torch.ops import nlms as NL

    d = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _inputs().items()}
    f64, f32 = torch.float64, torch.float32
    b, a = _geq_ba()
    if path.startswith("enhance_"):
        mode, dt = (path[8:], f64) if path != "enhance_f32" else ("wiener", f32)
        res = E.enhance_blocks(d["enh"], mode=mode, dtype=dt)
    elif path == "enhance2d":
        outs = [E.enhance_blocks(d["enh2d"][i], dtype=f64) for i in range(4)]
        res = (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]))
    elif path == "fastconv":
        Hr, Hi = FC.filter_spectrum()
        res = (FC.fastconv_blocks(d["fc"], Hr, Hi),)
    elif path.startswith("bnlms") and path != "bnlms_time":
        dt = f32 if path.endswith("f32") else f64
        st = {k: v.expand(8, *v.shape).contiguous() for k, v in NL.bnlms_init_state(dt).items()}
        res = NL.bnlms_apply(d["bn_far"], d["bn_near"], st, dtype=dt)[:2]
    elif path.startswith("nlms"):
        dt = f32 if path.endswith("f32") else f64
        st = {k: v.expand(8, *v.shape).contiguous() for k, v in NL.nlms_init_state(dt).items()}
        res = NL.nlms_apply(d["nl_far"], d["nl_near"], st, dtype=dt,
                            compat=path != "nlms_False")[:2]
    elif path == "bnlms_time":
        res = NL.bnlms_apply_timeparallel(d["tp_far"], d["tp_near"])
    elif path == "mvdr":
        res = MV.mvdr_blocks(d["mv_l"], d["mv_r"])
    elif path == "mvdr_bins":
        res = MV.mvdr_blocks(d["mv_l"], d["mv_r"], dtype=f32, fft_engine="mxu3")
    elif path == "em_step":
        res = GM.em_step(d["em_frames"], d["em_mask"], d["em_alpha"], d["em_mean"], d["em_cov"])
    elif path == "geq":
        res = (G.geq_apply_fast(d["geq"], b, a, dtype=f64),)
    else:
        res = (G.geq_apply_fast(d["dp"], b, a, dtype=f32 if path.endswith("f32") else f64),)
    return tuple(r.numpy() for r in res)


def _same_contract(path, want, got):
    """tests/test_sharded.py's contract of ``path`` between two results."""
    if path in ("bnlms", "bnlms_f32", "nlms_True", "nlms_False", "nlms_f32", "dp_geq_f32",
                "dp_geq_f64"):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    elif path == "em_step":
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
    elif path == "geq":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-7, atol=1e-5)
    elif path == "fastconv":
        _lsb_equal(want[0], got[0])
    else:  # int16 outputs, with a write mask where the op returns one
        if len(want) > 1 and want[1].dtype == bool:
            np.testing.assert_array_equal(np.broadcast_to(want[1], got[1].shape), got[1])
            _lsb_equal(want[0], got[0])
        else:
            for w, g in zip(want, got):
                _lsb_equal(w, g)


def _result(runs, world, path):
    r = runs[world][0]
    return tuple(r[f"{path}.{i}"] for i in range(sum(k.startswith(path + ".") for k in r)))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_whole_result(runs, world):
    for r in range(1, world):
        assert runs[world][r].keys() == runs[world][0].keys()
        for k, v in runs[world][0].items():
            np.testing.assert_array_equal(runs[world][r][k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", PATHS)
def test_sharded_equals_unsharded(runs, path, world):
    got = _result(runs, world, path)
    want = _unsharded(path)
    if path == "fastconv":  # the op drops the warm-up rows the sharded form masks
        got = (got[0][got[1]],)
    if path == "enhance2d":
        want = (want[0], want[1])
    _same_contract(path, want, got)


def test_no_world_no_sharded_path(monkeypatch):
    """A process given no world joins none (init_distributed returns False),
    and then no mesh can be made and no sharded path runs: each raises
    rather than running on one process."""
    from jeicyboodsp_tpu_torch.parallel import mesh as M
    from jeicyboodsp_tpu_torch.parallel import sharded as S

    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_distributed() is False
    x = np.zeros((4, 1024), np.int16)
    with pytest.raises(RuntimeError):
        M.make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError):
        S.nlms_sharded(x, x, None)
    with pytest.raises(RuntimeError):
        S.enhance_sharded(np.zeros((4, 512), np.int16), None)


JAX_AVX = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jeicyboodsp_tpu.ops import geq as G
from jeicyboodsp_tpu.parallel import make_mesh
from jeicyboodsp_tpu.parallel import sharded as S
x = np.load(sys.argv[1])
b, a = G.geq_coefficients()
mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
xs = jax.device_put(jnp.asarray(x), S.data_parallel_sharding(mesh))
np.save(sys.argv[2], np.asarray(G.geq_apply_fast(xs, b, a, dtype=jnp.float32)))
"""


def _jax_dp_geq_f32(tmp_path):
    """JAX's data-parallel f32 geq_apply_fast at 4 shards, run in a process
    of its own with XLA_FLAGS=--xla_cpu_max_isa=AVX: on an FMA host XLA:CPU
    contracts the 2x2 products that the port rounds apart (ROADMAP R11)."""
    src, dst = tmp_path / "x.npy", tmp_path / "y.npy"
    np.save(src, _inputs()["dp"])
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, "-c", JAX_AVX, str(src), str(dst)], env=env, check=True,
                   timeout=PROC_TIMEOUT, capture_output=True)
    return (np.load(dst),)


def _jax_sharded(path, tmp_path):
    """JAX's sharded op of ``path`` at 4 shards (4 of the 8 virtual devices)."""
    import jax
    import jax.numpy as jnp

    from jeicyboodsp_tpu.ops import fastconv as JFC
    from jeicyboodsp_tpu.ops import geq as JG
    from jeicyboodsp_tpu.parallel import make_mesh
    from jeicyboodsp_tpu.parallel import sharded as JS

    if path == "dp_geq_f32":
        return _jax_dp_geq_f32(tmp_path)
    d = {k: jnp.asarray(v) for k, v in _inputs().items()}
    devs = jax.devices()[:4]

    def mesh(name):
        return make_mesh((4,), (name,), devices=devs)

    f64, f32 = jnp.float64, jnp.float32
    b, a = JG.geq_coefficients()
    if path.startswith("enhance_"):
        mode, dt = (path[8:], f64) if path != "enhance_f32" else ("wiener", f32)
        call = (lambda x: JS.enhance_sharded(x, mesh("time"), mode=mode, dtype=dt), d["enh"])
    elif path == "enhance2d":
        m2 = make_mesh((2, 2), ("data", "time"), devices=devs)
        call = (lambda x: JS.enhance_sharded2d(x, m2, dtype=f64), d["enh2d"])
    elif path == "fastconv":
        Hr, Hi = JFC.filter_spectrum()
        call = (lambda x: JS.fastconv_sharded(x, Hr, Hi, mesh("time")), d["fc"])
    elif path.startswith("bnlms") and path != "bnlms_time":
        dt = f32 if path.endswith("f32") else f64
        call = (lambda x, r: JS.bnlms_sharded(x, r, mesh("data"), dtype=dt), d["bn_far"],
                d["bn_near"])
    elif path.startswith("nlms"):
        dt = f32 if path.endswith("f32") else f64
        call = (lambda x, r: JS.nlms_sharded(x, r, mesh("data"), dtype=dt,
                                             compat=path != "nlms_False"),
                d["nl_far"], d["nl_near"])
    elif path == "bnlms_time":
        call = (lambda x, r: JS.bnlms_sharded_time(x, r, mesh("time"), dtype=f32), d["tp_far"],
                d["tp_near"])
    elif path == "mvdr":
        call = (lambda x, r: JS.mvdr_sharded(x, r, mesh("time")), d["mv_l"], d["mv_r"])
    elif path == "mvdr_bins":
        call = (lambda x, r: JS.mvdr_sharded_bins(x, r, mesh("model"), axis="model"), d["mv_l"],
                d["mv_r"])
    elif path == "em_step":
        call = (lambda *v: JS.em_step_sharded(*v, mesh("data")), d["em_frames"], d["em_mask"],
                d["em_alpha"], d["em_mean"], d["em_cov"])
    elif path == "geq":
        call = (lambda x: (JS.geq_sharded(x, b, a, mesh("time"), dtype=f64),), d["geq"])
    else:  # dp_geq_f64
        xs = jax.device_put(d["dp"], JS.data_parallel_sharding(mesh("data")))
        call = (lambda x: (JG.geq_apply_fast(x, b, a, dtype=f64),), xs)
    res = jax.jit(call[0])(*call[1:])  # one program: shard_map run eagerly dispatches op by op
    return tuple(np.asarray(r) for r in res)


def _snr(ref, test):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    return np.inf if not (err ** 2).sum() else 10 * np.log10((ref ** 2).sum() / (err ** 2).sum())


@pytest.mark.parametrize("path", PATHS)
def test_sharded_equals_jax_sharded(runs, path, tmp_path):
    """The port at 4 ranks against JAX's sharded op at 4 shards.  The f32
    echo cancellers are two arithmetics (the port's exact energies and gate
    against JAX's f32 ones): held to tests/test_nlms.py's floors, 60 dB on
    the estimate and 40 dB on the error, the numbers printed; the data-
    parallel f32 GEQ at tests/test_sharded.py's rtol 1e-5 / atol 1e-3."""
    got = _result(runs, 4, path)
    want = _jax_sharded(path, tmp_path)
    if path == "fastconv":
        np.testing.assert_array_equal(got[1], want[1])
        got, want = (got[0][got[1]],), (want[0][want[1]],)
    if path in ("nlms_f32", "bnlms_f32"):
        s_est, s_err = _snr(want[0], got[0]), _snr(want[1], got[1])
        print(f"{path}: port against JAX {s_est:.2f} dB est, {s_err:.2f} dB err")
        assert s_est >= 60.0 and s_err >= 40.0
    elif path == "dp_geq_f32":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-3)
    elif path == "dp_geq_f64":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-7, atol=1e-5)
    else:
        _same_contract(path, want, got)


if __name__ == "__main__":
    _worker(sys.argv[1:])
