"""The port's sharded speech pipeline
(``jeicyboodsp_tpu_torch.parallel.speech_sharded``) in worlds of gloo ranks on
the CPU, against the port's unsharded ops and the JAX package's sharded ops.

As in tests/test_torch_parallel.py, this file run as a script is the worker
(``python tests/test_torch_speech_sharded.py RANK WORLD STORE OUTDIR``): it
imports only torch and the port, joins its world through a ``FileStore``
under the test's temporary directory, runs the three sharded functions on
each mesh of its world and saves what they return; each process has a
timeout of its own, so a hung collective fails the test.  The inputs are
tests/test_speech_sharded.py's, made from its seeds: ``_class_audio`` with
C = 4, T = 32, its 6-state HMM and 8 utterances.  The class models that the
utterances are scored against are JAX's, trained by its sharded op on a
(2, 2) mesh and handed to the workers in a file (``model_to_port``), so the
port's sharded classification, its unsharded one and JAX's score one model.

Contracts (tests/test_speech_sharded.py): training rtol 1e-9 / atol 1e-11
with eigenvectors by |cosine| within 1e-8, classification rtol 1e-10 /
atol 1e-12 with the decisions [0, 1, 2, 3, 0, 1, 2, 3], decoding paths
equal and scores at rtol 1e-10.  Against JAX each eigenvector column (and
the projected mean entry with it) is first given JAX's sign: the two
libraries' eigh pick signs apart.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 150  # seconds a worker may take before the test fails
# (expert, data) meshes of each world; the 8-rank world runs the R22 probe alone
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4)), 8: ((1, 8),)}
ALL_MESHES = MESHES[2] + MESHES[4]
# R22: 6 blocks a data rank, so data-rank 0 holds 12 frames and the seeds are frames 0, 4, 8
# and 11.  At T = 24 on (1, 4) every class keeps a cluster of 6 frames (the top-8 PCA is not
# defined and JAX's own op gives NaN models in 1 of 8 identical runs), so the probe is
# T = 48 on (1, 8): clusters of 12 frames and more
R22_MESH, R22_T = (1, 8), 48
TRAIN_RTOL, TRAIN_ATOL, DOT_TOL = 1e-9, 1e-11, 1e-8
CLS_RTOL, CLS_ATOL = 1e-10, 1e-12
DEC_RTOL = 1e-10
MXU3_RTOL = 1e-6  # the f32 K10 route, sharded against unsharded: the same kernel on the same rows


def _class_audio(rng, C=4, T=32):
    """tests/test_speech_sharded.py:_class_audio, in numpy: per-class tones
    with four sub-tones cycling per block over N(0, 200)."""
    out = np.zeros((C, T, 1024), np.int16)
    tb = np.arange(1024) / 16000
    for c in range(C):
        f0 = 300 + 400 * c
        for b in range(T):
            sub = 1.0 + 0.12 * (b % 4)
            amp = 5000 + 900 * ((b // 4) % 3)
            sig = amp * np.sin(2 * np.pi * f0 * sub * tb)
            sig += 2500 * np.sin(2 * np.pi * 2.3 * f0 * sub * tb)
            sig += rng.normal(0, 200, 1024)
            out[c, b] = np.clip(sig, -32768, 32767).astype(np.int16)
    return out


@functools.lru_cache(maxsize=1)
def _inputs():
    """tests/test_speech_sharded.py's inputs from its seeds (7, 8, 9), and
    the R22 probe: seed 7's audio at R22_T blocks."""
    d = {"train": _class_audio(np.random.default_rng(7))}
    rng = np.random.default_rng(8)
    d["cls_train"] = _class_audio(rng)
    d["utts"] = np.concatenate([d["cls_train"], _class_audio(rng)])
    rng = np.random.default_rng(9)
    states = []
    for s in range(6):
        a = np.full(4, 0.25)
        m = np.zeros((4, 12))
        m[:, :4] = rng.normal(0, 3, (4, 4))
        cv = np.stack([np.eye(12) * (0.5 + 0.2 * k) for k in range(4)])
        e, _ = np.linalg.qr(rng.normal(0, 1, (12, 12)))
        states.append((a, m, cv, np.stack([e[:, k:k + 4] for k in range(4)])))
    d["hmm"] = tuple(np.stack([s[i] for s in states]) for i in range(4))
    trans = rng.uniform(0.05, 1.0, (6, 6))
    d["trans"] = trans / trans.sum(axis=1, keepdims=True)
    d["dec_utts"] = _class_audio(rng, C=8, T=4)
    d["r22"] = _class_audio(np.random.default_rng(7), T=R22_T)
    return d


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _run_paths(world: int, rank: int, store: str, models: dict) -> dict:
    """The three sharded functions on every mesh of this world (the worker's
    body); numpy results keyed 'MESH/PATH.i'."""
    from jeicyboodsp_tpu_torch.models.gmm import model_to_port
    from jeicyboodsp_tpu_torch.models.hmm import hmm_to_port
    from jeicyboodsp_tpu_torch.parallel import mesh as M
    from jeicyboodsp_tpu_torch.parallel import speech_sharded as SS

    assert M.init_distributed(f"file://{store}", world, rank, device="cpu")
    d = _inputs()
    f64, f32 = torch.float64, torch.float32
    cpu = torch.device("cpu")
    model = model_to_port(*(models[k] for k in ("alpha", "mean", "cov", "eig4")), cpu)
    hmm = hmm_to_port(*d["hmm"], d["trans"], cpu)
    out = {}
    for shape in MESHES[world]:
        mesh = M.make_mesh(shape, ("expert", "data"))  # one mesh (and its groups) per shape
        tag = _tag(shape)
        if shape == R22_MESH:
            out[f"{tag}/r22"] = SS.speech_train_sharded(d["r22"], mesh, dtype=f64)
            continue
        out[f"{tag}/train"] = SS.speech_train_sharded(d["train"], mesh, dtype=f64)
        out[f"{tag}/classify"] = (SS.speech_classify_sharded(d["utts"], *model, mesh, dtype=f64),)
        out[f"{tag}/classify_mxu3"] = (SS.speech_classify_sharded(
            d["utts"], *model, mesh, dtype=f32, fft_engine="mxu3"),)
        out[f"{tag}/decode"] = SS.speech_decode_sharded(d["dec_utts"], *hmm, mesh, dtype=f64)
        # this rank's utterances and its (expert, data) coordinate: the one result that differs
        # between ranks
        out[f"own/{tag}"] = (SS._mesh_rows(np.arange(8), SS._groups(mesh, ("expert", "data")),
                                           mesh), torch.tensor(mesh.get_coordinate()))
    return {f"{k}.{i}": v.cpu().numpy() for k, vs in out.items() for i, v in enumerate(vs)}


def _worker(argv):
    rank, world, store, outdir, models = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    res = _run_paths(world, rank, store, dict(np.load(models)))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------- the JAX side


@pytest.fixture(scope="module")
def jax_side():
    """JAX's three sharded functions under ``jax.jit`` (a ``shard_map`` run
    eagerly dispatches op by op) on (expert, data) meshes of 4 of the 8
    virtual devices: training of seed 7's audio and of the classification
    corpus on (2, 2), classification and decoding on (2, 2); the R22 probe
    on (1, 8), all 8.  Returns numpy results."""
    import jax
    import jax.numpy as jnp

    from jeicyboodsp_tpu.parallel import make_mesh
    from jeicyboodsp_tpu.parallel import speech_sharded as JSS

    d = _inputs()
    devs = jax.devices()[:4]
    m22 = make_mesh((2, 2), ("expert", "data"), devices=devs)
    m18 = make_mesh(R22_MESH, ("expert", "data"), devices=jax.devices()[:8])
    f64 = jnp.float64
    train22 = jax.jit(lambda x: JSS.speech_train_sharded(x, m22, dtype=f64))
    train18 = jax.jit(lambda x: JSS.speech_train_sharded(x, m18, dtype=f64))
    res = {"train": train22(jnp.asarray(d["train"])), "r22": train18(jnp.asarray(d["r22"]))}
    al, me, cv, e8 = train22(jnp.asarray(d["cls_train"]))
    res["models"] = (al, me, cv, e8[..., :4])
    res["classify"] = (jax.jit(lambda u, *m: JSS.speech_classify_sharded(u, *m, m22, dtype=f64))(
        jnp.asarray(d["utts"]), *res["models"]),)
    hmm = [jnp.asarray(v) for v in (*d["hmm"], d["trans"])]
    res["decode"] = jax.jit(lambda u, *h: JSS.speech_decode_sharded(u, *h, m22, dtype=f64))(
        jnp.asarray(d["dec_utts"]), *hmm)
    return {k: tuple(np.asarray(v) for v in vs) for k, vs in res.items()}


@pytest.fixture(scope="module")
def runs(jax_side, tmp_path_factory):
    """{world: [each rank's results]} from one launch of each world, the
    class models JAX's."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    models = str(tmp_path_factory.mktemp("models") / "models.npz")
    np.savez(models, **dict(zip(("alpha", "mean", "cov", "eig4"), jax_side["models"])))
    found = {}
    for world in MESHES:
        work = tmp_path_factory.mktemp(f"world{world}")
        store = str(work / "store")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                                   store, str(work), models], stdout=subprocess.PIPE,
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


def _result(runs, mesh, path):
    r = runs[int(np.prod(mesh))][0]
    key = f"{_tag(mesh)}/{path}."
    return tuple(r[f"{key}{i}"] for i in range(sum(k.startswith(key) for k in r)))


# ---------------------------------------------------------------- the port's unsharded side


def _port_model(models):
    from jeicyboodsp_tpu_torch.models.gmm import model_to_port

    return model_to_port(*(models[i] for i in range(4)), torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def _port_train(key):
    from jeicyboodsp_tpu_torch.pipelines.speech import speech_train

    x = torch.from_numpy(_inputs()[key])
    return tuple(v.numpy() for v in speech_train(x, dtype=torch.float64))


def _unsharded(path, models):
    """The port's unsharded op of ``path`` on the same inputs, numpy."""
    from jeicyboodsp_tpu_torch.models import hmm as TH
    from jeicyboodsp_tpu_torch.ops.features import mel_dct, mfcc_blocks
    from jeicyboodsp_tpu_torch.pipelines.speech import speech_classify

    d = _inputs()
    f64 = torch.float64
    if path == "train":
        return _port_train("train")
    if path.startswith("classify"):
        dt, eng = (f64, "xla") if path == "classify" else (torch.float32, "mxu3")
        model = _port_model(models)
        return (torch.stack([speech_classify(torch.from_numpy(u), *model, dtype=dt, fft_engine=eng)
                             for u in d["utts"]]).numpy(),)
    utts = torch.from_numpy(d["dec_utts"])
    feats = mfcc_blocks(utts, *mel_dct(f64, utts.device), dtype=f64)
    lengths = torch.full((feats.shape[0],), feats.shape[1], dtype=torch.int64)
    hmm = TH.hmm_to_port(*d["hmm"], d["trans"], torch.device("cpu"))
    return tuple(v.numpy() for v in TH.viterbi_batched(feats, lengths, *hmm, compat=False))


def _signs(e_got, e_want):
    """Per-column sign that aligns e_got's eigenvectors with e_want's
    (tests/test_torch_gmm.py)."""
    s = np.sign(np.sum(e_got * e_want, axis=-2))
    s[s == 0] = 1.0
    return s


def _check_train(want, got, align=False):
    """Training contract; ``align`` gives each eigenvector column of ``got``
    (and its projected mean entry) the sign of ``want``'s first.  NaN
    equal."""
    got = list(got)
    if align:
        s = _signs(got[3], want[3])  # (C, 4, 8)
        got[3] = got[3] * s[..., None, :]
        got[1] = got[1].copy()
        got[1][..., :8] *= s
    for w, g, name in zip(want[:3], got[:3], ("alpha", "mean", "cov")):
        np.testing.assert_allclose(g, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL, err_msg=name)
    w, g = want[3], got[3]
    dots = np.abs(np.einsum("ckij,ckij->ckj", w, g) /
                  (np.linalg.norm(w, axis=-2) * np.linalg.norm(g, axis=-2) + 1e-300))
    np.testing.assert_array_equal(np.isnan(dots), np.isnan(w).any(-2))
    np.testing.assert_allclose(dots, 1.0, atol=DOT_TOL, err_msg="eigvec")
    if align:
        np.testing.assert_allclose(g, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL, err_msg="eigvec")


def _check(path, want, got, align=False):
    if path in ("train", "r22"):
        _check_train(want, got, align)
    elif path == "classify":
        np.testing.assert_allclose(got[0], want[0], rtol=CLS_RTOL, atol=CLS_ATOL)
        np.testing.assert_array_equal(np.argmax(got[0], axis=1), [0, 1, 2, 3, 0, 1, 2, 3])
    elif path == "classify_mxu3":
        np.testing.assert_allclose(got[0], want[0], rtol=MXU3_RTOL)
        np.testing.assert_array_equal(np.argmax(got[0], axis=1), np.argmax(want[0], axis=1))
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=DEC_RTOL)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("world", sorted(MESHES))
def test_every_rank_returns_the_whole_result(runs, world):
    for r in range(1, world):
        assert runs[world][r].keys() == runs[world][0].keys()
        for k, v in runs[world][0].items():
            if not k.startswith("own/"):
                np.testing.assert_array_equal(runs[world][r][k], v, err_msg=k)


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=_tag)
def test_utterances_split_expert_major(runs, mesh):
    """Rank (e, d) of an (n_expert, n_data) mesh holds chunk e * n_data + d
    of the utterances, as JAX's P(("expert", "data")) lays them out."""
    seen = set()
    for r in runs[int(np.prod(mesh))]:
        rows, (e, dd) = r[f"own/{_tag(mesh)}.0"], r[f"own/{_tag(mesh)}.1"]
        k = 8 // int(np.prod(mesh))
        chunk = e * mesh[1] + dd
        np.testing.assert_array_equal(rows, np.arange(chunk * k, (chunk + 1) * k))
        seen.add(int(chunk))
    assert seen == set(range(int(np.prod(mesh))))


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=_tag)
@pytest.mark.parametrize("path", ("train", "classify", "classify_mxu3", "decode"))
def test_sharded_equals_unsharded(runs, jax_side, path, mesh):
    """Each mesh of the 2- and 4-rank worlds against the port's unsharded
    speech_train, speech_classify (the f32 K10 route too) and mfcc_blocks +
    viterbi_batched."""
    got = _result(runs, mesh, path)
    assert got[0].shape[0] == (4 if path == "train" else 8)
    _check(path, _unsharded(path, jax_side["models"]), got)


@pytest.mark.parametrize("path", ("train", "classify", "decode", "r22"))
def test_sharded_equals_jax_sharded(runs, jax_side, path):
    """The port on the (2, 2) mesh (R22: on (1, 8)) against JAX's jitted
    sharded op on the same mesh shape, eigenvector signs aligned."""
    got = _result(runs, R22_MESH if path == "r22" else (2, 2), path)
    _check(path, jax_side[path], got, align=True)


@functools.lru_cache(maxsize=1)
def _r22_clamped():
    """The unsharded training of the R22 probe from the clamped seeds,
    frames 0, 4, 8 and 11 of each class: (k-means covariances, the PCA
    export after EM)."""
    from jeicyboodsp_tpu_torch.models import gmm as GM
    from jeicyboodsp_tpu_torch.ops.features import mel_dct, mfcc_blocks

    x = torch.from_numpy(_inputs()["r22"])
    f64 = torch.float64
    feats = mfcc_blocks(x, *mel_dct(f64, x.device), dtype=f64)
    mask = torch.ones(feats.shape[:2], dtype=torch.bool)
    mean, cov = GM.kmeans(feats, mask, feats[:, [0, 4, 8, 11]])
    km_cov = cov.numpy()
    alpha = torch.full((feats.shape[0], 4), 0.25, dtype=f64)
    for _ in range(GM.EM_ITERATIONS):
        alpha, mean, cov = GM.em_step(feats, mask, alpha, mean, cov)
    return km_cov, tuple(v.numpy() for v in GM.pca_export(alpha, mean, cov))


def test_r22_probe_keeps_every_cluster():
    """On the R22 probe the clamped seeding leaves every k-means cluster
    populated: each covariance's 8th eigenvalue is above 1e-6 of its first
    (the top-8 PCA is defined), and the exported models are finite."""
    km_cov, export = _r22_clamped()
    vals = np.linalg.eigvalsh(km_cov)
    assert (vals[..., -8] > 1e-6 * vals[..., -1]).all()
    assert all(np.isfinite(v).all() for v in export)


def test_r22_sharded_equals_clamped_seeding(runs):
    """R22: with 12 frames on data-rank 0 the sharded seeds are frames 0, 4,
    8 and 11 (JAX's clamped gather), so the sharded models are the unsharded
    training from those seeds, and not ``speech_train``'s (seeds 0, 4, 8,
    12); how far they lie from it is printed."""
    got = _result(runs, R22_MESH, "r22")
    _check_train(_r22_clamped()[1], got)
    unsharded = _port_train("r22")
    far = max(float(np.max(np.abs(g - w))) for g, w in zip(got[:2], unsharded[:2]))
    print(f"R22: sharded {R22_MESH} at T={R22_T} against the unsharded speech_train: "
          f"max |alpha, mean difference| {far:.3e}")
    assert far > 1e-6  # the seeds differ, and so do the models


def test_no_world_no_sharded_speech_path(monkeypatch):
    """With no process group each function raises rather than running on
    one process."""
    from jeicyboodsp_tpu_torch.parallel import speech_sharded as SS

    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    x = np.zeros((4, 4, 1024), np.int16)
    with pytest.raises(RuntimeError):
        SS.speech_train_sharded(x, None)
    with pytest.raises(RuntimeError):
        SS.speech_classify_sharded(x, None, None, None, None, None)
    with pytest.raises(RuntimeError):
        SS.speech_decode_sharded(x, None, None, None, None, None, None)


if __name__ == "__main__":
    _worker(sys.argv[1:])
