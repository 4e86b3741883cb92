"""CPU parity of the port's GMM training and model files
(``jeicyboodsp_tpu_torch.models.gmm``, ``models.serialization``, the
``gmm-train``/``gmm-test`` pipelines and CLI, ``speech_train``) with the
JAX package (x64) and ``oracle/gmm.py``.

Eigenvector signs differ by library (torch's LAPACK call returns other signs
than JAX's, which match numpy's), so what is compared is sign-invariant:
alpha, the covariances, |eigenvector dots|, the projected means after each
column's sign is aligned, the scores.  ``gmm-test`` decisions are compared on
one model file, which both packages read.  Tolerances are stated in each
test; tests/test_gmm.py's bounds where it has them.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.models import gmm as jg
from jeicyboodsp_tpu.models import serialization as js
from jeicyboodsp_tpu.oracle import gmm as og
from jeicyboodsp_tpu.pipelines import registry as jreg
from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.models import gmm as tg
from jeicyboodsp_tpu_torch.models import serialization as ts
from jeicyboodsp_tpu_torch.oracle import gmm as port_og
from jeicyboodsp_tpu_torch.pipelines import registry as treg


VERBOSE_RTOL, VERBOSE_ATOL = 1e-6, 2e-4  # %.5f lines (tests/test_verbose.py:186)


def _class_data(rng, n=120, centers=None, spread=2.0):
    """tests/test_gmm.py's 12-dim classes: 4 centers, frame i near center i % 4."""
    if centers is None:
        centers = rng.normal(0, 4, (4, 12))
    return np.array([centers[i % 4] + rng.normal(0, spread, 12) for i in range(n)])


def _synth_class_frames(seed, n=48):
    """tests/test_oracle_vs_binary.py's class: four sub-clusters placed so
    the k-means seeds (frames 0, 4, 8, 12) land in distinct clusters."""
    r = np.random.default_rng(seed)
    sub = r.normal(0, 10, 12) + r.normal(0, 4.0, (4, 12))
    return sub[(np.arange(n) // 4) % 4] + r.normal(0, 0.5, (n, 12))


def _np(params):
    return [np.asarray(p) for p in params]


def _signs(e_got, e_want):
    """Per-column sign that aligns e_got's eigenvectors with e_want's."""
    s = np.sign(np.sum(e_got * e_want, axis=-2))
    s[s == 0] = 1.0
    return s


def _write_list(path, entries):
    with open(path, "w") as f:
        f.write("\n".join(entries))  # no trailing newline: the reference's fscanf loop


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_verbose.py's corpus: 25 classes of 48 frames, classes 0-1
    with a second file (the multi-file EM loop), and a JAX-trained model."""
    tmp = tmp_path_factory.mktemp("gmm_corpus")
    lists = []
    for c in range(25):
        files = [_synth_class_frames(1000 + c)] + ([_synth_class_frames(2000 + c)] if c < 2 else [])
        paths = []
        for j, fr in enumerate(files):
            p = str(tmp / f"c{c}_{j}.mfc")
            fr.astype("<f8").tofile(p)
            paths.append(p)
        lst = str(tmp / f"c{c}.lst")
        _write_list(lst, paths)
        lists.append(lst)
    main_list = str(tmp / "train.lst")
    _write_list(main_list, lists)
    jax_model = str(tmp / "jax_model.bin")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jreg.gmm_train(main_list, jax_model, verbose=True)
    return tmp, main_list, jax_model, out.getvalue()


# ---- serialization ---------------------------------------------------------------


def _random_gmm(rng, pca):
    return (rng.uniform(0.1, 1, 4), rng.normal(0, 1, (4, 12)), rng.normal(0, 1, (4, 12, 12)),
            rng.normal(0, 1, (4, 12, pca)))


def test_struct_constants_and_packed_bytes_identical():
    for k in ("TRAIN_STRUCT_BYTES", "TEST_STRUCT_BYTES", "HMM_STRUCT_BYTES", "TRAIN_PCA",
              "TEST_PCA", "NUM_OF_STATE"):
        assert getattr(ts, k) == getattr(js, k), k
    rng = np.random.default_rng(3)
    for pca in (8, 4):
        g = _random_gmm(rng, pca)
        assert ts.pack_gmm(*g) == js.pack_gmm(*g)
        for a, b in zip(ts.unpack_gmm(js.pack_gmm(*g), pca), g):
            np.testing.assert_array_equal(a, b)
    states = [_random_gmm(rng, 4) for _ in range(6)]
    trans = rng.uniform(0, 1, (6, 6))
    blob = ts.pack_hmm(states, trans)
    assert blob == js.pack_hmm(states, trans) and len(blob) == ts.HMM_STRUCT_BYTES


@pytest.mark.parametrize("n_written,n_read", [(3, 3), (2, 3)], ids=["whole", "past-eof"])
def test_read_layouts_identical_to_jax(tmp_path, n_written, n_read):
    """A train-layout file of n_written classes, read by both packages as the
    classifier reads it (6560-byte strides, zeros past the end) and
    aligned: identical arrays."""
    rng = np.random.default_rng(11)
    classes = [_random_gmm(rng, 8) for _ in range(n_written)]
    path = str(tmp_path / "m.bin")
    ts.write_train_model(path, classes)
    with open(path, "rb") as f:
        port_bytes = f.read()
    js.write_train_model(str(tmp_path / "j.bin"), classes)
    with open(tmp_path / "j.bin", "rb") as f:
        assert port_bytes == f.read()
    for got, want in zip(ts.read_as_test_layout(path, n_read), js.read_as_test_layout(path, n_read)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for got, want in zip(ts.read_train_layout(path, n_written),
                         js.read_train_layout(path, n_written)):
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()
    a4 = ts.train_to_test_params(*classes[0])
    assert a4[3].shape == (4, 12, 4) and np.array_equal(a4[3], classes[0][3][..., :4])
    with pytest.raises(ValueError):
        ts.write_train_model(str(tmp_path / "bad.bin"), [_random_gmm(rng, 4)])


# ---- k-means and EM --------------------------------------------------------------


def _jax_kmeans_count(frames, monkeypatch):
    """JAX's k-means iterations: its while_loop run eagerly with a spy on
    the final carry (the count is its first leaf)."""
    seen = []
    real = jax.lax.while_loop

    def spy(cond, body, carry):
        out = real(cond, body, carry)
        seen.append(int(out[0]))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", spy)
    with jax.disable_jit():
        f = jnp.asarray(frames)
        means, covs = jg.kmeans(f, jnp.ones(len(frames), bool), f[jnp.arange(4) * 4])
    monkeypatch.setattr(jax.lax, "while_loop", real)
    return np.asarray(means), np.asarray(covs), seen[-1]


def _probes():
    rng = np.random.default_rng(7)
    return [_class_data(rng), _class_data(np.random.default_rng(42), n=80),
            _synth_class_frames(1003), _synth_class_frames(1017, n=192)]


def test_kmeans_against_jax_with_its_iteration_count(monkeypatch):
    """Means and covariances within 1e-10 of the largest |value| of JAX's,
    the iteration count equal, per probe and batched over the probes
    (ragged masks: each class keeps its own count)."""
    probes = _probes()
    n_max = max(len(p) for p in probes)
    frames = np.zeros((len(probes), n_max, 12))
    masks = np.zeros((len(probes), n_max), bool)
    want = []
    for i, p in enumerate(probes):
        frames[i, :len(p)], masks[i, :len(p)] = p, True
        wm, wc, count = _jax_kmeans_count(p, monkeypatch)
        t = torch.from_numpy(p)
        gm, gc, gcount = tg.kmeans_counted(t, torch.ones(len(p), dtype=torch.bool), t[0:16:4])
        assert int(gcount) == count > 1
        np.testing.assert_allclose(gm.numpy(), wm, rtol=0, atol=1e-10 * np.abs(wm).max())
        np.testing.assert_allclose(gc.numpy(), wc, rtol=0, atol=1e-10 * np.abs(wc).max())
        want.append((gm.numpy(), gc.numpy(), count))
    f = torch.from_numpy(frames)
    bm, bc, bcount = tg.kmeans_counted(f, torch.from_numpy(masks), f[:, 0:16:4])
    assert bcount.tolist() == [w[2] for w in want]
    for i, (wm, wc, _) in enumerate(want):
        np.testing.assert_allclose(bm[i].numpy(), wm, rtol=0, atol=1e-10 * np.abs(wm).max())
        np.testing.assert_allclose(bc[i].numpy(), wc, rtol=0, atol=1e-10 * np.abs(wc).max())


def test_kmeans_ties_go_to_the_last_mixture():
    """Two seeds on one frame: every frame ties between mixtures 0 and 1 and
    must go to 1, so mixture 0 keeps no frame and its covariance is 0/0."""
    frames = _synth_class_frames(1005)
    frames[4] = frames[0]
    t = torch.from_numpy(frames)
    means, covs = tg.kmeans(t, torch.ones(48, dtype=torch.bool), t[0:16:4])
    wm, wc = og.kmeans(frames, frames[0:16:4].copy())
    assert torch.isnan(covs[0]).all() and np.isnan(wc[0]).all()
    np.testing.assert_allclose(means.numpy(), wm, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("far", ["valid", "masked"])
def test_em_step_against_jax(far):
    """One EM step from JAX's k-means parameters: within 1e-10 of each
    array's largest |value| of JAX's.  A valid frame far from every mixture
    underflows all four densities: 0/0 responsibilities, NaN everywhere in
    both packages; masked, it is ignored (the where comes after the
    division, as JAX's)."""
    frames = _class_data(np.random.default_rng(7))
    frames[-1] = 1e3
    mask = np.ones(len(frames), bool)
    if far == "masked":
        mask[-1] = False
    f, m = jnp.asarray(frames), jnp.asarray(mask)
    mean, cov = jg.kmeans(f[:-1], m[:-1], f[jnp.arange(4) * 4])
    alpha = jnp.full((4,), 0.25)
    want = _np(jg.em_step(f, m, alpha, mean, cov))
    got = [t.numpy() for t in tg.em_step(torch.from_numpy(frames), torch.from_numpy(mask),
                                          *(torch.from_numpy(np.array(a)) for a in (alpha, mean, cov)))]
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        if far == "valid":
            assert np.isnan(w).all()
        else:
            assert np.isfinite(w).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * np.abs(w).max())


def test_em_loglik_compat_against_jax():
    """The cumulative-likelihood diagnostic within 1e-9 relative of JAX's."""
    frames = _class_data(np.random.default_rng(13))
    a, m, c = jg.train_single_file(jnp.asarray(frames), jnp.ones(len(frames), bool))
    want = float(jg.em_loglik_compat(jnp.asarray(frames), a, m, c))
    got = float(tg.em_loglik_compat(torch.from_numpy(frames),
                                    *(torch.from_numpy(np.array(x)) for x in (a, m, c))))
    np.testing.assert_allclose(got, want, rtol=1e-9)


# ---- whole-class training ------------------------------------------------------------


def _check_export(got, want_alpha, want_mean, want_cov, want_ev, alpha_rtol=1e-6, mean_tol=1e-5,
                  cov_tol=1e-4, mean_cols=12):
    """tests/test_gmm.py:25-41's bounds, the mean after aligning signs."""
    a, m, c, e = got
    np.testing.assert_allclose(a, want_alpha, rtol=alpha_rtol)
    s = _signs(e, want_ev)  # (4, 8)
    aligned = m.copy()
    aligned[:, :8] *= s
    np.testing.assert_allclose(aligned[:, :mean_cols], want_mean[:, :mean_cols], rtol=mean_tol,
                               atol=mean_tol)
    np.testing.assert_allclose(c, want_cov, rtol=cov_tol, atol=cov_tol)
    for k in range(4):
        dots = np.abs(np.sum(e[k] * want_ev[k], axis=0))
        np.testing.assert_allclose(dots[:4], 1.0, atol=1e-5)
        np.testing.assert_allclose(e[k].T @ e[k], np.eye(8), atol=1e-8)


def test_train_class_one_file_against_oracle_and_jax():
    """tests/test_gmm.py:22-41 on the port: alpha rtol 1e-6, mean 1e-5
    (signs aligned), cov 1e-4, the top-4 |eigenvector dots| within 1e-5 of
    1, against the oracle and against JAX."""
    frames = _class_data(np.random.default_rng(7))
    got = [t.numpy() for t in tg.train_class([frames], device="cpu")]
    o = og.train_class([frames])
    _check_export(got, o.alpha, o.mean, o.cov, o.eigvec)
    _check_export(got, *_np(jg.train_class([frames])))


def test_train_class_two_files_against_oracle_and_jax():
    """tests/test_gmm.py:44-55 (the multi-file EM): alpha rtol 1e-5, the
    classifier-visible mean[:, :4] within 1e-4 (signs aligned)."""
    rng = np.random.default_rng(42)
    f1, f2 = _class_data(rng), _class_data(rng, n=80)
    got = [t.numpy() for t in tg.train_class([f1, f2], device="cpu")]
    o = og.train_class([f1, f2])
    for want in ((o.alpha, o.mean, o.cov, o.eigvec), _np(jg.train_class([f1, f2]))):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        s = _signs(got[3], want[3])[:, :4]
        np.testing.assert_allclose(got[1][:, :4] * s, want[1][:, :4], rtol=1e-4, atol=1e-4)


def test_train_class_float32():
    """dtype=float32 (gmm-train --fast) trains in float32: alpha within
    1e-4 of the float64 run's, the top-4 |eigenvector dots| within 1e-3."""
    frames = _class_data(np.random.default_rng(7))
    g32 = [t.numpy() for t in tg.train_class([frames], dtype=torch.float32, device="cpu")]
    g64 = [t.numpy() for t in tg.train_class([frames], device="cpu")]
    assert all(a.dtype == np.float32 for a in g32)
    np.testing.assert_allclose(g32[0], g64[0], rtol=1e-4)
    for k in range(4):
        np.testing.assert_allclose(np.abs(np.sum(g32[3][k] * g64[3][k], 0))[:4], 1.0, atol=1e-3)


def test_train_classes_batched_ragged():
    """tests/test_gmm.py:258-279's ragged classes: the batched call against
    the port's per-class training (alpha rtol 1e-6, mean[:, :4] 1e-4 with
    signs aligned) and JAX's batched call (the same bounds)."""
    rng = np.random.default_rng(29)
    classes = [_class_data(rng, 96 + 8 * i) for i in range(3)]
    n_max = max(len(c) for c in classes)
    frames = np.zeros((3, n_max, 12))
    masks = np.zeros((3, n_max), bool)
    for i, c in enumerate(classes):
        frames[i, :len(c)], masks[i, :len(c)] = c, True
    got = [t.numpy() for t in tg.train_classes_batched(torch.from_numpy(frames),
                                                        torch.from_numpy(masks))]
    jb = _np(jg.train_classes_batched(jnp.asarray(frames), jnp.asarray(masks)))
    for i, c in enumerate(classes):
        one = [t.numpy() for t in tg.train_class([c], device="cpu")]
        for want in (one, [w[i] for w in jb]):
            np.testing.assert_allclose(got[0][i], want[0], rtol=1e-6)
            s = _signs(got[3][i], want[3])[:, :4]
            np.testing.assert_allclose(got[1][i][:, :4] * s, want[1][:, :4], rtol=1e-4, atol=1e-4)


def test_pca_export_keeps_stale_rows():
    """Rows 8-11 of each covariance pass through untouched; rows 0-7 are 0
    but for the eigenvalues on the diagonal; mean[8:] is 0."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (4, 12, 12))
    cov = x @ x.transpose(0, 2, 1)
    mean = rng.normal(0, 1, (4, 12))
    _, m, c, e = tg.pca_export(torch.full((4,), 0.25, dtype=torch.float64),
                               torch.from_numpy(mean), torch.from_numpy(cov))
    m, c, e = m.numpy(), c.numpy(), e.numpy()
    assert np.array_equal(c[:, 8:], cov[:, 8:]) and (m[:, 8:] == 0).all()
    vals = np.sort(np.linalg.eigvalsh(cov), axis=1)[:, ::-1][:, :8]
    np.testing.assert_allclose(np.diagonal(c[:, :8, :8], axis1=1, axis2=2), vals, rtol=1e-12)
    assert (c[:, :8][np.broadcast_to(~np.eye(8, 12, dtype=bool), (4, 8, 12))] == 0).all()
    np.testing.assert_allclose(np.abs(m[:, :8]), np.abs(np.einsum("ki,kij->kj", mean, e)),
                               rtol=1e-12)


# ---- the gmm-train / gmm-test pipelines ----------------------------------------------


def test_gmm_train_verbose_lines_against_jax(corpus, tmp_path):
    """tests/test_verbose.py:142's corpus: 81 ' before X after Y' lines (3
    iterations x 27 files) within rtol 1e-6 and atol 2e-4 of JAX's (the
    library's cumsum and eigensolver round apart in the last printed digit;
    NaN where JAX prints NaN: the second files of classes 0-1 lie far from
    their first), and the count_/training end lines equal."""
    _, main_list, _, jax_out = corpus
    with contextlib.redirect_stdout(io.StringIO()) as out:
        treg.gmm_train(main_list, str(tmp_path / "m.bin"), verbose=True, device="cpu")
    pat = r" before (\S+) after (\S+)"
    want = np.array(re.findall(pat, jax_out), np.float64)
    got = np.array(re.findall(pat, out.getvalue()), np.float64)
    assert want.shape == got.shape == (81, 2)
    np.testing.assert_allclose(got, want, rtol=VERBOSE_RTOL, atol=VERBOSE_ATOL)
    strip = lambda s: [ln for ln in s.splitlines() if "before" not in ln]  # noqa: E731
    assert strip(out.getvalue()) == strip(jax_out)


def _model_files(main_list):
    return [(ci, p) for ci, lst in enumerate(open(main_list).read().split("\n"))
            for p in open(lst).read().split("\n")]


@pytest.mark.parametrize("mismatch", [True, False], ids=["misaligned", "aligned"])
def test_gmm_test_lines_equal_jax_on_one_model(corpus, mismatch):
    """gmm-test on the JAX-written model file: the printed decisions equal
    JAX's, with the reference's layout mismatch (NaN and infinite scores
    common; also through cli.main) and without.  Scores within rtol 1e-9 of the oracle's
    score_file, NaN where its are, and of JAX's but where XLA:CPU flushes a
    subnormal density to 0 (JAX's -inf against the oracle's finite score;
    ROADMAP R14)."""
    _, main_list, jax_model, _ = corpus
    with contextlib.redirect_stdout(io.StringIO()) as out:
        want = jreg.gmm_test(main_list, jax_model, emulate_layout_mismatch=mismatch)
    with contextlib.redirect_stdout(io.StringIO()) as got_out:
        got = treg.gmm_test(main_list, jax_model, emulate_layout_mismatch=mismatch, device="cpu")
    assert got_out.getvalue() == out.getvalue() and len(got) == 27
    if mismatch:  # the CLI reads the model as the reference does
        with contextlib.redirect_stdout(io.StringIO()) as cli_out:
            main(["gmm-test", main_list, jax_model, "--device", "cpu"])
        assert cli_out.getvalue() == out.getvalue()
    models = (js.read_as_test_layout(jax_model, 25) if mismatch else
              [js.train_to_test_params(*m) for m in js.read_train_layout(jax_model, 25)])
    models = [(a, m, np.stack([np.diag(c)[:4] for c in cv]), e) for a, m, cv, e in models]
    oracle = np.array([[og.score_file(np.fromfile(p, "<f8").reshape(-1, 12), *m) for m in models]
                       for _, p in _model_files(main_list)])
    ws, gs = np.array([w[2] for w in want]), np.array([g[2] for g in got])
    np.testing.assert_allclose(gs, oracle, rtol=1e-9)  # NaN and infinities in the same places
    flushed = ~np.isclose(ws, gs, rtol=1e-9, equal_nan=True)
    assert (np.isneginf(ws[flushed]) & np.isfinite(oracle[flushed])).all()
    if mismatch:
        assert (~np.isfinite(ws)).any()


def test_gmm_test_against_the_smoke_reference(corpus):
    """The port's decisions on the JAX model file equal those of
    the port's oracle's reference_score_file's scores under the reference's argmax
    (the first 9 files: classes 0-6)."""
    _, main_list, jax_model, _ = corpus
    with contextlib.redirect_stdout(io.StringIO()):
        got = treg.gmm_test(main_list, jax_model, device="cpu")
    models = [(a, m, np.stack([np.diag(c)[:4] for c in cv]), e)
              for a, m, cv, e in js.read_as_test_layout(jax_model, 25)]
    files = _model_files(main_list)
    assert [g[0] for g in got] == [ci for ci, _ in files]
    for (_, pred, _), (_, path) in list(zip(got, files))[:9]:
        frames = np.fromfile(path, "<f8").reshape(-1, 12)
        scores = [port_og.reference_score_file(frames, *m) for m in models]
        best, want = scores[0], 0
        for u in range(1, 25):
            if best < scores[u]:
                best, want = scores[u], u
        assert pred == want


def test_port_model_file_against_jax_sign_invariant(corpus, tmp_path):
    """The model file the port's gmm-train writes against JAX's: same size;
    alpha within rtol 1e-6, the covariances (eigenvalue diagonals and stale
    rows) within 1e-4, |mean[:4]| within 1e-4, the top-4 |eigenvector dots|
    within 1e-5 of 1, for the 23 one-file classes (classes 0-1 are NaN in
    both: their second file lies far from the first)."""
    _, main_list, jax_model, _ = corpus
    path = str(tmp_path / "port.bin")
    main(["gmm-train", main_list, path, "--device", "cpu"])
    assert os.path.getsize(path) == os.path.getsize(jax_model) == 25 * ts.TRAIN_STRUCT_BYTES
    for c, (got, want) in enumerate(zip(ts.read_train_layout(path, 25),
                                        js.read_train_layout(jax_model, 25))):
        if c < 2:
            assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
            continue
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.abs(got[1][:, :4]), np.abs(want[1][:, :4]), rtol=1e-4,
                                   atol=1e-4)
        for k in range(4):
            np.testing.assert_allclose(np.abs(np.sum(got[3][k] * want[3][k], 0))[:4], 1.0,
                                       atol=1e-5)


def test_gmm_cli_fast_and_refusals(corpus, tmp_path):
    """gmm-train --fast trains in float32 (the file holds f64 numbers of f32
    values); gmm-test and viterbi refuse --fast, the three refuse --engine,
    gmm-test refuses --verbose."""
    _, main_list, jax_model, _ = corpus
    path = str(tmp_path / "fast.bin")
    main(["gmm-train", main_list, path, "--fast", "--device", "cpu"])
    a = ts.read_train_layout(path, 25)[5][0]
    assert np.array_equal(a, a.astype(np.float32).astype(np.float64))
    for argv in (["gmm-test", main_list, jax_model, "--fast"],
                 ["viterbi", main_list, jax_model, "--fast"],
                 ["gmm-train", main_list, path, "--fast", "--engine", "xla"],
                 ["gmm-test", main_list, jax_model, "--verbose"],
                 ["gmm-test", main_list]):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--device", "cpu"])
        assert e.value.code == 2


# ---- speech_train -----------------------------------------------------------------------


def _tones(C, T, seed=5):
    """tests/test_torch_features.py's class audio: a 250 (c + 1) Hz tone with
    vibrato and amplitude modulation over N(0, 400)."""
    rng = np.random.default_rng(seed)
    audio = np.zeros((C, T, 1024), np.int16)
    for c in range(C):
        t = np.arange(T * 1024) / 16000
        f = 250.0 * (c + 1) * (1 + 0.2 * np.sin(2 * np.pi * 1.3 * t))
        amp = 6000 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t) ** 2)
        x = np.clip(amp * np.sin(2 * np.pi * np.cumsum(f) / 16000) + rng.normal(0, 400, len(t)),
                    -32768, 32767)
        audio[c] = x.astype(np.int16).reshape(T, 1024)
    return audio


@pytest.mark.parametrize("T", [8, 24])
def test_speech_train_against_jax(T):
    """speech_train in f64 xla on 3 classes: at T = 8 blocks (16 frames a
    class, fewer than a mixture's 12 dimensions need) every class is NaN in
    both packages; at T = 24 alpha within rtol 1e-6, cov within 1e-4 of the
    largest |value|, |mean[:4]| likewise, the top-4 |eigenvector dots| within
    1e-5 of 1."""
    from jeicyboodsp_tpu.pipelines.speech import speech_train as jax_train
    from jeicyboodsp_tpu_torch.pipelines.speech import speech_train

    audio = _tones(3, T)
    want = _np(jax_train(jnp.asarray(audio), dtype=jnp.float64))
    got = [t.numpy() for t in speech_train(torch.from_numpy(audio), dtype=torch.float64)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
    if T == 8:
        assert np.isnan(want[0]).all()
        return
    assert np.isfinite(want[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    tol = 1e-4 * np.abs(want[2]).max()
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=tol)
    np.testing.assert_allclose(np.abs(got[1][..., :4]), np.abs(want[1][..., :4]), rtol=0,
                               atol=1e-4 * np.abs(want[1]).max())
    dots = np.abs(np.sum(got[3] * want[3], axis=-2))[..., :4]
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


# ---- the smoke's reference copies -------------------------------------------------------


def test_smoke_gmm_references_equal_the_oracle():
    """The port's copies of oracle/gmm.py (``jeicyboodsp_tpu_torch.oracle.gmm``,
    which chip_smoke.py holds the port to) give the same bytes: kmeans,
    em_step, train_class (one and two files), pca_export, score_file."""
    rng = np.random.default_rng(42)
    f1, f2 = _class_data(rng), _class_data(rng, n=80)
    for got, want in zip(port_og.reference_kmeans(f1, f1[0:16:4].copy()),
                         og.kmeans(f1, f1[0:16:4].copy())):
        assert got.tobytes() == want.tobytes()
    for files in ([f1], [f1, f2], [_synth_class_frames(1000), _synth_class_frames(2000)]):
        got, want = port_og.reference_train_class(files), og.train_class(files)
        for k in ("alpha", "mean", "cov", "eigvec"):
            assert np.asarray(getattr(got, k)).tobytes() == np.asarray(getattr(want, k)).tobytes(), k
    o = og.train_class([f1])
    a4, m4, cv4, e4 = js.train_to_test_params(o.alpha, o.mean, o.cov, o.eigvec)
    d4 = np.stack([np.diag(c)[:4] for c in cv4])
    for frames in (f1, f2):
        got = port_og.reference_score_file(frames, a4, m4, d4, e4)
        want_s = og.score_file(frames, a4, m4, d4, e4)
        assert np.asarray(got).tobytes() == np.asarray(want_s).tobytes()
