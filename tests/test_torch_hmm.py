"""CPU parity of the port's HMM decoding and training
(``jeicyboodsp_tpu_torch.models.hmm``, the ``viterbi`` pipeline and CLI,
``speech_decode``) with the JAX package (x64) and ``oracle/viterbi.py``.

The compat decode is the reference's log-of-log recursion: NaN is its common
case, so paths are compared as equal and scores as equal NaN or within rtol
1e-9.  The corrected and log-depth decodes are held at tests/test_gmm.py's
bounds.  Tolerances are stated in each test.
"""

import contextlib
import io
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.models import gmm as jg
from jeicyboodsp_tpu.models import hmm as jh
from jeicyboodsp_tpu.models import serialization as js
from jeicyboodsp_tpu.oracle import viterbi as ov
from jeicyboodsp_tpu.pipelines import registry as jreg
from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.models import hmm as th
from jeicyboodsp_tpu_torch.models import serialization as ts
from jeicyboodsp_tpu_torch.oracle import viterbi as port_ov
from jeicyboodsp_tpu_torch.pipelines import registry as treg


SCORE_RTOL = 1e-9  # compat scores: tests/test_gmm.py:136 (the oracle), tests/test_verbose.py:113


def _class_data(rng, n=120, centers=None, spread=2.0):
    if centers is None:
        centers = rng.normal(0, 4, (4, 12))
    return np.array([centers[i % 4] + rng.normal(0, spread, 12) for i in range(n)])


def _verbose_hmm(seed=909, var=0.05):
    """tests/test_verbose.py:86-110's model: projected means N(0, 2), small
    diagonal variances (densities >> 1, so the log-of-log stays finite for a
    while), QR eigenvectors, transitions near uniform."""
    r = np.random.default_rng(seed)
    states = []
    for _ in range(6):
        mean = np.zeros((4, 12))
        mean[:, :4] = r.normal(0, 2, (4, 4))
        cov = np.stack([np.eye(12) * var for _ in range(4)])
        ev = np.stack([np.linalg.qr(r.normal(0, 1, (12, 4)))[0] for _ in range(4)])
        states.append((np.full(4, 0.25), mean, cov, ev))
    trans = r.dirichlet(np.ones(6), size=6) + 0.5
    trans /= trans.sum(axis=1, keepdims=True)
    return states, trans, r


def _verbose_obs(states, r, T):
    seq = r.integers(0, 6, T)
    return np.stack([states[s][3][0] @ states[s][1][0][:4] + r.normal(0, 0.02, 12) for s in seq])


def _trained_hmm():
    """tests/test_gmm.py:130-154's HMM: six states trained by JAX's
    train_class on distinct clusters, and a 20-frame observation."""
    rng = np.random.default_rng(19)
    states = []
    for _ in range(6):
        c = rng.normal(0, 6, (4, 12))
        a, m, cv, e8 = (np.asarray(x) for x in jg.train_class([_class_data(rng, 100, c)]))
        states.append(js.train_to_test_params(a, m, cv, e8))
    trans = rng.uniform(0.05, 1.0, (6, 6))
    trans /= trans.sum(axis=1, keepdims=True)
    return states, trans, _class_data(rng, 20)


def _random_hmm(seed, T, dtype=np.float64):
    """tests/test_gmm.py:392-406's model: unit-ish densities (< 1), so the
    compat recursion meets log(negative) = NaN."""
    rng = np.random.default_rng(seed)
    alpha = rng.dirichlet(np.ones(4), 6)
    mean = rng.normal(0, 1, (6, 4, 12))
    cov = np.broadcast_to(np.eye(12), (6, 4, 12, 12)) * 1.5
    ev = np.broadcast_to(np.eye(12)[:, :4], (6, 4, 12, 4))
    trans = rng.dirichlet(np.ones(6), 6)
    feats = rng.normal(0, 1.0, (T, 12))
    return [np.ascontiguousarray(a, dtype) for a in (feats, alpha, mean, cov, ev, trans)]


def _stack(states, trans):
    return [np.stack([s[i] for s in states]) for i in range(4)] + [np.asarray(trans)]


def _probes():
    states, trans, r = _verbose_hmm()
    obs = _verbose_obs(states, r, 16)
    t_states, t_trans, t_obs = _trained_hmm()
    return {
        "verbose-model T=16": (obs, _stack(states, trans)),
        "verbose-model T=64": (_verbose_obs(states, r, 64), _stack(states, trans)),
        "trained T=20": (t_obs, _stack(t_states, t_trans)),
        **{f"densities<1 T={T}": (lambda a: (a[0], a[1:]))(_random_hmm(99, T)) for T in (1, 2, 5, 64)},
    }


PROBES = _probes()


def _port(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same_score(got, want, rtol=SCORE_RTOL):
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol)


def test_emissions_against_jax():
    """(T, 6) densities within 1e-12 of each column's largest finite value of
    JAX's, NaN where JAX's are (the trained HMM has NaN states)."""
    for obs, model in PROBES.values():
        want = np.asarray(jh.emissions(jnp.asarray(obs), *(jnp.asarray(a) for a in model[:4])))
        got = th.emissions(*_port([obs] + model[:4])).numpy()
        assert got.shape == want.shape == (len(obs), 6)
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        scale = np.fmax.reduce(np.abs(want), 0)
        assert (nan | (np.abs(got - want) <= 1e-12 * scale)).all()


@pytest.mark.parametrize("name", list(PROBES))
def test_viterbi_compat_against_jax_and_oracle(name):
    """Compat decode: paths equal to JAX's and to oracle/viterbi.hmm_decode,
    NaN cases included; scores equal NaN or within rtol 1e-9; full=True's
    per-time bests equal JAX's likewise."""
    obs, model = PROBES[name]
    path, score, bests = th.viterbi(*_port([obs] + model), compat=True, full=True)
    jp, js_, jb = jh.viterbi(jnp.asarray(obs), *(jnp.asarray(a) for a in model), compat=True,
                             full=True)
    states = [(model[0][m], model[1][m], np.stack([np.diag(c)[:4] for c in model[2][m]]),
               model[3][m]) for m in range(6)]
    op, os_ = ov.hmm_decode(obs, states, model[4])
    assert path.dtype == torch.int32 and path.shape == (max(len(obs) - 1, 0),)
    assert np.array_equal(path.numpy(), np.asarray(jp)) and np.array_equal(path.numpy(), op)
    _same_score(float(score), float(js_))
    if len(obs) > 1:  # the oracle's score stays 0.0 at T = 1, JAX's clamps to t = 0
        _same_score(float(score), os_)
    np.testing.assert_allclose(bests.numpy(), np.asarray(jb), rtol=SCORE_RTOL)  # NaN equal


def test_compat_probes_cover_nan_and_finite():
    scores = [float(th.viterbi(*_port([o] + m))[1]) for o, m in PROBES.values()]
    assert any(np.isnan(s) for s in scores) and any(np.isfinite(s) for s in scores)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("T", [1, 2, 5, 64, 301])
def test_corrected_and_assoc_against_jax(T, dtype):
    """tests/test_gmm.py:388-406: viterbi(compat=False) and viterbi_assoc
    against JAX's and each other: paths equal, scores within rtol 1e-5 and
    atol 1e-2 (the max-plus sums group differently)."""
    arrays = _random_hmm(99 + T, T, dtype)
    j = [jnp.asarray(a) for a in arrays]
    p_seq, s_seq = th.viterbi(*_port(arrays), compat=False)
    p_as, s_as = th.viterbi_assoc(*_port(arrays))
    for got_p, got_s, want in ((p_seq, s_seq, jh.viterbi(*j, compat=False)),
                               (p_as, s_as, jh.viterbi_assoc(*j)), (p_as, s_as, (p_seq, s_seq))):
        assert got_p.shape == (T,) and np.array_equal(np.asarray(got_p), np.asarray(want[0]))
        np.testing.assert_allclose(float(got_s), float(want[1]), rtol=1e-5, atol=1e-2)


def test_corrected_backtrace_is_optimal():
    """tests/test_gmm.py:340-385 on the port: the corrected path is the
    brute-force best path and its score that path's, rtol 1e-5; the batched
    decode agrees."""
    rng = np.random.default_rng(71)
    S, T = 6, 6
    states = []
    for _ in range(S):
        mn = np.zeros((4, 12))
        mn[:, :4] = rng.normal(0, 2, (4, 4))
        q, _ = np.linalg.qr(rng.normal(0, 1, (12, 12)))
        states.append((np.full(4, 0.25), mn, np.stack([np.eye(12) * 0.8] * 4),
                       np.stack([q[:, :4]] * 4)))
    trans = rng.dirichlet(np.ones(S), size=S)
    obs = rng.normal(0, 1.5, (T, 12))
    model = _port(_stack(states, trans))
    path, score = th.viterbi(torch.from_numpy(obs), *model, compat=False)
    le = np.log(th.emissions(torch.from_numpy(obs), *model[:4]).numpy())
    lt = np.log(trans)

    def path_score(p):
        return le[0, p[0]] + np.log(1.0 / S) + sum(lt[p[i - 1], p[i]] + le[i, p[i]]
                                                  for i in range(1, T))

    best = max(itertools.product(range(S), repeat=T), key=path_score)
    assert tuple(path.tolist()) == best
    np.testing.assert_allclose(float(score), path_score(best), rtol=1e-5)
    paths, _ = th.viterbi_batched(torch.from_numpy(obs[None]), [T], *model, compat=False)
    assert paths[0].tolist() == list(best)


def test_viterbi_batched_against_single_and_jax():
    """tests/test_gmm.py:213-292 on the port: ragged corrected decodes equal
    the single decodes (paths over each length equal, scores within rtol
    1e-12) and JAX's batched call (paths equal, scores rtol 1e-9); compat
    over equal lengths equals the single compat decodes; ragged compat
    raises ValueError before any work."""
    rng = np.random.default_rng(31)
    states = []
    for _ in range(6):
        m = np.zeros((4, 12))
        m[:, :4] = rng.normal(0, 3, (4, 4))
        e, _ = np.linalg.qr(rng.normal(0, 1, (12, 12)))
        states.append((np.full(4, 0.25), m, np.stack([np.eye(12) * (0.5 + 0.2 * k) for k in range(4)]),
                       np.stack([e[:, k:k + 4] for k in range(4)])))
    trans = rng.uniform(0.05, 1.0, (6, 6))
    trans /= trans.sum(axis=1, keepdims=True)
    arrays = _stack(states, trans)
    model, jmodel = _port(arrays), [jnp.asarray(a) for a in arrays]
    lengths = [20, 14, 17]
    utts = [rng.normal(0, 2, (n, 12)) for n in lengths]
    padded = np.zeros((3, 20, 12))
    for i, u in enumerate(utts):
        padded[i, :len(u)] = u
    paths, scores = th.viterbi_batched(torch.from_numpy(padded), torch.tensor(lengths), *model)
    jpaths, jscores = jh.viterbi_batched(jnp.asarray(padded), jnp.asarray(lengths), *jmodel)
    assert paths.shape == (3, 20) and np.array_equal(paths.numpy(), np.asarray(jpaths))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-9)
    for i, u in enumerate(utts):
        p1, s1 = th.viterbi(torch.from_numpy(u), *model, compat=False)
        assert paths[i, :lengths[i]].tolist() == p1.tolist()
        np.testing.assert_allclose(float(scores[i]), float(s1), rtol=1e-12)
    eq = np.stack([rng.normal(0, 2, (16, 12)) for _ in range(3)])
    pc, sc = th.viterbi_batched(torch.from_numpy(eq), [16] * 3, *model, compat=True)
    for i in range(3):
        p1, s1 = th.viterbi(torch.from_numpy(eq[i]), *model, compat=True)
        assert pc[i].tolist() == p1.tolist()
        _same_score(float(sc[i]), float(s1))
    with pytest.raises(ValueError, match="compat=True"):
        th.viterbi_batched(torch.from_numpy(padded), lengths, *model, compat=True)


def test_train_hmm_segments_and_decodes():
    """tests/test_gmm.py:157-195's input and assertions on the port (f32):
    a finite score, every state's frames > 75% from one true region, all
    three regions covered, at most 12 transitions."""
    rng = np.random.default_rng(20260817)  # tests/conftest.py's session seed, drawn afresh
    T = 120
    centers = np.array([[8.0] + [0.0] * 11, [0.0, 8.0] + [0.0] * 10, [0.0, 0.0, 8.0] + [0.0] * 9])
    truth = np.repeat([0, 1, 2], T // 3)
    sig = np.array([1.0, 1.0, 1.0, 1.0] + [0.05] * 8)
    frames = centers[truth] + rng.normal(0, 1, (T, 12)) * sig
    out = th.train_hmm(torch.from_numpy(frames.astype(np.float32)), n_iter=3)
    path = out["path"].numpy()
    assert path.shape == (T,) and np.isfinite(float(out["score"]))
    covered = set()
    for s in np.unique(path):
        labels, cnt = np.unique(truth[path == s], return_counts=True)
        assert cnt.max() / cnt.sum() > 0.75, (s, labels, cnt)
        covered.add(int(labels[np.argmax(cnt)]))
    assert covered == {0, 1, 2}, covered
    assert (np.diff(path) != 0).sum() <= 12, path


def test_train_hmm_recovers_known_parameters():
    """tests/test_gmm.py:295-335's input and assertions on the port (f32):
    back-projected state means point along their own axis (within 2.0 of
    10, off-axis below 2.5), self-loops above 0.7, the decode within 10% of
    the generating path."""
    rng = np.random.default_rng(47)
    true_means = np.zeros((6, 12))
    for s in range(6):
        true_means[s, s] = 10.0
    durations = rng.integers(22, 29, 6)
    truth = np.concatenate([np.full(d, s) for s, d in enumerate(durations)])
    sig = np.array([1.0] * 6 + [0.1] * 6)
    frames = true_means[truth] + rng.normal(0, 1, (len(truth), 12)) * sig
    out = th.train_hmm(torch.from_numpy(frames.astype(np.float32)), n_iter=4)
    alpha, mean8, ev8 = (out[k].numpy() for k in ("alpha", "mean", "eigvec"))
    state_mean = np.einsum("sk,ski->si", alpha, np.einsum("skij,skj->ski", ev8, mean8[..., :8])
                           ) / alpha.sum(axis=1, keepdims=True)
    for s in range(6):
        assert int(np.argmax(np.abs(state_mean[s]))) == s, state_mean[s]
        assert abs(state_mean[s][s] - 10.0) < 2.0, state_mean[s]
        assert np.abs(np.delete(state_mean[s], s)).max() < 2.5, state_mean[s]
    assert (np.diag(out["trans"].numpy()) > 0.7).all()
    assert (out["path"].numpy() == truth).mean() > 0.9


def test_train_hmm_replaces_an_empty_state():
    """A state that keeps no frame fits NaN and is replaced by a far-away
    unit Gaussian (alpha 1/4, mean 1e6, identity covariance), so the decode
    stays finite."""
    from jeicyboodsp_tpu_torch.models import gmm as tg

    frames = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (24, 12)))
    masks = torch.zeros(6, 24, dtype=torch.bool)
    masks[:, :4] = True
    masks[5] = False
    fit = tg.train_classes_batched(frames.expand(6, 24, 12), masks, cov_floor=1e-2)
    assert not torch.isfinite(fit[0][5]).any()
    out = th.train_hmm(torch.cat([frames[:12], frames[:12] + 30]), n_iter=2)
    assert np.isfinite(float(out["score"])) and out["path"].shape == (24,)


# ---- model files, the viterbi pipeline and CLI --------------------------------------


def test_hmm_files_cross_both_ways(tmp_path):
    """pack_hmm/unpack_hmm round trip; a file written by either package
    reads in the other to identical arrays."""
    states, trans, _ = _verbose_hmm(23)
    blob = ts.pack_hmm(states, trans)
    assert blob == js.pack_hmm(states, trans)
    for unpack in (ts.unpack_hmm, js.unpack_hmm):
        back_states, back_trans = unpack(blob)
        assert back_trans.tobytes() == np.asarray(trans, "<f8").tobytes()
        for s, b in zip(states, back_states):
            for x, y in zip(s, b):
                assert np.asarray(x, "<f8").tobytes() == y.tobytes()
    with pytest.raises(ValueError):
        ts.pack_hmm([(a, m, c, np.zeros((4, 12, 8))) for a, m, c, _ in states], trans)


@pytest.fixture(scope="module")
def hmm_files(tmp_path_factory):
    """The verbose model as an HMM file and two observation files (16 and
    40 frames) in one list."""
    tmp = tmp_path_factory.mktemp("hmm")
    states, trans, r = _verbose_hmm()
    model = str(tmp / "hmm.bin")
    with open(model, "wb") as f:
        f.write(js.pack_hmm(states, trans))
    paths = []
    for T in (16, 40):
        p = str(tmp / f"obs{T}.mfc")
        _verbose_obs(states, r, T).astype("<f8").tofile(p)
        paths.append(p)
    lst = str(tmp / "v.lst")
    with open(lst, "w") as f:
        f.write(" ".join(paths))
    return lst, model


def _run(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(*args, **kw)
    return out.getvalue(), res


@pytest.mark.parametrize("verbose", [True, False], ids=["verbose", "plain"])
def test_viterbi_pipeline_lines_against_jax(hmm_files, verbose):
    """The viterbi pipeline on JAX's model file: with --verbose the 'max
    accumulated prob' values within rtol 1e-9 of JAX's (NaN equal) and the
    'decoding result ! ' and '%d ,' path lines identical; without, every
    line identical.  Through cli.main, the same text."""
    lst, model = hmm_files
    want, jres = _run(jreg.viterbi, lst, model, verbose=verbose)
    got, _ = _run(main, ["viterbi", lst, model, "--device", "cpu"]
                  + (["--verbose"] if verbose else []))
    pat = r"max accumulated prob (\S+)"
    if verbose:
        w = np.array(re.findall(pat, want), np.float64)
        g = np.array(re.findall(pat, got), np.float64)
        assert len(w) == 15 + 39 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=SCORE_RTOL, atol=0)
    strip = lambda s: [ln for ln in s.splitlines() if "max accumulated" not in ln]  # noqa: E731
    assert strip(got) == strip(want) and len(strip(want)) == 4
    _, pres = _run(treg.viterbi, lst, model, verbose=verbose, device="cpu")
    for (gp, gs), (wp, ws) in zip(pres, jres):
        assert np.array_equal(gp, wp)
        _same_score(gs, ws)


def test_viterbi_pipeline_corrected_and_refusals(hmm_files):
    """compat=False prints the corrected paths, equal to JAX's; --fast and
    --engine are refused."""
    lst, model = hmm_files
    want, _ = _run(jreg.viterbi, lst, model, compat=False)
    got, _ = _run(treg.viterbi, lst, model, compat=False, device="cpu")
    assert got == want
    for extra in (["--fast"], ["--engine", "xla"]):
        with pytest.raises(SystemExit):
            main(["viterbi", lst, model, "--device", "cpu"] + extra)


def test_speech_decode_against_jax():
    """speech_decode in f64 on an 8-block utterance of three tones with an
    HMM of six states: six tone classes of tests/test_torch_features.py (24
    blocks each) trained by JAX's speech_train, in the test layout.  Compat and corrected: paths equal,
    scores equal NaN or within rtol 1e-9."""
    from jeicyboodsp_tpu.pipelines.speech import speech_decode as jax_decode
    from jeicyboodsp_tpu.pipelines.speech import speech_train as jax_train
    from jeicyboodsp_tpu_torch.pipelines.speech import speech_decode

    from test_torch_gmm import _tones

    audio = _tones(6, 24)
    a, m, cv, e8 = (np.asarray(x) for x in jax_train(jnp.asarray(audio), dtype=jnp.float64))
    trans = np.random.default_rng(3).dirichlet(np.ones(6), 6)
    model = [a, m, cv, e8[..., :4], trans]
    utt = np.ascontiguousarray(np.concatenate([audio[0, :3], audio[1, :3], audio[2, :2]]))
    for compat in (True, False):
        wp, ws = jax_decode(jnp.asarray(utt), *(jnp.asarray(x) for x in model), dtype=jnp.float64,
                            compat=compat)
        gp, gs = speech_decode(torch.from_numpy(utt), *th.hmm_to_port(*model, "cpu"),
                               dtype=torch.float64, compat=compat)
        assert np.array_equal(gp.numpy(), np.asarray(wp))
        _same_score(float(gs), float(ws))


def test_port_hmm_decode_equals_the_oracle():
    """The port's oracle's reference_hmm_decode (which the card tests hold
    the port to) gives oracle/viterbi.hmm_decode's
    bytes on every probe, and its printed values are JAX's full=True bests
    from t = T-1 down to 1."""
    for obs, model in PROBES.values():
        states = [(model[0][m], model[1][m], np.stack([np.diag(c)[:4] for c in model[2][m]]),
                   model[3][m]) for m in range(6)]
        bests = []
        gp, gs = port_ov.reference_hmm_decode(obs, states, model[4], bests)
        wp, ws = ov.hmm_decode(obs, states, model[4])
        assert gp.tobytes() == wp.tobytes() and np.float64(gs).tobytes() == np.float64(ws).tobytes()
        jb = np.asarray(jh.viterbi(jnp.asarray(obs), *(jnp.asarray(a) for a in model), full=True)[2])
        np.testing.assert_allclose(bests, jb[1:][::-1], rtol=SCORE_RTOL)
