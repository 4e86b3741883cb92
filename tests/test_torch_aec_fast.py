"""The port's f32 echo cancellers (``nlms --fast``, ``bnlms --fast``: the f32
instances of K8 and K9 through their plain versions here), the NLMS
``--verbose`` lines and the time-parallel BNLMS, against the f64 oracle and
the JAX package's f32 ops.

JAX's f32 ops have no test of their own (tests/test_nlms.py runs f64), so
the rule is relative: on tests/test_nlms.py's signals the port's f32 SNR
against the oracle must be at least JAX's f32 SNR on the same input less
0.5 dB, and at least that file's floors (60 dB est, 40 dB err); both numbers
are printed.  The port keeps the f64 kernels' exact window energies and the
exact double-talk gate where JAX's f32 op sums them in f32.
"""

import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.oracle import nlms as onl
from jeicyboodsp_tpu.ops import nlms as jnl
from jeicyboodsp_tpu_torch.kernels import bnlms as K9
from jeicyboodsp_tpu_torch.kernels import nlms as K8
from jeicyboodsp_tpu_torch.ops import nlms as TN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOORS = (60.0, 40.0)  # est, err: tests/test_nlms.py:24-26
SLACK_DB = 0.5
F32 = torch.float32


def _snr(ref, test):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    return np.inf if not (err ** 2).sum() else 10 * np.log10((ref ** 2).sum() / (err ** 2).sum())


def _signals(n, seed=20260817):
    """tests/test_nlms.py:_signals: far end N(0, 3000), echo through 32 taps
    (lead 0.5) plus N(0, 50) noise."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    ref = np.clip(np.convolve(x.astype(np.float64), h)[:n] + rng.normal(0, 50, n),
                  -32768, 32767).astype(np.int16)
    return x, ref


RUNS = {"nlms": (onl.run_nlms, jnl.run_nlms_stream, TN.run_nlms_stream),
        "bnlms": (onl.run_bnlms, jnl.run_bnlms_stream, TN.run_bnlms_stream)}


def _hold_to_jax(name, oracle, jax_out, port_out):
    sj = [_snr(o, j) for o, j in zip(oracle, jax_out)]
    sp = [_snr(o, p) for o, p in zip(oracle, port_out)]
    print(f"{name}: f32 SNR against the oracle, est/err: port {sp[0]:.2f}/{sp[1]:.2f} dB, "
          f"JAX {sj[0]:.2f}/{sj[1]:.2f} dB")
    for p, j, floor in zip(sp, sj, FLOORS):
        assert p >= j - SLACK_DB and p >= floor, (sp, sj)


@pytest.mark.parametrize("n", [1024 * 3 + 100, 1024 * 12 + 100])
@pytest.mark.parametrize("kind", sorted(RUNS))
def test_f32_ops_at_least_as_close_as_jax(kind, n):
    oracle, jax_run, port_run = RUNS[kind]
    x, ref = _signals(n)
    o = oracle(x, ref)
    j = jax_run(x, ref, dtype=jnp.float32)
    p = port_run(x, ref, dtype=F32, device="cpu")
    assert len(p[0]) == len(o[0]) and p[0].dtype == np.int16
    _hold_to_jax(f"{kind} n={n}", o, j, p)


def test_nlms_f32_chunked_equals_whole_and_state_keeps_f32():
    x, r = _signals(2048 + 300, 5)
    st = TN.nlms_init_state(F32)
    es = []
    for s in range(0, len(x), 900):
        e, _, st = TN.nlms_apply(torch.from_numpy(x[s:s + 900]), torch.from_numpy(r[s:s + 900]),
                                 st, dtype=F32)
        es.append(e.numpy())
    ew, _, sw = TN.nlms_apply(torch.from_numpy(x), torch.from_numpy(r), TN.nlms_init_state(F32),
                              dtype=F32)
    np.testing.assert_array_equal(np.concatenate(es), ew.numpy())
    assert st["coeff"].dtype == F32 and torch.equal(st["coeff"], sw["coeff"])
    # a JAX f32 state converts to the kernel's tuple and back without loss, dtype kept
    _, _, sj = jnl.nlms_apply(jnp.asarray(x[:1500]), jnp.asarray(r[:1500]),
                              jnl.nlms_init_state(jnp.float32), dtype=jnp.float32)
    back = TN.state_to_jax(TN.state_to_port(sj))
    assert back["coeff"].dtype == F32
    for k in ("hist", "coeff"):
        assert back[k].numpy().tobytes() == np.asarray(sj[k]).tobytes(), k


def test_bnlms_f32_chunked_equals_whole():
    x, r = _signals(5 * 1024, 6)
    xb, rb = torch.from_numpy(x.reshape(5, 1024)), torch.from_numpy(r.reshape(5, 1024))
    ew, rw, sw = TN.bnlms_apply(xb, rb, TN.bnlms_init_state(F32), dtype=F32)
    e1, r1, s = TN.bnlms_apply(xb[:2], rb[:2], TN.bnlms_init_state(F32), dtype=F32)
    e2, r2, s = TN.bnlms_apply_block(xb[2], rb[2], s, dtype=F32)
    e3, r3, s = TN.bnlms_apply(xb[3:], rb[3:], s, dtype=F32)
    assert torch.equal(torch.cat([e1, e2[None], e3]), ew)
    assert torch.equal(torch.cat([r1, r2[None], r3]), rw)
    for k in sw:
        assert torch.equal(s[k], sw[k]), k
    assert sw["coeff"].dtype == F32


def test_f32_plain_versions_follow_the_jax_update():
    """One sample of K8 f32 and one block of K9 f32 from a nonzero state,
    written out in numpy float32: the estimate in the kernels' order, g =
    RN(RN(2 MU e) / d) with d from the exact energy, c += RN(g w)."""
    rng = np.random.default_rng(3)
    c = rng.normal(0, 1e-2, 256).astype(np.float32)
    hist = rng.integers(-3000, 3000, 255).astype(np.int16)
    x, r = np.int16(1234), np.int16(-321)
    est, err, (cn, _) = K8.nlms_f32(torch.tensor([[x]]), torch.tensor([[r]]),
                                    (torch.from_numpy(c[None]), torch.from_numpy(hist[None])))
    w = np.concatenate([hist, [x]]).astype(np.float32)
    y = int(K8.tree_dot(torch.from_numpy(c), torch.from_numpy(w[::-1].copy())))
    assert int(est[0, 0]) == y
    e = np.float32(int(r) - y)
    d = np.float32(np.float32(float((w.astype(np.int64) ** 2).sum())) + np.float32(K8.EPS))
    g = np.float32(np.float32(np.float32(2 * np.float32(K8.MU)) * e) / d)
    np.testing.assert_array_equal(cn[0].numpy(), c + np.float32(g) * w)
    assert int(err[0, 0]) == int(r) - y


def test_other_dtypes_and_mismatched_states_raise():
    x = torch.zeros(1024, dtype=torch.int16)
    with pytest.raises(ValueError):
        TN.nlms_apply(x, x, TN.nlms_init_state(), dtype=torch.float16)
    with pytest.raises(ValueError):
        TN.nlms_init_state(torch.bfloat16)
    with pytest.raises(ValueError):  # an f64 state handed to the f32 op
        TN.nlms_apply(x, x, TN.nlms_init_state(), dtype=F32)
    with pytest.raises(ValueError):
        TN.bnlms_apply(x[None], x[None], TN.bnlms_init_state(F32))
    with pytest.raises(ValueError):  # K8's f32 wrapper takes f32 coefficients only
        K8.nlms_f32(x[None], x[None], K8.init_state(1))


def test_gates_exact_and_jax_f32_gate_flips_counted():
    """The f32 path keeps the exact gate; JAX's f32 op decides it in f32
    (``_double_talk``), which can differ only where the largest correlation
    lies within rounding of zero.  The decisions that differ on the probes
    are counted and printed: none on these."""
    flips, total = 0, 0
    for seed in (1, 2, 3):
        x, r = _signals(6 * 1024, seed)
        if seed == 2:
            r = (-r.astype(np.int32)).clip(-32768, 32767).astype(np.int16)  # shut gates
        xb, rb = x.reshape(1, -1), r.reshape(1, -1)
        keep = torch.zeros(1, 127, dtype=torch.int16)
        exact = K9.bnlms_gates(torch.from_numpy(xb), torch.from_numpy(rb), keep, keep)[0]
        u = np.concatenate([np.zeros(127, np.int32), x.astype(np.int32)])
        rr = np.concatenate([np.zeros(127, np.int32), r.astype(np.int32)])
        for k in range(6):
            seg = slice(k * 1024, k * 1024 + 1151)
            dt = bool(jnl._double_talk(jnp.asarray(u[seg]), jnp.asarray(rr[seg]), jnp.float32))
            flips += (not dt) != bool(exact[k])
            total += 1
    print(f"JAX's f32 gate against the exact gate: {flips} of {total} decisions differ")
    assert flips == 0


def _verbose_lines(text):
    return re.findall(r"rgsdCoefficient\[0\] (\S+), rgsdCoefficient\[1\] (\S+), "
                      r"rgsdCoefficient\[2\] (\S+) \n", text)


def test_nlms_verbose_prints_the_reference_trajectory():
    """--verbose: one line a block, the oracle's coefficients after each
    block under %f, equal to JAX's lines (its native kernel is built here);
    nothing under f32 or compat=False, as JAX."""
    from jeicyboodsp_tpu import native

    x, r = _signals(4 * 1024 + 300, 7)
    buf = io.StringIO()
    with redirect_stdout(buf):
        est, err = TN.run_nlms_stream(x, r, verbose=True, device="cpu")
    got = buf.getvalue()
    st = onl.NLMSState()
    want = []
    for s in range(0, len(x), 1024):
        bx, br = x[s:s + 1024], r[s:s + 1024]
        if len(bx) < 1024:  # the stale tail of the previous block
            bx = np.concatenate([bx, x[s - 1024 + len(bx):s]])
            br = np.concatenate([br, r[s - 1024 + len(br):s]])
        onl.nlms_block(st, bx, br)
        want.append("rgsdCoefficient[0] %f, rgsdCoefficient[1] %f, rgsdCoefficient[2] %f \n"
                    % tuple(st.coeff[:3]))
    assert got == "".join(want) and len(want) == 5
    oe, oerr = onl.run_nlms(x, r)
    np.testing.assert_array_equal(est, oe)
    np.testing.assert_array_equal(err, oerr)
    assert native.available()
    buf = io.StringIO()
    with redirect_stdout(buf):
        jnl.run_nlms_stream(x, r, verbose=True)
    assert _verbose_lines(buf.getvalue()) == _verbose_lines(got)
    for kw in ({"dtype": F32}, {"compat": False}):
        buf = io.StringIO()
        with redirect_stdout(buf):
            TN.run_nlms_stream(x, r, verbose=True, device="cpu", **kw)
        assert buf.getvalue() == ""


def _write_files(work, x, r):
    inp, refp = work / "in.wav", work / "ref.pcm"
    with open(inp, "wb") as f:
        f.write(b"\0" * 44)
        x.astype("<i2").tofile(f)
    r.astype("<i2").tofile(refp)
    return inp, refp


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_cli_fast_against_the_jax_cli(tmp_path, kind):
    """``KIND IN REF EST ERR --fast`` through the port's CLI against the JAX
    CLI's ``--fast --cpu``, run in a subprocess with JAX_PLATFORMS=cpu: the
    SNR rule above against the oracle; nlms --verbose through the port's
    CLI prints the oracle's lines."""
    from jeicyboodsp_tpu_torch.cli import main

    x, r = _signals(6 * 1024 + 200, 11)
    inp, refp = _write_files(tmp_path, x, r)
    outs = {}
    for who in ("port", "jax"):
        est, err = tmp_path / f"{who}_est.pcm", tmp_path / f"{who}_err.pcm"
        args = [kind, str(inp), str(refp), str(est), str(err), "--fast"]
        if who == "port":
            assert main(args + ["--device", "cpu"]) == 0
        else:
            env = {**os.environ, "JAX_PLATFORMS": "cpu"}
            subprocess.run([sys.executable, "-m", "jeicyboodsp_tpu.cli", *args, "--cpu"], cwd=ROOT,
                           env=env, check=True, capture_output=True, timeout=600)
        outs[who] = (np.fromfile(est, "<i2"), np.fromfile(err, "<i2"))
    o = RUNS[kind][0](x, r)
    _hold_to_jax(f"{kind} --fast CLI", o, outs["jax"], outs["port"])
    if kind == "nlms":
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([kind, str(inp), str(refp), str(tmp_path / "v1.pcm"),
                         str(tmp_path / "v2.pcm"), "--verbose", "--device", "cpu"]) == 0
        assert len(_verbose_lines(buf.getvalue())) == 7
        np.testing.assert_array_equal(np.fromfile(tmp_path / "v1.pcm", "<i2"), o[0])
    with pytest.raises(SystemExit):
        main(["bnlms", str(inp), str(refp), "a", "b", "--verbose", "--device", "cpu"])


# ---- time-parallel BNLMS


def _tp_probe(T=24, seed=20260817):
    """tests/test_nlms.py:39-65's probe: the echo a 5-sample delay at 0.5."""
    rng = np.random.default_rng(seed)
    far = np.clip(rng.normal(0, 3000, (T, 1024)), -32768, 32767).astype(np.int16)
    echo = 0.5 * np.roll(far.reshape(-1), 5).reshape(T, 1024)
    near = np.clip(echo + rng.normal(0, 150, (T, 1024)), -32768, 32767).astype(np.int16)
    return far, near


def _lsb(want, got, frac=0.01):
    d = np.asarray(want).astype(np.int64) - np.asarray(got).astype(np.int64)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < frac, (np.abs(d).max(), (d != 0).mean())


def test_timeparallel_against_jax_and_the_sequential_path():
    far, near = _tp_probe()
    got = TN.bnlms_apply_timeparallel(torch.from_numpy(far), torch.from_numpy(near))
    want = jnl.bnlms_apply_timeparallel(jnp.asarray(far), jnp.asarray(near), dtype=jnp.float32)
    for g, w in zip(got, want):
        _lsb(np.asarray(w), g.numpy())
    # against the f64 sequential path, tests/test_nlms.py:39-65's bounds
    e_seq, r_seq, _ = TN.bnlms_apply(torch.from_numpy(far), torch.from_numpy(near),
                                     TN.bnlms_init_state())
    d_e = e_seq.numpy().astype(np.int64) - got[0].numpy().astype(np.int64)
    d_r = r_seq.numpy().astype(np.int64) - got[1].numpy().astype(np.int64)
    assert np.abs(d_e).max() <= 2 and np.abs(d_r).max() <= 2
    a = r_seq.numpy().astype(np.float64)
    s = 10 * np.log10(max((a ** 2).sum(), 1e-30) / max((d_r.astype(np.float64) ** 2).sum(), 1e-30))
    print(f"time-parallel against the f64 sequential path: {s:.2f} dB on the error signal")
    assert s >= 60.0


@pytest.mark.parametrize("halo", [False, True])
def test_affine_elements_and_gates_against_jax(halo):
    """A and v within 1e-5 of each block's largest value of JAX's, and the
    gates equal (the count printed), from a zero start and from a halo
    block."""
    far, near = _tp_probe(T=6, seed=3)
    far[1:3] = 0  # block 2's window is silent: its gate shuts
    kw_t, kw_j = {}, {}
    if halo:
        pf, pn = _tp_probe(T=1, seed=4)
        kw_t = {"keep_in": torch.from_numpy(pf[0]), "keep_ref": torch.from_numpy(pn[0])}
        kw_j = {"keep_in": jnp.asarray(pf[0]), "keep_ref": jnp.asarray(pn[0])}
    A, v, W, g = TN.bnlms_affine_elements(torch.from_numpy(far), torch.from_numpy(near), **kw_t)
    JA, Jv, JW, Jg = jnl.bnlms_affine_elements(jnp.asarray(far), jnp.asarray(near),
                                               dtype=jnp.float32, **kw_j)
    np.testing.assert_array_equal(W.numpy(), np.asarray(JW))
    same = int((g.numpy() == np.asarray(Jg)).sum())
    print(f"gates: {same} of {len(g)} equal to JAX's ({int(g.sum())} open)")
    assert same == len(g) and 0 < int(g.sum()) < len(g)
    for got, want in ((A.numpy(), np.asarray(JA)), (v.numpy(), np.asarray(Jv))):
        scale = np.abs(want).reshape(len(want), -1).max(1)
        err = np.abs(got - want).reshape(len(want), -1).max(1)
        assert (err <= 1e-5 * scale).all(), err / scale


def test_timeparallel_empty_and_combine_identity():
    z = torch.zeros(0, 1024, dtype=torch.int16)
    e, r = TN.bnlms_apply_timeparallel(z, z)
    assert e.shape == r.shape == (0, 1024)
    A = torch.randn(3, 128, 128)
    v = torch.randn(3, 128)
    I, zv = torch.eye(128).expand(3, 128, 128), torch.zeros(3, 128)
    for got, want in zip(TN.affine_combine((I, zv), (A, v)), (A, v)):
        assert torch.equal(got, want)


def test_timeparallel_drifts_as_jax_over_a_long_session():
    """Over 96 blocks of the benchmark's kind of signal (a gated tone and its
    room echo) the linearized recursion drifts from the sequential path in
    JAX's op and in the port's alike (ROADMAP R20): the two time-parallel
    forms stay within one step on under 1% of the samples of each other,
    and their error signals' dB against the sequential path agree within
    0.5 dB (printed)."""
    rng = np.random.default_rng(8)
    n = 96 * 1024
    t = np.arange(n) / 16000
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    x = np.clip(sp + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    r = np.clip(np.convolve(x.astype(np.float64), h)[:n], -32768, 32767).astype(np.int16)
    xb, rb = x.reshape(-1, 1024), r.reshape(-1, 1024)
    got = TN.bnlms_apply_timeparallel(torch.from_numpy(xb), torch.from_numpy(rb))
    want = jnl.bnlms_apply_timeparallel(jnp.asarray(xb), jnp.asarray(rb), dtype=jnp.float32)
    for g, w in zip(got, want):
        _lsb(np.asarray(w), g.numpy())
    _, r_seq, _ = TN.bnlms_apply(torch.from_numpy(xb), torch.from_numpy(rb), TN.bnlms_init_state())
    dbs = [_snr(r_seq.numpy(), np.asarray(e)) for e in (got[1].numpy(), want[1])]
    print(f"time-parallel over 96 blocks against the sequential path: port {dbs[0]:.2f} dB, "
          f"JAX {dbs[1]:.2f} dB")
    assert abs(dbs[0] - dbs[1]) <= 0.5


def test_timeparallel_over_the_tp_inputs_session_as_jax():
    """The time-parallel session of torch_inputs.tp_inputs (1024 blocks of the
    benchmark's tiled signal and room) on the CPU: the port's op within one
    step on under 1% of the samples of JAX's (jitted), and both error
    signals' dB against JAX's f64 sequential path (which
    tests/test_torch_nlms.py holds int16-equal to the port's) printed at 16, 64, 256 and 1024 blocks
    and within 0.5 dB of each other: the drift over the whole session is
    the formulation's own (ROADMAP R20)."""
    import jax

    from torch_inputs import tp_inputs

    far, near = tp_inputs("cpu")
    got = TN.bnlms_apply_timeparallel(far, near)
    fj, nj = jnp.asarray(far.numpy()), jnp.asarray(near.numpy())
    want = jax.jit(lambda a, b: jnl.bnlms_apply_timeparallel(a, b, dtype=jnp.float32))(fj, nj)
    for g, w in zip(got, want):
        _lsb(np.asarray(w), g.numpy())
    _, r_seq, _ = jax.jit(lambda a, b: jnl.bnlms_apply(a, b, jnl.bnlms_init_state()))(fj, nj)
    r_seq = np.asarray(r_seq)
    line = []
    for k in (16, 64, 256, len(far)):
        dbs = [_snr(r_seq[:k], np.asarray(e)[:k]) for e in (got[1].numpy(), want[1])]
        line.append(f"{k} blocks port {dbs[0]:.2f} / JAX {dbs[1]:.2f} dB")
        assert abs(dbs[0] - dbs[1]) <= 0.5, line
    print("time-parallel against the f64 sequential path: " + "; ".join(line))
