"""CPU parity of the port's echo cancellers (``jeicyboodsp_tpu_torch.ops.nlms``,
kernels K8 and K9) with the JAX package and the f64 oracle.

On CPU tensors the kernel wrappers run their plain PyTorch versions, so these
tests hold the plain versions' arithmetic; the CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py and by chip_smoke.py.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.kernels import nlms_pallas as jnp_k
from jeicyboodsp_tpu.oracle import nlms as onl
from jeicyboodsp_tpu.ops import nlms as jnl
from jeicyboodsp_tpu_torch.io.wav import stale_blocks
from jeicyboodsp_tpu_torch.kernels import bnlms as K9
from jeicyboodsp_tpu_torch.kernels import nlms as K8
from jeicyboodsp_tpu_torch.ops import nlms as TN


def _echo(n, seed, taps=32, lead=0.5, noise=50.0):
    """Far end N(0, 3000) and its echo through a random room plus near-end
    noise (tests/test_nlms.py's probe)."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, taps)
    h[0] = lead
    r = np.convolve(x.astype(np.float64), h)[:n] + rng.normal(0, noise, n)
    return x, np.clip(r, -32768, 32767).astype(np.int16)


def _oracle_blocks(fn, state, x, ref):
    """The oracle's est and err over whole 1024-sample blocks, every block kept."""
    out = [fn(state, x[s:s + 1024], ref[s:s + 1024])[:2] for s in range(0, len(x), 1024)]
    return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])


def test_constants_equal_the_oracle():
    for name in ("BLOCK_LEN", "NLMS_TAPS", "NLMS_KEEP", "NLMS_MU", "NLMS_EPS", "BNLMS_TAPS",
                 "BNLMS_KEEP", "BNLMS_MU", "BNLMS_EPS"):
        assert getattr(TN, name) == getattr(onl, name), name
    assert (K8.TAPS, K8.MU, K8.EPS) == (onl.NLMS_TAPS, onl.NLMS_MU, onl.NLMS_EPS)
    assert (K9.TAPS, K9.MU, K9.EPS) == (onl.BNLMS_TAPS, onl.BNLMS_MU, onl.BNLMS_EPS)


@pytest.mark.parametrize("n", [0, 100, 1024, 2500])
def test_blockify_matches_jax(n):
    x = np.arange(n, dtype=np.int16)
    np.testing.assert_array_equal(stale_blocks(x, 1024), jnl._blockify(x, 1024))


def test_k8_plain_equals_oracle_and_jax_interpret():
    """Two streams of two blocks: est and err int16-equal to the oracle and
    to JAX nlms_pallas (interpret), whose df32 kernel is oracle-exact here."""
    xs, rs = zip(*(_echo(2048, seed) for seed in (1, 2)))
    x, r = np.stack(xs), np.stack(rs)
    est, err, (c, hist) = K8.nlms(torch.from_numpy(x), torch.from_numpy(r))
    assert est.dtype == err.dtype == torch.int16 and c.shape == (2, 256) and hist.shape == (2, 255)
    for i in range(2):
        oe, oerr = _oracle_blocks(onl.nlms_block, onl.NLMSState(), x[i], r[i])
        np.testing.assert_array_equal(est[i].numpy(), oe)
        np.testing.assert_array_equal(err[i].numpy(), oerr)
    je, jerr = jnp_k.nlms_pallas(jnp.asarray(x), jnp.asarray(r), interpret=True)
    np.testing.assert_array_equal(est.numpy(), np.asarray(je))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def test_k8_plain_state_threading_and_oracle_state():
    """Chained calls (cut mid-block) == one call; after a whole block the
    carried coefficients and history are the oracle's, bit for bit."""
    x, r = _echo(2048, 3)
    xt, rt = torch.from_numpy(x[None]), torch.from_numpy(r[None])
    e1, r1, s = K8.nlms(xt[:, :700].contiguous(), rt[:, :700].contiguous())
    e2, r2, s = K8.nlms(xt[:, 700:].contiguous(), rt[:, 700:].contiguous(), s)
    ew, rw, sw = K8.nlms(xt, rt)
    assert torch.equal(torch.cat([e1, e2], 1), ew) and torch.equal(torch.cat([r1, r2], 1), rw)
    assert torch.equal(s[0], sw[0]) and torch.equal(s[1], sw[1])
    st = onl.NLMSState()
    onl.nlms_block(st, x[:1024], r[:1024])
    _, _, (c, hist) = K8.nlms(xt[:, :1024].contiguous(), rt[:, :1024].contiguous())
    # the running window energy equals the sequential sum, so the update
    # (the oracle's per-tap expression) gives the same coefficients
    assert c[0].numpy().tobytes() == st.coeff.tobytes()
    np.testing.assert_array_equal(hist[0].numpy(), st.keep)


def _sum_seq(p):
    acc = p[:, 0].copy()
    for m in range(1, p.shape[1]):
        acc = acc + p[:, m]
    return acc


def test_tree_dot_order():
    """The plain version's dot is the kernel's tree: 8-term lane sums, then
    halves of the 32 lane sums added pairwise."""
    rng = np.random.default_rng(0)
    c, v = rng.normal(size=(3, 256)), rng.normal(size=(3, 256))
    p = c * v
    s = [_sum_seq(p[:, 8 * g:8 * g + 8]) for g in range(32)]
    while len(s) > 1:
        h = len(s) // 2
        s = [s[i] + s[i + h] for i in range(h)]
    got = K8.tree_dot(torch.from_numpy(c), torch.from_numpy(v)).numpy()
    assert got.tobytes() == s[0].tobytes()


def test_nlms_compat_false_vs_jax():
    """The corrected pairing (g*w reversed) against JAX nlms_apply(compat=
    False): int16-equal on this probe (the two sum the estimate in other
    orders); it converges where the compat quirk diverges."""
    x, r = _echo(3072, 4)
    je, jerr, _ = jnl.nlms_apply(jnp.asarray(x), jnp.asarray(r), jnl.nlms_init_state(),
                                 compat=False)
    te, terr, _ = TN.nlms_apply(torch.from_numpy(x), torch.from_numpy(r), TN.nlms_init_state(),
                                compat=False)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_nlms_apply_chunked_equals_whole_and_state_round_trips():
    x, r = _echo(2048 + 300, 5)
    st = TN.nlms_init_state()
    es, rs = [], []
    for s in range(0, len(x), 900):
        e, rr, st = TN.nlms_apply(torch.from_numpy(x[s:s + 900]), torch.from_numpy(r[s:s + 900]),
                                  st)
        es.append(e.numpy())
        rs.append(rr.numpy())
    ew, rw, sw = TN.nlms_apply(torch.from_numpy(x), torch.from_numpy(r), TN.nlms_init_state())
    np.testing.assert_array_equal(np.concatenate(es), ew.numpy())
    np.testing.assert_array_equal(np.concatenate(rs), rw.numpy())
    assert torch.equal(st["coeff"], sw["coeff"]) and torch.equal(st["hist"], sw["hist"])
    # a JAX state dict converts to the kernel's tuple and back without loss
    _, _, sj = jnl.nlms_apply(jnp.asarray(x[:1500]), jnp.asarray(r[:1500]), jnl.nlms_init_state())
    back = TN.state_to_jax(TN.state_to_port(sj))
    for k in ("hist", "coeff"):
        assert back[k].numpy().tobytes() == np.asarray(sj[k]).tobytes(), k
    # and the port's state after 1500 samples is JAX's history
    _, _, sp = TN.nlms_apply(torch.from_numpy(x[:1500]), torch.from_numpy(r[:1500]),
                             TN.nlms_init_state())
    np.testing.assert_array_equal(sp["hist"].numpy(), np.asarray(sj["hist"]))


def test_run_nlms_stream_matches_oracle():
    """A partial last block, and signals of unequal lengths, where the
    longer one's last block holds its own samples (the JAX op cuts both to
    the shorter length first: ROADMAP R9)."""
    x, r = _echo(3 * 1024 + 100, 6)
    for xi, ri in ((x, r), (x[:2500], r[:2900]), (x[:2900], r[:2500])):
        oe, oerr = onl.run_nlms(xi, ri)
        te, terr = TN.run_nlms_stream(xi, ri, device="cpu")
        np.testing.assert_array_equal(te, oe)
        np.testing.assert_array_equal(terr, oerr)
    e0, r0 = TN.run_nlms_stream(x[:0], r[:0], device="cpu")
    assert e0.shape == r0.shape == (0,)


def _bnlms_probe():
    """Two streams: an echo, whose gate opens on every block, and a
    non-negative far end against a non-positive near end, whose correlations
    are all negative, so the gate stays shut (the gated path of
    tests/test_pallas_kernels.py:119-144)."""
    x, r = _echo(3 * 1024, 7, taps=24, lead=0.6, noise=0.0)
    x2 = np.abs(x.astype(np.int32)).clip(0, 32767).astype(np.int16)
    return np.stack([x, x2]), np.stack([r, -(x2 // 2)])


def test_k9_plain_equals_oracle_and_jax_interpret():
    x, r = _bnlms_probe()
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    keep0 = torch.zeros(2, 127, dtype=torch.int16)
    gates = K9.bnlms_gates(xt, rt, keep0, keep0)
    assert gates[0].tolist() == [True] * 3 and gates[1].tolist() == [False] * 3
    for i in range(2):
        u = np.concatenate([np.zeros(127, np.int16), x[i]]).astype(np.float64)
        v = np.concatenate([np.zeros(127, np.int16), r[i]]).astype(np.float64)
        assert gates[i].tolist() == [not onl.double_talk_state(u[s:s + 1151], v[s:s + 1151])
                                     for s in (0, 1024, 2048)]
    est, err, (c, keep) = K9.bnlms(xt, rt, gates)
    for i in range(2):
        oe, oerr = _oracle_blocks(onl.bnlms_block, onl.BNLMSState(), x[i], r[i])
        np.testing.assert_array_equal(est[i].numpy(), oe)
        np.testing.assert_array_equal(err[i].numpy(), oerr)
    assert c[1].abs().max() == 0  # never updated
    je, jerr = jnp_k.bnlms_pallas(jnp.asarray(x), jnp.asarray(r), interpret=True)
    np.testing.assert_array_equal(est.numpy(), np.asarray(je))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def test_k9_plain_state_is_the_oracles():
    x, r = _echo(2 * 1024, 8)
    st = onl.BNLMSState()
    for s in (0, 1024):
        onl.bnlms_block(st, x[s:s + 1024], r[s:s + 1024])
    _, _, new = TN.bnlms_apply(torch.from_numpy(x.reshape(2, 1024)),
                               torch.from_numpy(r.reshape(2, 1024)), TN.bnlms_init_state())
    assert new["coeff"].numpy().tobytes() == st.coeff.tobytes()
    np.testing.assert_array_equal(new["keep_in"].numpy(), st.keep_in)
    np.testing.assert_array_equal(new["keep_ref"].numpy(), st.keep_ref)


def _gate_case(case):
    """(x, r, keep, keep_r) of three streams of 4 blocks.  Cases 0-2: echoes
    of either sign and pure noise, from the seed.  "small": the largest
    correlation of every block is small and positive among negative ones
    (an impulse far end, so corr[k] = r[k], against a near end of -1000
    with one +1 or +2), or exactly zero (a far end that meets only zeros of
    the near end), which rounding could lift above zero."""
    if case != "small":
        rng = np.random.default_rng(case)
        x = rng.integers(-3000, 3000, (3, 4 * 1024)).astype(np.int16)
        r = np.stack([x[0] // 2, -(x[1] // 2), rng.integers(-3000, 3000, 4 * 1024)])
        keep = rng.integers(-3000, 3000, (3, 127))
        keep_r = rng.integers(-3000, 3000, (3, 127))
        return x, r.astype(np.int16), keep.astype(np.int16), keep_r.astype(np.int16)
    x = np.zeros((3, 4 * 1024), np.int16)
    r = np.full((3, 4 * 1024), -1000, np.int16)
    keep = np.zeros((3, 127), np.int16)
    keep_r = np.full((3, 127), -1000, np.int16)
    for k in range(4):
        s = k * 1024
        x[0, s] = x[1, s] = 1  # buffer index 127: corr[j] = r's buffer value at 127 + j
        r[0, s + 500 + 37 * k] = 1 + (k % 2)
        r[1, s: s + 1024] = np.where(np.arange(1024) % 3 == 0, 0, -1000)
        x[2, s + 1] = 5  # meets the near end's zeros only: every correlation 0 or < 0
        r[2, s:s + 1024:2] = 0
    keep_r[1] = 0
    return x, r, keep, keep_r


@pytest.mark.parametrize("case", [0, 1, 2, "small"])
def test_bnlms_gates_match_oracle(case):
    """The f64 FFT gate against the oracle's direct f64 sums, block by
    block, on echoes of either sign and pure noise, and on blocks whose
    largest correlation is +1, +2 or 0."""
    x, r, keep, keep_r = _gate_case(case)
    got = K9.bnlms_gates(torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(keep),
                         torch.from_numpy(keep_r)).numpy()
    wants = []
    for i in range(3):
        u = np.concatenate([keep[i], x[i]])
        v = np.concatenate([keep_r[i], r[i]])
        for k in range(4):
            s = k * 1024
            want = not onl.double_talk_state(u[s:s + 1151].astype(np.float64),
                                             v[s:s + 1151].astype(np.float64))
            assert bool(got[i, k]) == want, (i, k)
            wants.append(want)
    if case == "small":
        assert wants == [True] * 4 + [False] * 8


def test_bnlms_apply_chunked_equals_whole_and_vs_jax():
    x, r = _echo(4 * 1024, 9)
    xb, rb = torch.from_numpy(x.reshape(4, 1024)), torch.from_numpy(r.reshape(4, 1024))
    ew, rw, sw = TN.bnlms_apply(xb, rb, TN.bnlms_init_state())
    e1, r1, s = TN.bnlms_apply(xb[:1], rb[:1], TN.bnlms_init_state())
    e2, r2, s = TN.bnlms_apply_block(xb[1], rb[1], s)  # one block
    e3, r3, s = TN.bnlms_apply(xb[2:], rb[2:], s)
    assert torch.equal(torch.cat([e1, e2[None], e3]), ew)
    assert torch.equal(torch.cat([r1, r2[None], r3]), rw)
    for k in ("keep_in", "keep_ref", "coeff"):
        assert torch.equal(s[k], sw[k]), k
    je, jerr, sj = jnl.bnlms_apply(jnp.asarray(x.reshape(4, 1024)), jnp.asarray(r.reshape(4, 1024)),
                                   jnl.bnlms_init_state())
    np.testing.assert_array_equal(ew.numpy(), np.asarray(je))
    np.testing.assert_array_equal(rw.numpy(), np.asarray(jerr))
    back = TN.state_to_jax(TN.state_to_port(sj))
    for k in ("keep_in", "keep_ref", "coeff"):
        assert back[k].numpy().tobytes() == np.asarray(sj[k]).tobytes(), k
        if k != "coeff":
            np.testing.assert_array_equal(sw[k].numpy(), np.asarray(sj[k]))


def test_run_bnlms_stream_matches_oracle():
    x, r = _echo(3 * 1024 + 500, 10)
    for xi, ri in ((x, r), (x[:2500], r[:3000])):
        oe, oerr = onl.run_bnlms(xi, ri)
        te, terr = TN.run_bnlms_stream(xi, ri, device="cpu")
        np.testing.assert_array_equal(te, oe)
        np.testing.assert_array_equal(terr, oerr)
    e0, r0 = TN.run_bnlms_stream(x[:0], r[:0], device="cpu")
    assert e0.shape == r0.shape == (0,)


def test_ops_reject_mismatched_shapes():
    z = np.zeros((2, 1024), np.int16)
    with pytest.raises(ValueError):
        TN.nlms_apply(z[0], z[0, :1000], TN.nlms_init_state())
    with pytest.raises(ValueError):
        TN.bnlms_apply(z, z[:1], TN.bnlms_init_state())
    with pytest.raises(ValueError):  # blocks are 1024 samples long
        TN.bnlms_apply(z.reshape(1, 2048), z.reshape(1, 2048), TN.bnlms_init_state())
    with pytest.raises(ValueError):
        TN.bnlms_apply_block(z[0, :1000], z[0, :1000], TN.bnlms_init_state())


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 2048, dtype=torch.int16)
    gates = torch.ones(2, 2, dtype=torch.bool)
    for bad in (x.to(torch.int32), x[0], x[:, ::2], x.to("meta")):
        with pytest.raises(ValueError):
            K8.nlms(bad, x)
        with pytest.raises(ValueError):
            K9.bnlms(bad, x, gates)
    with pytest.raises(ValueError):
        K8.nlms(x, x[:, :100])
    with pytest.raises(ValueError):
        K8.nlms(x, x, K8.init_state(3))
    with pytest.raises(ValueError):
        K9.bnlms(x[:, :1000].contiguous(), x[:, :1000].contiguous(), gates)  # not whole blocks
    with pytest.raises(ValueError):
        K9.bnlms(x, x, gates.to(torch.uint8))
    with pytest.raises(ValueError):
        K9.bnlms(x, x, gates[:, :1].contiguous())


def test_pipelines_nlms_bnlms_file_end_to_end(tmp_path):
    """The input's 44-byte header is skipped, the reference's is not; the
    files equal the oracle's bytes."""
    from jeicyboodsp_tpu_torch.cli import main
    from jeicyboodsp_tpu_torch.pipelines import registry

    x, r = _echo(2 * 1024 + 300, 11)
    hdr = np.arange(22, dtype=np.int16)
    inp, ref = tmp_path / "in.wav", tmp_path / "ref.pcm"
    np.concatenate([hdr, x]).tofile(inp)
    r.tofile(ref)
    for name, oracle in (("nlms", onl.run_nlms), ("bnlms", onl.run_bnlms)):
        est, err = tmp_path / f"{name}_est.pcm", tmp_path / f"{name}_err.pcm"
        registry.PIPELINES[name](str(inp), str(ref), str(est), str(err), device="cpu")
        oe, oerr = oracle(x, r)
        np.testing.assert_array_equal(np.fromfile(est, "<i2"), oe)
        np.testing.assert_array_equal(np.fromfile(err, "<i2"), oerr)
        cli_est, cli_err = tmp_path / "cli_est.pcm", tmp_path / "cli_err.pcm"
        assert main([name, str(inp), str(ref), str(cli_est), str(cli_err), "--device", "cpu"]) == 0
        np.testing.assert_array_equal(np.fromfile(cli_est, "<i2"), oe)
        np.testing.assert_array_equal(np.fromfile(cli_err, "<i2"), oerr)


def test_cli_checks_arity_and_engine():
    from jeicyboodsp_tpu_torch.cli import main

    for argv in (["nlms", "a", "b"], ["geq", "a"], ["geq", "a", "b", "--engine", "mxu8"]):
        with pytest.raises(SystemExit):
            main(argv)


def test_chip_smoke_aec_references_match_oracle():
    """chip_smoke.py's own float64 NLMS / BNLMS references (it may not import
    the JAX package) equal the oracle: est, err and the BNLMS gates, with a
    partial block, unequal lengths, a shut gate and an empty payload."""
    from jeicyboodsp_tpu_torch.oracle import nlms as port_oracle

    x, r = _echo(3 * 1024 + 200, 12)
    xs = np.abs(x.astype(np.int32)).clip(0, 32767).astype(np.int16)
    for xi, ri in ((x, r), (x[:2500], r[:2900]), (xs, -(xs // 2)), (x[:0], r[:0])):
        for bn, oracle in ((False, onl.run_nlms), (True, onl.run_bnlms)):
            got = port_oracle.reference_nlms(xi, ri, bnlms=bn)
            want = oracle(xi, ri)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    st = onl.BNLMSState()
    wants = [not onl.double_talk_state(
        np.concatenate([st.keep_in, xs[s:s + 1024]]).astype(np.float64),
        np.concatenate([st.keep_ref, -(xs[s:s + 1024] // 2)]).astype(np.float64))
        for s in (0,)]
    assert port_oracle.reference_nlms(xs, -(xs // 2), bnlms=True)[2][:1] == wants == [False]
