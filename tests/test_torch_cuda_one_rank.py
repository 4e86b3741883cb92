"""The sharded paths (``parallel/sharded.py``, ``parallel/speech_sharded.py``)
on the card in a world of one NCCL rank, against the unsharded ops on the
same inputs at full size.  Skipped without CUDA.  Imports neither jax nor
the JAX package, so it runs on a card's host too:

    python -m pytest --noconftest -q tests/test_torch_cuda_one_rank.py

The world is a module fixture: it lives while this module's tests run and
is destroyed when the module ends, so no other module's tests share it.
One card cannot show multi-GPU behaviour: the halo exchanges and gathers
are between the rank and itself; tests/test_torch_parallel.py's and
tests/test_torch_speech_sharded.py's gloo worlds hold the multi-rank
logic.
"""

import socket

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10
from jeicyboodsp_tpu_torch.kernels import vad_flags as K14
from jeicyboodsp_tpu_torch.models import gmm as GM
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.ops import fastconv as FC
from jeicyboodsp_tpu_torch.ops import features as F
from jeicyboodsp_tpu_torch.ops import geq as G
from jeicyboodsp_tpu_torch.ops import nlms as TN
from jeicyboodsp_tpu_torch.pipelines import speech as S
from test_torch_cuda import CLASSES, GMM_F, UTT_BLOCKS, VIT_T, VIT_U, _c_argmax, cuda  # noqa: F401
from torch_inputs import (
    AEC_B, AEC_T, FC_T, GEQ_B, GEQ_T, SCORE_RTOL, SEED, T_FULL, chain_signals, class_signal,
    make_aec_streams, make_geq_streams, make_stereo, synth_class, tp_inputs,
)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank_world():
    """A world of one NCCL rank on this card, destroyed when the module ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import torch.distributed as dist

    from jeicyboodsp_tpu_torch.parallel import mesh as M

    M.init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, device="cuda")
    yield M
    dist.destroy_process_group()


def _lsb_share(got, want):
    """(max |difference|, share of samples that differ) of two int tensors."""
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return (int(d.max()), float((d != 0).double().mean())) if d.numel() else (0, 0.0)


def _sharded_holds(got, want, contract):
    """tests/test_sharded.py's contracts: "equal"; "lsb" (int16 one step on
    under 1%, bool equal); (rtol, atol)."""
    if contract == "equal":
        return all(torch.equal(g, w) for g, w in zip(got, want))
    if contract == "lsb":
        return (all(_lsb_share(g, w)[0] <= 1 and _lsb_share(g, w)[1] < 0.01
                    for g, w in zip(got, want) if g.dtype == torch.int16)
                and all(torch.equal(g, w) for g, w in zip(got, want) if g.dtype == torch.bool))
    rtol, atol = contract
    return all(torch.allclose(g, w, rtol=rtol, atol=atol) for g, w in zip(got, want))


def test_sharded_paths_in_a_world_of_one_nccl_rank(cuda, one_rank_world):
    """Every ``parallel/sharded.py`` path in a world of one NCCL rank at the
    unsharded op's full size, against that op on the same inputs, at
    tests/test_sharded.py's contracts (equal, or one int16 step on under 1%,
    em_step at rtol 1e-10, the GEQ at rtol 1e-7 / atol 1e-5); K14 launches
    under each f32 sharded enhancement path."""
    from jeicyboodsp_tpu_torch.ops import mvdr as MV
    from jeicyboodsp_tpu_torch.parallel import sharded as SH

    M, dev = one_rank_world, cuda
    f64, f32 = torch.float64, torch.float32
    x_full = chain_signals()[1]
    x, r = make_aec_streams(AEC_B, AEC_T, dev)
    tp = tp_inputs(dev)
    geq = make_geq_streams(GEQ_B, GEQ_T, dev)
    b, a = G.geq_coefficients()
    geq_fast = G.geq_apply_fast(geq, b, a, dtype=f64)
    failed = []

    def report(name, got, want, contract):
        if not _sharded_holds(got, want, contract):
            failed.append(name)

    def k14_counted(run):
        before = K14.vad_flags.launches
        got = run()
        torch.cuda.synchronize()
        assert K14.vad_flags.launches > before
        return got

    mt, md = M.make_mesh((1,), ("time",)), M.make_mesh((1,), ("data",))
    m2, mm = M.make_mesh((1, 1), ("data", "time")), M.make_mesh((1,), ("model",))
    blocks = torch.from_numpy(x_full.reshape(T_FULL, 512)).to(dev)
    report("enhance_sharded f64", SH.enhance_sharded(blocks, mt, dtype=f64),
           E.enhance_blocks(blocks, dtype=f64), "lsb")
    report("enhance_sharded f32", k14_counted(lambda: SH.enhance_sharded(blocks, mt, dtype=f32)),
           E.enhance_blocks(blocks, dtype=f32), "lsb")
    b2 = blocks.reshape(2, T_FULL // 2, 512)
    got = k14_counted(lambda: SH.enhance_sharded2d(b2, m2, dtype=f32))
    want = [E.enhance_blocks(b2[i], dtype=f32) for i in range(2)]
    report("enhance_sharded2d f32", got,
           (torch.stack([w[0] for w in want]), torch.stack([w[1] for w in want])), "lsb")
    fc = torch.from_numpy(x_full[:FC_T * 1024].reshape(FC_T, 1024)).to(dev)
    Hr, Hi = FC.filter_spectrum()
    out, mask = SH.fastconv_sharded(fc, Hr, Hi, mt)
    report("fastconv_sharded f64", (out[mask],), (FC.fastconv_blocks(fc, Hr, Hi),), "lsb")
    xb, rb = x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024)
    for dt in (f64, f32):
        nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in TN.nlms_init_state(dt).items()}
        bz = {k: v.expand(AEC_B, *v.shape).contiguous()
              for k, v in TN.bnlms_init_state(dt).items()}
        report(f"nlms_sharded {dt}", SH.nlms_sharded(x, r, md, dtype=dt),
               TN.nlms_apply(x, r, nz, dtype=dt)[:2], "equal")
        report(f"bnlms_sharded {dt}", SH.bnlms_sharded(xb, rb, md, dtype=dt),
               TN.bnlms_apply(xb, rb, bz, dtype=dt)[:2], "equal")
    report("bnlms_sharded_time f32", SH.bnlms_sharded_time(*tp, mt),
           TN.bnlms_apply_timeparallel(*tp), "lsb")
    ml, mr = make_stereo(T_FULL * 512, np.random.default_rng(SEED + 12))
    bl = torch.from_numpy(ml.reshape(-1, 512)).to(dev)
    br = torch.from_numpy(mr.reshape(-1, 512)).to(dev)
    report("mvdr_sharded f64", SH.mvdr_sharded(bl, br, mt), MV.mvdr_blocks(bl, br), "lsb")
    report("mvdr_sharded_bins f32", SH.mvdr_sharded_bins(bl, br, mm),
           MV.mvdr_blocks(bl, br, dtype=f32, fft_engine="mxu3"), "lsb")
    fr = torch.from_numpy(synth_class(1000, GMM_F)).to(dev)
    mk = torch.ones(GMM_F, dtype=torch.bool, device=dev)
    alpha = torch.full((4,), 0.25, dtype=f64, device=dev)
    mean, cov = fr[0:16:4], torch.eye(12, dtype=f64, device=dev).expand(4, 12, 12) * 4.0
    report("em_step_sharded f64", SH.em_step_sharded(fr, mk, alpha, mean, cov, md),
           GM.em_step(fr, mk, alpha, mean, cov), (1e-10, 1e-12))
    report("geq_sharded f64", (SH.geq_sharded(geq[0], b, a, mt),), (geq_fast[0],), (1e-7, 1e-5))
    dp = SH.data_parallel_sharding(md)
    g32 = geq[:8].float()
    report("data_parallel_sharding geq_apply_fast f32 8 streams",
           (dp.gather(G.geq_apply_fast(dp.local(g32), b, a)),), (G.geq_apply_fast(g32, b, a),),
           "equal")
    assert not failed, failed


TRAIN_RTOL, TRAIN_ATOL, TRAIN_DOT_TOL = 1e-9, 1e-11, 1e-8  # tests/test_speech_sharded.py
DECODE_RTOL = 1e-10


def test_speech_sharded_paths_on_a_mesh_of_one(cuda, one_rank_world):
    """``parallel/speech_sharded.py`` on an (expert, data) mesh of (1, 1) at
    full width (25 classes of 12-dim features, 4 mixtures), against the
    unsharded ops on the same inputs: ``speech_train_sharded`` f64 over 25 x
    256 blocks of class_signal against ``speech_train`` at
    tests/test_speech_sharded.py's contract (rtol 1e-9 / atol 1e-11,
    eigenvectors by |cosine| within 1e-8, NaN equal);
    ``speech_classify_sharded`` f32 mxu3 of an utterance a class through
    K10, every decision and NaN that of ``speech_classify(mxu3)`` one
    utterance at a time, scores within SCORE_RTOL; ``speech_decode_sharded``
    over 512 utterances x 256 blocks against ``mfcc_blocks`` +
    ``viterbi_batched`` (f64 paths equal and scores within 1e-10, f32 paths
    equal)."""
    from jeicyboodsp_tpu_torch.models import hmm as H
    from jeicyboodsp_tpu_torch.parallel import speech_sharded as SS

    M, dev = one_rank_world, cuda
    mesh = M.make_mesh((1, 1), ("expert", "data"))
    f64, f32 = torch.float64, torch.float32
    n_blocks, n_utt, utt_blocks = 256, VIT_U, VIT_T // 2
    rng = np.random.default_rng(SEED + 13)
    audio = torch.from_numpy(np.stack([class_signal(c, n_blocks * 1024, rng).reshape(-1, 1024)
                                       for c in range(CLASSES)])).to(dev)
    utts = torch.from_numpy(np.stack([class_signal(c, UTT_BLOCKS * 1024, rng).reshape(-1, 1024)
                                      for c in range(CLASSES)])).to(dev)
    got = SS.speech_train_sharded(audio, mesh, dtype=f64)
    want = S.speech_train(audio, dtype=f64)
    for g, w in zip(got[:3], want[:3]):
        assert torch.allclose(g, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL, equal_nan=True)
    e, f = got[3], want[3]
    cos = ((e * f).sum(-2) / (e.norm(dim=-2) * f.norm(dim=-2) + 1e-300)).abs()
    assert torch.equal(cos.isnan(), f.isnan().any(-2))
    assert float((1 - cos).abs().nan_to_num(0.0).max()) <= TRAIN_DOT_TOL
    finite = torch.isfinite(want[0]).all(-1) & torch.isfinite(want[3]).all(-1).all(-1).all(-1)
    models = (got[0], got[1], got[2], got[3][..., :4])
    before = K10.mfcc_fused.launches
    scores = SS.speech_classify_sharded(utts, *models, mesh, dtype=f32, fft_engine="mxu3")
    torch.cuda.synchronize()
    assert K10.mfcc_fused.launches > before
    want_s = torch.stack([S.speech_classify(u, *models, dtype=f32, fft_engine="mxu3")
                          for u in utts]).cpu().numpy()
    got_s = scores.cpu().numpy()
    fin = np.isfinite(want_s)
    assert [_c_argmax(g.tolist()) for g in got_s] == [_c_argmax(w.tolist()) for w in want_s]
    assert np.array_equal(np.isnan(got_s), np.isnan(want_s))
    assert np.max(np.abs(got_s[fin] - want_s[fin]) / np.abs(want_s[fin]), initial=0.0) <= SCORE_RTOL
    # the decoding HMM: 6 finite class models as its states, a random row-stochastic trans
    states = torch.nonzero(finite)[:6, 0].tolist()
    assert len(states) == 6
    trans = rng.uniform(0.05, 1.0, (6, 6))
    hmm64 = (*(v[states] for v in models), torch.from_numpy(trans / trans.sum(1, keepdims=True))
             .to(dev))
    hmm32 = tuple(v.float() for v in hmm64)
    cls = np.array(states)[np.arange(n_utt) % 6]
    dec_utts = torch.from_numpy(np.stack([class_signal(c, utt_blocks * 1024, rng).reshape(-1, 1024)
                                          for c in cls])).to(dev)
    for dt, hmm in ((f64, hmm64), (f32, hmm32)):
        paths, sc = SS.speech_decode_sharded(dec_utts, *hmm, mesh, dtype=dt)
        feats = F.mfcc_blocks(dec_utts, *F.mel_dct(dt, dev), dtype=dt)
        lengths = torch.full((n_utt,), feats.shape[1], dtype=torch.int64, device=dev)
        wp, ws = H.viterbi_batched(feats, lengths, *hmm, compat=False)
        assert torch.equal(paths, wp) and bool(torch.isfinite(ws).all()), dt
        if dt == f64:
            assert torch.allclose(sc, ws, rtol=DECODE_RTOL, atol=0.0)
