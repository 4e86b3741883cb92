"""HMM / Viterbi decoding and segmental HMM training (counterpart of
``jeicyboodsp_tpu/models/hmm.py``).

Reference: ``Viterbi_version1.cpp`` (oracle: ``jeicyboodsp_tpu/oracle/viterbi.py``).
Emission densities for all (time, state) pairs come from one batched pass;
the 6-state recursion is a Python loop over time (JAX's ``lax.scan``), a few
small ops a step over all utterances of a batch at once.  Two modes:

- ``compat=True`` keeps the reference's log-of-log recursion (``:196``)
  with its NaN propagation (the candidates are scanned with ``<`` and the
  per-time argmax with ``>``, so a NaN keeps the incumbent: neither
  ``torch.max`` nor ``torch.argmax`` does that), the re-found-argmax
  "backtrace", the unwritten path[0] and the score at t = 1;
- ``compat=False`` is the corrected max-plus Viterbi with a true backtrace
  (``torch.amax``/``torch.argmax``, first index on ties, as JAX's).

:func:`viterbi_assoc` is the corrected decode in O(log T) depth: prefix and
suffix max-plus products by a Hillis-Steele scan in torch ops (torch has no
``associative_scan``).  No kernel runs here; these are torch ops, as the JAX
module is plain XLA.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from jeicyboodsp_tpu_torch.models.gmm import NUM_OF_MIXTURE, PCA_LEN_TEST
from jeicyboodsp_tpu_torch.utils.cnum import REF_PI

NUM_OF_STATE = 6


def hmm_to_port(alpha, mean, cov, eigvec4, trans, device):
    """The JAX package's stacked HMM arrays (alpha (6, 4), mean (6, 4, 12),
    cov (6, 4, 12, 12), eigvec (6, 4, 12, 4), trans (6, 6); numpy or JAX
    arrays) -> torch tensors on ``device``, dtypes kept."""
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 for a in (alpha, mean, cov, eigvec4, trans))


def _common(*tensors):
    """The tensors cast to their promoted dtype (JAX promotes f32 features
    against f64 models)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return tuple(t.to(dt) for t in tensors)


def emissions(frames, alpha, mean, cov, eigvec):
    """(..., T, 12) features x per-state PCA-4 GMMs -> (..., T, 6) mixture
    densities.  alpha (6, 4), mean (6, 4, 12), cov (6, 4, 12, 12), eigvec
    (6, 4, 12, 4)."""
    frames, alpha, mean, cov, eigvec = _common(frames, alpha, mean, cov, eigvec)
    xp = frames[..., None, None, :, :] @ eigvec[..., :PCA_LEN_TEST]      # (..., 6, 4, T, 4)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)[..., None, :PCA_LEN_TEST]  # (6, 4, 1, 4)
    terms = (1.0 / math.sqrt(2.0 * REF_PI)) * (1.0 / torch.sqrt(var)) * torch.exp(
        -0.5 * (xp - mean[..., None, :PCA_LEN_TEST]) ** 2 / var)
    mix = alpha[..., None] * torch.prod(terms, -1)                         # (..., 6, 4, T)
    s = mix[..., 0, :]
    for k in range(1, NUM_OF_MIXTURE):  # the mixtures summed in order, as the JAX module
        s = s + mix[..., k, :]
    return s.transpose(-1, -2)


def _log_terms(frames, alpha, mean, cov, eigvec, trans):
    """log emissions (..., T, 6), log transitions (6, 6) and the t = 0
    scores (..., 6)."""
    frames, alpha, mean, cov, eigvec, trans = _common(frames, alpha, mean, cov, eigvec, trans)
    log_emis = torch.log(emissions(frames, alpha, mean, cov, eigvec))
    return log_emis, torch.log(trans), log_emis[..., 0, :] + math.log(1.0 / NUM_OF_STATE)


def _c_argmax(rows):
    """(..., 6) -> the reference's argmax and its value: a scan with ``>``
    from m = 0, so the first of equal values wins and a NaN never takes
    over (nor is it displaced when it sits at m = 0)."""
    best = rows[..., 0]
    arg = torch.zeros(rows.shape[:-1], dtype=torch.int32, device=rows.device)
    for m in range(1, NUM_OF_STATE):
        take = rows[..., m] > best
        best = torch.where(take, rows[..., m], best)
        arg = torch.where(take, m, arg)
    return arg, best


def _viterbi_compat(log_emis, log_trans, p0, full):
    """The reference-quirk recursion over (..., T, 6) log emissions."""
    T = log_emis.shape[-2]
    P = [p0]
    for t in range(1, T):
        # cand[u, m] = log(p_prev[u]) + log(trans[u, m]) + le_t[m]
        cand = torch.log(P[-1])[..., :, None] + log_trans + log_emis[..., t, None, :]
        # the C scan over u with `<`: start at u = 0, replace only if strictly
        # greater; a NaN comparison keeps the incumbent
        p_new = cand[..., 0, :]
        for u in range(1, NUM_OF_STATE):
            p_new = torch.where(p_new < cand[..., u, :], cand[..., u, :], p_new)
        P.append(p_new)
    args, bests = _c_argmax(torch.stack(P, -2))  # (..., T)
    path = torch.zeros(*args.shape[:-1], max(T - 1, 0), dtype=torch.int32, device=args.device)
    path[..., 1:] = args[..., 1:T - 1]
    score = bests[..., min(1, T - 1)]  # the last loop iteration is t = 1 (:245); JAX clamps at T = 1
    return (path, score, bests) if full else (path, score)


def _backtrace(back, last):
    """Follow the best-predecessor table back (..., T - 1, 6) from the last
    state (...,) -> the path (..., T)."""
    states = [last]
    for t in range(back.shape[-2] - 1, -1, -1):
        states.append(back[..., t, :].gather(-1, states[-1][..., None])[..., 0])
    return torch.stack(states[::-1], -1).to(torch.int32)


def _viterbi_corrected(log_emis, log_trans, p0, lengths=None):
    """Max-plus recursion and true backtrace over (..., T, 6) log emissions;
    with ``lengths`` (...,) a step at t >= length holds the scores and points
    each state at itself."""
    T = log_emis.shape[-2]
    p, backs = p0, []
    ident = torch.arange(NUM_OF_STATE, device=p0.device)
    for t in range(1, T):
        cand = p[..., :, None] + log_trans + log_emis[..., t, None, :]
        p_new, back = torch.amax(cand, -2), torch.argmax(cand, -2)
        if lengths is not None:
            live = (t < lengths)[..., None]
            p_new = torch.where(live, p_new, p)
            back = torch.where(live, back, ident)
        p = p_new
        backs.append(back)
    last = torch.argmax(p, -1)
    back = (torch.stack(backs, -2) if backs
            else torch.zeros(*last.shape, 0, NUM_OF_STATE, dtype=last.dtype, device=last.device))
    return _backtrace(back, last), torch.amax(p, -1)


def viterbi(frames, alpha, mean, cov, eigvec, trans, compat: bool = True, full: bool = False):
    """Decode one utterance (T, 12) with a 6-state HMM.  Returns (path
    (T - 1,), score) in compat mode, (path (T,), score) corrected.

    ``compat`` mirrors the reference (module docstring); ``compat=False``
    is the corrected algorithm (true backtrace, final-time score).
    ``full=True`` (compat only) also returns the per-time max accumulated
    values, the values the reference prints per backtrace step
    (``Viterbi_version1.cpp:222``) and the CLI's ``--verbose`` prints."""
    log_emis, log_trans, p0 = _log_terms(frames, alpha, mean, cov, eigvec, trans)
    if compat:
        return _viterbi_compat(log_emis, log_trans, p0, full)
    return _viterbi_corrected(log_emis, log_trans, p0)


def _maxplus(a, b):
    """Max-plus products of (6, 6, L) operator stacks, lane-parallel over L:
    out[u, m] = max_k a[u, k] + b[k, m]."""
    return torch.amax(a[:, :, None, :] + b[None, :, :, :], 1)


def _maxplus_scan(M, reverse: bool = False):
    """Inclusive Hillis-Steele scan of (6, 6, L) operators over L in
    forward operator order: out[..., i] = M_0 (x) ... (x) M_i, or with
    ``reverse`` the suffix M_i (x) ... (x) M_{L-1}.  Max-plus products do
    not commute, so the earlier operator always stands on the left."""
    x, L, d = M, M.shape[-1], 1
    while d < L:
        if reverse:
            x = torch.cat([_maxplus(x[..., :-d], x[..., d:]), x[..., L - d:]], -1)
        else:
            x = torch.cat([x[..., :d], _maxplus(x[..., :-d], x[..., d:])], -1)
        d *= 2
    return x


def viterbi_assoc(frames, alpha, mean, cov, eigvec, trans):
    """Single-utterance corrected Viterbi in O(log T) depth.

    The DP is a max-plus matrix chain, P_t = P_{t-1} (x) M_t with
    M_t[u, m] = log trans[u, m] + log emis[t, m], and max-plus products are
    associative: the prefix products give alpha_t, the suffix products the
    best completion beta_t, and the path is the per-time argmax of
    alpha_t + beta_t, with no sequential backtrace.  Same result as
    ``viterbi(..., compat=False)`` up to the grouping of the sums (+-ulp)
    and ties between equally good paths.  Returns (path (T,), score)."""
    log_emis, log_trans, p0 = _log_terms(frames, alpha, mean, cov, eigvec, trans)
    T = log_emis.shape[0]
    if T == 1:
        return torch.argmax(p0)[None].to(torch.int32), torch.amax(p0)
    M = log_trans[:, :, None] + log_emis.T[None, :, 1:]  # (6, 6, T - 1): M[u, m, t - 1]
    pre = _maxplus_scan(M)
    P = torch.cat([p0[:, None], torch.amax(p0[:, None, None] + pre, 0)], 1)  # (6, T)
    # beta_t[m] = max_m' (M_{t+1} (x) ... (x) M_{T-1})[m, m'], beta_{T-1} = 0
    beta = torch.cat([torch.amax(_maxplus_scan(M, reverse=True), 1),
                      torch.zeros(NUM_OF_STATE, 1, dtype=P.dtype, device=P.device)], 1)
    return torch.argmax(P + beta, 0).to(torch.int32), torch.amax(P[:, -1])


def viterbi_batched(frames, lengths, alpha, mean, cov, eigvec, trans, compat: bool = False):
    """Corpus decode: frames (U, T, 12) zero-padded, lengths (U,) the true
    frame counts -> (paths (U, T), scores (U,)), every utterance in one
    recursion.

    ``compat=False``: steps past an utterance's length hold its scores and
    point each state at itself, so its score and path[:length] equal the
    unpadded single decode.  ``compat=True`` runs the reference-quirk decode
    over the full padded length, which has no mask and would decode the
    padding as frames: a ragged batch raises ``ValueError`` (checked on the
    host, before any work)."""
    lengths_h = torch.as_tensor(lengths).cpu()
    if compat:
        if lengths_h.numel() and not bool((lengths_h == frames.shape[1]).all()):
            raise ValueError(
                "viterbi_batched(compat=True) requires every utterance to fill the padded "
                f"length T={frames.shape[1]} (got lengths {torch.unique(lengths_h).tolist()}): "
                "the reference-quirk decode has no mask and would treat tail padding as "
                "frames.  Use compat=False for ragged corpora, or split by length.")
    return _viterbi_batched(frames, torch.as_tensor(lengths, device=frames.device),
                            alpha, mean, cov, eigvec, trans, compat)


def _viterbi_batched(frames, lengths, alpha, mean, cov, eigvec, trans, compat: bool):
    """The body of :func:`viterbi_batched` (JAX's ``_viterbi_batched_jit``)."""
    log_emis, log_trans, p0 = _log_terms(frames, alpha, mean, cov, eigvec, trans)
    if compat:
        return _viterbi_compat(log_emis, log_trans, p0, full=False)
    return _viterbi_corrected(log_emis, log_trans, p0, lengths=lengths)


def train_hmm(frames, n_iter: int = 3):
    """Segmental (Viterbi) HMM training on one utterance's (T, 12) features,
    on their device: a capability the reference never had.

    Initialization is a uniform segmentation into the 6 states; each
    iteration refits every state's 4-mixture GMM on its frames (the batched
    class trainer with ``cov_floor=1e-2``, each state's own frames reordered
    to the front by a stable sort so k-means seeds from them), replaces a
    state whose fit is not finite (it lost all its frames) by a far-away unit
    Gaussian, re-estimates the transitions from bigram counts smoothed by
    1e-3, and re-decodes with the corrected Viterbi.

    Returns a dict of alpha, mean, cov, eigvec (the PCA-8 export), trans,
    the final state path and the decode score."""
    from jeicyboodsp_tpu_torch.models.gmm import train_classes_batched

    T, feat_dim = frames.shape
    dev = frames.device
    states = torch.arange(NUM_OF_STATE, device=dev)
    path = (torch.arange(T, device=dev) * NUM_OF_STATE // T).to(torch.int32)
    out = None
    for _ in range(n_iter):
        masks = path[None, :] == states[:, None]                      # (6, T)
        order = torch.argsort(~masks, dim=1, stable=True)  # a bool sort, as JAX's
        framesC = frames[order]                                       # (6, T, 12)
        masksO = torch.gather(masks, 1, order)
        alpha, mean, cov, eig8 = train_classes_batched(framesC, masksO, cov_floor=1e-2)
        bad = ~(torch.isfinite(alpha).all(1) & torch.isfinite(mean).flatten(1).all(1)
                & torch.isfinite(cov).flatten(1).all(1) & torch.isfinite(eig8).flatten(1).all(1))
        eye = torch.eye(feat_dim, dtype=cov.dtype, device=dev)
        alpha = torch.where(bad[:, None], 1.0 / alpha.shape[1], alpha)
        mean = torch.where(bad[:, None, None], 1e6, mean)
        cov = torch.where(bad[:, None, None, None], eye.expand(cov.shape), cov)
        eig8 = torch.where(bad[:, None, None, None], eye[:, : eig8.shape[-1]].expand(eig8.shape),
                           eig8)
        onehot = torch.nn.functional.one_hot(path.long(), NUM_OF_STATE).to(frames.dtype)
        counts = onehot[:-1].T @ onehot[1:] + 1e-3
        trans = counts / counts.sum(1, keepdim=True)
        path, score = viterbi(frames, alpha, mean, cov, eig8[..., :PCA_LEN_TEST], trans,
                              compat=False)
        out = dict(alpha=alpha, mean=mean, cov=cov, eigvec=eig8, trans=trans, path=path,
                   score=score)
    return out
