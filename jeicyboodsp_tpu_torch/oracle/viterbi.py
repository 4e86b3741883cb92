"""The Viterbi program's float64 references (Viterbi_version1.cpp;
counterpart of ``jeicyboodsp_tpu/oracle/viterbi.py``): the GMM emission,
the decode with its quirks, and the forward values of the corrected
decode."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI
from jeicyboodsp_tpu_torch.oracle.gmm import GMM_MIXTURES, PCA_TEST

HMM_STATES = 6


def reference_gmm_emission(x, alpha, mean, cov_diag4, eigvec4):
    """Viterbi_version1.cpp:248-267: the mixtures' PCA-4 diagonal Gaussians,
    weighted and summed."""
    s = 0.0
    for k in range(GMM_MIXTURES):
        xp = x @ eigvec4[k]
        with np.errstate(invalid="ignore", divide="ignore"):
            terms = (
                (1.0 / np.sqrt(2.0 * REF_PI))
                * (1.0 / np.sqrt(cov_diag4[k]))
                * np.exp(-0.5 * (xp - mean[k][:PCA_TEST]) ** 2 / cov_diag4[k])
            )
        s += alpha[k] * float(np.prod(terms))
    return s


def reference_hmm_decode(frames, states, trans, bests=None):
    """HMMRecognition (Viterbi_version1.cpp:157-246) with its quirks: the
    log of the already-log accumulated value (NaN through C's comparisons),
    the per-time argmax re-found instead of a backtrace, path[0] never
    written, the score read at t = 1.  ``states``: 6 (alpha, mean,
    cov_diag4, eigvec4).  Returns (path (T-1,), score); a list ``bests``
    receives the value printed at each step t = T-1..1 (:222)."""
    T = len(frames)
    P = np.zeros((HMM_STATES, T))
    with np.errstate(invalid="ignore", divide="ignore"):
        for m in range(HMM_STATES):
            P[m, 0] = np.log(reference_gmm_emission(frames[0], *states[m])) + np.log(1.0 / HMM_STATES)
        for t in range(1, T):
            for m in range(HMM_STATES):
                emis = reference_gmm_emission(frames[t], *states[m])
                for u in range(HMM_STATES):
                    cand = np.log(P[u, t - 1]) + np.log(trans[u, m]) + np.log(emis)
                    if u == 0:
                        P[m, t] = cand
                    elif P[m, t] < cand:
                        P[m, t] = cand
    path = np.zeros(max(T - 1, 0), dtype=np.int64)
    score = 0.0
    for t in range(T - 1, 0, -1):
        best, arg = P[0, t], 0
        for m in range(1, HMM_STATES):
            if P[m, t] > best:
                best, arg = P[m, t], m
        score = best
        if bests is not None:
            bests.append(best)
        if t <= T - 2:
            path[t] = arg
    return path, score


def reference_forward(frames, alpha, mean, cov, eigvec, trans):
    """float64 forward values (T, 6) of the corrected Viterbi: P[0] = log
    emis[0] + log(1/6), P[t][m] = max_u (P[t-1][u] + log trans[u, m]) +
    log emis[t][m], the emissions as reference_gmm_emission's, vectorized."""
    var = np.diagonal(cov, axis1=-2, axis2=-1)[..., None, :4]
    xp = np.einsum("ti,skij->sktj", frames, eigvec[..., :4])
    with np.errstate(divide="ignore", under="ignore"):
        terms = (1.0 / np.sqrt(2.0 * REF_PI)) * (1.0 / np.sqrt(var)) * np.exp(
            -0.5 * (xp - mean[..., None, :4]) ** 2 / var)
        le = np.log((alpha[..., None] * np.prod(terms, -1)).sum(1)).T  # (T, 6)
        lt = np.log(trans)
    P = np.zeros_like(le)
    P[0] = le[0] + np.log(1.0 / HMM_STATES)
    for t in range(1, len(le)):
        P[t] = np.max(P[t - 1][:, None] + lt, 0) + le[t]
    return P
