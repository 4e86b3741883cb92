"""GMM training (k-means, EM, PCA export) and scoring (counterpart of
``jeicyboodsp_tpu/models/gmm.py``).

References: ``GMMAlgorithm_Train_Auto_ver2.cpp`` and
``GMMAlgorithm_Test_Auto_ver2.cpp`` (oracle: ``jeicyboodsp_tpu/oracle/gmm.py``,
whose docstring lists the quirks kept here): the k-means Selection matrix is
never cleared, distance ties go to the last mixture, EM's alpha and mean
accumulate onto their previous values, and the PCA export leaves covariance
rows 8-11 stale.

Every function takes leading batch dimensions (classes), so one call trains
all classes: :func:`kmeans` runs its data-dependent loop with a per-class
active mask (a class that has converged keeps its state while the others go
on, as JAX's vmapped ``lax.while_loop`` does) and reads "any class active"
on the host once an iteration.  The E-step's eigendecomposition is one
batched ``torch.linalg.eigh`` per iteration (the reference's per-frame call
is loop-invariant).  Eigenvector signs differ by library (LAPACK here,
cuSOLVER on a card, and each differs from JAX's): what EM and the scorer
compute is sign-invariant, the exported projected mean and eigenvectors are
not.  No kernel runs here; these are torch ops, as the JAX module is plain XLA.

Scoring: a frame is projected onto each mixture's top-4 eigenvectors and
scored as a diagonal Gaussian product in that basis; an utterance's score is
its length-normalized total log likelihood.  Models come in the test layout:
per class alpha (4,), mean (4, 12) with the projected mean in the first 4
entries, cov (4, 12, 12) with the eigenvalues on the diagonal of its top-left
4 x 4 block, eigvec (4, 12, 4).  Models trained by the JAX package cross over
through :func:`model_to_port`.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from jeicyboodsp_tpu_torch.utils.cnum import REF_PI
from jeicyboodsp_tpu_torch.utils.device import entry_device

# GMMAlgorithm_Train_Auto_ver2.cpp (oracle/gmm.py:45-50)
FEATURE_LEN = 12
NUM_OF_MIXTURE = 4
PCA_LEN_TRAIN = 8
PCA_LEN_TEST = 4
THRESHOLD_OF_DISTANCE = 1.0
EM_ITERATIONS = 3
SEED_STRIDE = 4  # k-means seeds mixture j from frame 4 j (:121-126)


def model_to_port(alphas, means, covs, eigvecs4, device):
    """The JAX package's stacked class models (the arrays ``speech_train``
    returns, eigenvectors cut to ``e8[..., :4]``; numpy or JAX arrays) ->
    torch tensors on ``device``, dtypes kept."""
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in (alphas, means, covs, eigvecs4))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _top_eigpairs(cov, k):
    """(..., n, n) symmetric -> the top-k eigenvalues (..., k), descending
    (a stable sort: ties keep eigh's order), and their vectors (..., n, k).
    A matrix holding a non-finite entry gives NaN pairs (the oracle's rule;
    JAX's eigh gives NaN for the wholly NaN covariances EM meets) and is not
    handed to the solver."""
    finite = torch.isfinite(cov).all(-1).all(-1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    vals, vecs = torch.linalg.eigh(torch.where(finite[..., None, None], cov, eye))
    order = torch.argsort(-vals, dim=-1, stable=True)[..., :k]
    vals = vals.gather(-1, order)
    vecs = vecs.gather(-1, order[..., None, :].expand(*vecs.shape[:-1], k))
    nan = torch.tensor(float("nan"), dtype=cov.dtype, device=cov.device)
    return (torch.where(finite[..., None], vals, nan),
            torch.where(finite[..., None, None], vecs, nan))


def _pca_prob(frames, mean, cov, n_keep):
    """probability(): the top-n_keep PCA-projected diagonal Gaussian product.

    frames (..., N, 12), mean (..., 12), cov (..., 12, 12) -> (..., N)."""
    vals, vecs = _top_eigpairs(cov, n_keep)
    xp = frames @ vecs
    mp = mean[..., None, :] @ vecs
    v = vals[..., None, :]
    terms = (1.0 / math.sqrt(2.0 * REF_PI)) * (1.0 / torch.sqrt(v)) * torch.exp(
        -0.5 * (xp - mp) ** 2 / v)
    return torch.prod(terms, -1)


def _mixture_probs(frames, mean, cov):
    """(..., N, 12) frames against (..., 4, 12) means and (..., 4, 12, 12)
    covariances -> (..., N, 4) top-8 PCA densities."""
    return _pca_prob(frames[..., None, :, :], mean, cov, PCA_LEN_TRAIN).transpose(-1, -2)


def kmeans_counted(frames, mask, init_means, reduce=None):
    """:func:`kmeans`, and the iterations each class ran ((...,) int64).

    ``reduce``, where given, is applied in place to each sum over the frames
    before it is used (a pass's cost, its per-cluster counts and sums, the
    final counts and scatter): the sharded training passes an all-reduce
    over the ranks that hold the frames."""
    reduce = reduce or (lambda t: None)
    dt = frames.dtype
    sel = torch.zeros(*mask.shape, NUM_OF_MIXTURE, dtype=torch.bool, device=frames.device)
    means = init_means
    cost_before = torch.zeros(mask.shape[:-1], dtype=dt, device=frames.device)
    count = torch.zeros(mask.shape[:-1], dtype=torch.int64, device=frames.device)
    active = torch.ones(mask.shape[:-1], dtype=torch.bool, device=frames.device)
    while True:
        d = ((frames[..., :, None, :] - means[..., None, :, :]) ** 2).sum(-1)  # (..., N, 4)
        arg = (NUM_OF_MIXTURE - 1) - torch.argmin(d.flip(-1), -1)  # ties -> the last index
        new_sel = sel | (torch.nn.functional.one_hot(arg, NUM_OF_MIXTURE).bool()
                         & mask[..., None])
        cost = torch.where(new_sel, d, 0.0).sum((-2, -1))
        reduce(cost)
        new_count = count + 1
        keep_going = (new_count == 1) | ((cost - cost_before).abs() >= THRESHOLD_OF_DISTANCE)
        cnt = new_sel.sum(-2).to(dt)
        sums = new_sel.to(dt).transpose(-1, -2) @ frames
        reduce(cnt)
        reduce(sums)
        new_means = torch.where(cnt[..., None] > 0, sums / cnt.clamp_min(1.0)[..., None], 0.0)
        # a converged class keeps its carry while the others iterate
        go = (active & keep_going)[..., None, None]
        sel = torch.where(active[..., None, None], new_sel, sel)
        means = torch.where(go, new_means, means)
        cost_before = torch.where(active & keep_going, cost, cost_before)
        count = torch.where(active, new_count, count)
        active = active & keep_going
        if not bool(active.any()):  # the loop's one host read
            break
    # final covariances over the accumulated labels with the final means (0/0 -> NaN)
    cnt = sel.sum(-2).to(dt)
    diff = frames[..., :, None, :] - means[..., None, :, :]  # (..., N, 4, 12)
    w = sel.to(dt)
    scatter = torch.einsum("...nki,...nkj->...kij", diff * w[..., None], diff)
    reduce(cnt)
    reduce(scatter)
    return means, scatter / cnt[..., None, None], count


def kmeans(frames, mask, init_means):
    """Compat k-means with the accumulating Selection quirk: frames
    (..., N, 12), mask (..., N) bool valid frames, init_means (..., 4, 12)
    -> (means (..., 4, 12), covs (..., 4, 12, 12)).  It stops after the
    first pass whose cost moved by less than 1.0."""
    return kmeans_counted(frames, mask, init_means)[:2]


def em_step(frames, mask, alpha, mean, cov):
    """One compat EM iteration (alpha and mean accumulate onto their
    previous values).  Responsibilities are normalized before the mask is
    applied, so a valid frame whose four densities underflow gives 0/0 =
    NaN, as the reference's."""
    n = mask.sum(-1).to(frames.dtype)
    w = _mixture_probs(frames, mean, cov) * alpha[..., None, :]  # (..., N, 4)
    w = w / w.sum(-1, keepdim=True)
    w = torch.where(mask[..., None], w, 0.0)
    n_of_key = alpha + w.sum(-2)
    alpha_new = n_of_key / n[..., None]
    mean_new = (mean + w.transpose(-1, -2) @ frames) / n_of_key[..., None]
    diff = frames[..., :, None, :] - mean_new[..., None, :, :]
    cov_new = torch.einsum("...nki,...nkj->...kij", diff * w[..., None], diff) / n_of_key[..., None, None]
    return alpha_new, mean_new, cov_new


def em_loglik_compat(frames, alpha, mean, cov):
    """The reference's post-M-step likelihood diagnostic, quirks included
    (``GMMAlgorithm_Train_Auto_ver2.cpp:326-332``): dTemp2 is never reset in
    the frame loop, so each frame's log() sees the running sum of the
    per-frame mixture likelihoods: sum_i log(cumsum_i(sum_k alpha_k p_k(x_i)))."""
    probs = _mixture_probs(frames, mean, cov)
    p = alpha[..., 0, None] * probs[..., 0]
    for k in range(1, NUM_OF_MIXTURE):  # the mixtures summed in order, as the JAX module
        p = p + alpha[..., k, None] * probs[..., k]
    return torch.log(torch.cumsum(p, -1)).sum(-1)


def _add_floor(cov, cov_floor):
    return cov + cov_floor * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)


def train_single_file(frames, mask, iterations=EM_ITERATIONS, cov_floor: float = 0.0):
    """Seed + k-means + EM on one feature array (a class's first file).

    ``cov_floor=0.0`` is the reference.  A positive floor (eps * I after
    k-means and after each EM step) regularizes the rank-deficient
    covariances of a mixture that owns fewer frames than dimensions: the
    HMM trainer's small per-state fits need it, the reference's classes do
    not.  Returns (alpha, mean, cov)."""
    init_means = frames[..., : NUM_OF_MIXTURE * SEED_STRIDE: SEED_STRIDE, :]
    mean, cov = kmeans(frames, mask, init_means)
    if cov_floor:
        cov = _add_floor(cov, cov_floor)
    alpha = torch.full((*mask.shape[:-1], NUM_OF_MIXTURE), 1.0 / NUM_OF_MIXTURE,
                       dtype=frames.dtype, device=frames.device)
    for _ in range(iterations):
        alpha, mean, cov = em_step(frames, mask, alpha, mean, cov)
        if cov_floor:
            cov = _add_floor(cov, cov_floor)
    return alpha, mean, cov


def em_file(frames, mask, alpha, mean, cov):
    """EM_ITERATIONS more iterations on a later file of the class."""
    for _ in range(EM_ITERATIONS):
        alpha, mean, cov = em_step(frames, mask, alpha, mean, cov)
    return alpha, mean, cov


def pca_export(alpha, mean, cov):
    """Top-8 PCA export with the stale-covariance-rows quirk
    (``PCADiagonalizeCovarianceMatrix``, :456-519): the projected mean in
    mean[:8] (the rest 0), covariance rows 0-7 zeroed with the eigenvalues
    on their diagonal, rows 8-11 left as they were.

    Returns (alpha, mean_out (..., 4, 12), cov_out (..., 4, 12, 12),
    eigvec (..., 4, 12, 8))."""
    vals, vecs = _top_eigpairs(cov, PCA_LEN_TRAIN)
    mean_out = torch.zeros_like(mean)
    mean_out[..., :PCA_LEN_TRAIN] = (mean[..., None, :] @ vecs)[..., 0, :]
    cov_out = cov.clone()
    cov_out[..., :PCA_LEN_TRAIN, :] = 0.0
    i = torch.arange(PCA_LEN_TRAIN, device=cov.device)
    cov_out[..., i, i] = vals
    return alpha, mean_out, cov_out, vecs


def train_classes_batched(frames, masks, iterations=EM_ITERATIONS, cov_floor: float = 0.0):
    """Every class at once: frames (C, N, 12) padded, masks (C, N) bool.
    No class depends on another (the reference trains them one by one).
    Returns the PCA export (alpha (C, 4), mean (C, 4, 12), cov
    (C, 4, 12, 12), eigvec (C, 4, 12, 8))."""
    return pca_export(*train_single_file(frames, masks, iterations=iterations,
                                         cov_floor=cov_floor))


def _em_iterations_verbose(frames, mask, alpha, mean, cov):
    """EM_ITERATIONS steps with the reference's per-iteration lines
    (``GMMAlgorithm_Train_Auto_ver2.cpp:268,332,339``): 'count_ %d', then
    ' before %.5f after %.5f' with :func:`em_loglik_compat`, then
    'training end!'.  dTempBf starts at 0 for every EM call (a local)."""
    bf = 0.0
    for it in range(1, EM_ITERATIONS + 1):
        sys.stdout.write("count_ %d \n" % it)
        alpha, mean, cov = em_step(frames, mask, alpha, mean, cov)
        aft = float(em_loglik_compat(frames, alpha, mean, cov))
        sys.stdout.write(" before %.5f after %.5f \n" % (bf, aft))
        bf = aft
    sys.stdout.write("training end! \n")
    return alpha, mean, cov


def train_class(files: list, dtype=torch.float64, verbose: bool = False, device="cuda"):
    """One class over its list of (n_i, 12) numpy feature arrays, as the
    reference's file loop: the first file gets k-means and EM_ITERATIONS EM
    steps, each later file EM_ITERATIONS more.  ``verbose`` prints the
    reference's per-iteration likelihood lines.  Returns the PCA export as
    tensors on ``device``."""
    dev = entry_device(device)
    tensors = [torch.from_numpy(np.asarray(f)).to(dev, dtype) for f in files]
    masks = [torch.ones(len(f), dtype=torch.bool, device=dev) for f in tensors]
    f0, m0 = tensors[0], masks[0]
    if verbose:
        mean, cov = kmeans(f0, m0, f0[: NUM_OF_MIXTURE * SEED_STRIDE: SEED_STRIDE])
        alpha = torch.full((NUM_OF_MIXTURE,), 1.0 / NUM_OF_MIXTURE, dtype=dtype, device=dev)
        alpha, mean, cov = _em_iterations_verbose(f0, m0, alpha, mean, cov)
    else:
        alpha, mean, cov = train_single_file(f0, m0)
    for fa, m in zip(tensors[1:], masks[1:]):
        step = _em_iterations_verbose if verbose else em_file
        alpha, mean, cov = step(fa, m, alpha, mean, cov)
    return pca_export(alpha, mean, cov)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def score_frames_all_classes(frames, alphas, means, covs, eigvecs):
    """(N, 12) features against C stacked class models -> (C,) length-
    normalized log likelihoods (argmax is the prediction).

    alphas (C, 4), means (C, 4, 12), covs (C, 4, 12, 12), eigvecs
    (C, 4, 12, >=4).  The features are cast to the models' dtype first (the
    JAX package promotes f32 features against f64 models).
    """
    x = frames.to(alphas.dtype)
    xp = x @ eigvecs[..., :PCA_LEN_TEST]                                # (C, 4, N, 4)
    var = torch.diagonal(covs, dim1=-2, dim2=-1)[..., None, :PCA_LEN_TEST]  # (C, 4, 1, 4)
    mu = means[..., None, :PCA_LEN_TEST]
    terms = (1.0 / math.sqrt(2.0 * REF_PI)) * (1.0 / torch.sqrt(var)) * torch.exp(
        -0.5 * (xp - mu) ** 2 / var)
    mix = alphas[..., None] * torch.prod(terms, -1)                   # (C, 4, N)
    s = mix[:, 0]
    for k in range(1, NUM_OF_MIXTURE):  # the mixtures summed in order, as the JAX scorer
        s = s + mix[:, k]
    return torch.log(s).mean(-1)


def score_frames(frames, alpha, mean, cov, eigvec):
    """(N, 12) features against one class model (alpha (4,), mean (4, 12),
    cov (4, 12, 12), eigvec (4, 12, >=4)) -> the scalar score."""
    return score_frames_all_classes(frames, alpha[None], mean[None], cov[None], eigvec[None])[0]
