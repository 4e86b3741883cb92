"""GMM class scorer (counterpart of the scorer half of
``jeicyboodsp_tpu/models/gmm.py``).

Reference: ``GMMAlgorithm_Test_Auto_ver2.cpp`` (oracle:
``jeicyboodsp_tpu/oracle/gmm.score_file``).  A frame is projected onto each
mixture's top-4 eigenvectors and scored as a diagonal Gaussian product in
that basis; an utterance's score is its length-normalized total log
likelihood.  Models come in the JAX package's test layout: per class alpha
(4,), mean (4, 12) with the projected mean in the first 4 entries, cov
(4, 12, 12) with the eigenvalues on the diagonal of its top-left 4 x 4
block, eigvec (4, 12, 4).

Training (k-means, EM, PCA export) waits (ROADMAP queue 1, item 8); models
trained by the JAX package cross over through :func:`model_to_port`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jeicyboodsp_tpu_torch.utils.cnum import REF_PI

NUM_OF_MIXTURE = 4
PCA_LEN_TEST = 4


def model_to_port(alphas, means, covs, eigvecs4, device):
    """The JAX package's stacked class models (the arrays ``speech_train``
    returns, eigenvectors cut to ``e8[..., :4]``; numpy or JAX arrays) ->
    torch tensors on ``device``, dtypes kept."""
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in (alphas, means, covs, eigvecs4))


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
