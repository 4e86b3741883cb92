"""GMM training and scoring's float64 references
(GMMAlgorithm_Train_Auto_ver2.cpp, GMMAlgorithm_Test_Auto_ver2.cpp;
counterpart of ``jeicyboodsp_tpu/oracle/gmm.py``): k-means with its
accumulating selection, EM, the PCA export, a class's training, the test
program's per-file score, and its read of the model file."""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI

GMM_FEATURE_LEN, GMM_MIXTURES, PCA_TRAIN, PCA_TEST = 12, 4, 8, 4
KMEANS_THRESHOLD, EM_ITERATIONS = 1.0, 3


class RefGMM:
    """The C GMMParameter struct in the train layout (PCA_LEN 8)."""

    def __init__(self):
        self.alpha = np.zeros(GMM_MIXTURES)
        self.mean = np.zeros((GMM_MIXTURES, GMM_FEATURE_LEN))
        self.cov = np.zeros((GMM_MIXTURES, GMM_FEATURE_LEN, GMM_FEATURE_LEN))
        self.eigvec = np.zeros((GMM_MIXTURES, GMM_FEATURE_LEN, PCA_TRAIN))


def _ref_top_eigpairs(cov, k):
    """Descending eigenpairs (a stable sort), NaN for a non-finite matrix."""
    if not np.all(np.isfinite(cov)):
        return np.full(k, np.nan), np.full((cov.shape[0], k), np.nan)
    vals, vecs = np.linalg.eigh(cov)
    order = np.argsort(-vals, kind="stable")
    return vals[order[:k]], vecs[:, order[:k]]


def reference_kmeans(frames, means):
    """KmeansAlogorithm (GMMAlgorithm_Train_Auto_ver2.cpp:342-438): the
    Selection matrix is never cleared, ties go to the last mixture, the loop
    stops once the cost moves by less than 1.  Returns (means, covariances)."""
    n = len(frames)
    sel = np.zeros((n, GMM_MIXTURES), dtype=bool)
    means = means.copy()
    cost_before = 0.0
    count = 0
    while True:
        count += 1
        d = ((frames[:, None, :] - means[None, :, :]) ** 2).sum(axis=2)
        arg = (GMM_MIXTURES - 1) - np.argmin(d[:, ::-1], axis=1)
        sel[np.arange(n), arg] = True
        cost = float((d * sel).sum())
        if count == 1 or abs(cost - cost_before) >= KMEANS_THRESHOLD:
            cost_before = cost
        else:
            covs = np.zeros((GMM_MIXTURES, GMM_FEATURE_LEN, GMM_FEATURE_LEN))
            for j in range(GMM_MIXTURES):
                idx = sel[:, j]
                cnt = int(idx.sum())
                diff = frames[idx] - means[j]
                with np.errstate(invalid="ignore", divide="ignore"):
                    covs[j] = (diff.T @ diff) / cnt
            return means, covs
        for j in range(GMM_MIXTURES):
            cnt = int(sel[:, j].sum())
            if cnt == 0:
                means[j] = 0.0
                continue
            means[j] = frames[sel[:, j]].sum(axis=0) / cnt


def reference_em_step(frames, p):
    """One EM iteration (:263-337): top-8 PCA densities, responsibilities
    divided by their unguarded sum, alpha and mean accumulated onto their
    previous values."""
    n = len(frames)
    probs = np.zeros((n, GMM_MIXTURES))
    for k in range(GMM_MIXTURES):
        vals, vecs = _ref_top_eigpairs(p.cov[k], PCA_TRAIN)
        xp = frames @ vecs
        mp = p.mean[k] @ vecs
        with np.errstate(invalid="ignore", divide="ignore"):
            terms = (1.0 / np.sqrt(2.0 * REF_PI)) * (1.0 / np.sqrt(vals)) * np.exp(
                -0.5 * (xp - mp) ** 2 / vals
            )
        probs[:, k] = np.prod(terms, axis=1)
    w = probs * p.alpha[None, :]
    with np.errstate(invalid="ignore"):
        w = w / w.sum(axis=1, keepdims=True)
    n_of_key = p.alpha + w.sum(axis=0)
    p.alpha = n_of_key / n
    p.mean = (p.mean + w.T @ frames) / n_of_key[:, None]
    for k in range(GMM_MIXTURES):
        diff = frames - p.mean[k]
        p.cov[k] = (diff * w[:, k : k + 1]).T @ diff / n_of_key[k]


def reference_pca_export(p):
    """PCADiagonalizeCovarianceMatrix (:456-519), in place: the projected
    mean in mean[:8], covariance rows 0-7 zeroed with the eigenvalues on the
    diagonal, rows 8-11 stale."""
    for k in range(GMM_MIXTURES):
        vals, vecs = _ref_top_eigpairs(p.cov[k], PCA_TRAIN)
        proj_mean = p.mean[k] @ vecs
        p.mean[k] = 0.0
        p.mean[k][:PCA_TRAIN] = proj_mean
        for i in range(PCA_TRAIN):
            p.cov[k][i] = 0.0
            p.cov[k][i][i] = vals[i]
        p.eigvec[k] = vecs


def reference_train_class(files):
    """One class over its feature arrays: means seeded from frames 0, 4, 8,
    12, k-means, alpha 1/4, EM_ITERATIONS EM steps a file, the PCA export."""
    p = RefGMM()
    first = files[0]
    for j in range(GMM_MIXTURES):
        p.mean[j] = first[j * 4]
    p.mean, p.cov = reference_kmeans(first, p.mean)
    p.alpha[:] = 1.0 / GMM_MIXTURES
    for frames in files:
        for _ in range(EM_ITERATIONS):
            reference_em_step(frames, p)
    reference_pca_export(p)
    return p


def reference_score_file(frames, alpha, mean, cov_diag4, eigvec4):
    """GMMAlgorithm_Test_Auto_ver2.cpp:151-236 frame by frame: the PCA-4
    diagonal Gaussian of each mixture, weighted and summed, log (unguarded),
    the mean over frames."""
    total = 0.0
    for x in frames:
        s = 0.0
        for k in range(GMM_MIXTURES):
            xp = x @ eigvec4[k]
            with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
                terms = (
                    (1.0 / np.sqrt(2.0 * REF_PI))
                    * (1.0 / np.sqrt(cov_diag4[k]))
                    * np.exp(-0.5 * (xp - mean[k][:PCA_TEST]) ** 2 / cov_diag4[k])
                )
            s += alpha[k] * float(np.prod(terms))
        with np.errstate(divide="ignore"):
            total += np.log(s)
    return total / len(frames)


def reference_score(frames, alpha, mean, cov, eig4):
    """GMMAlgorithm_Test_Auto_ver2.cpp:151-236 on (N, 12) features: each
    frame projected on a mixture's 4 eigenvectors, a diagonal Gaussian
    product there, the mixtures weighted and summed, log; the mean over
    frames.  Model in the test layout (projected mean in mean[k][:4],
    variances on cov[k]'s diagonal)."""
    s = 0.0
    for k in range(4):
        var = np.diagonal(cov[k])[:4]
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            terms = (1.0 / np.sqrt(2.0 * REF_PI)) * (1.0 / np.sqrt(var)) * np.exp(
                -0.5 * (frames @ eig4[k] - mean[k][:4]) ** 2 / var)
        s = s + alpha[k] * np.prod(terms, 1)
    with np.errstate(divide="ignore"):
        return float(np.mean(np.log(s)))


def reference_read_models(path, n, stride, pca):
    """n GMM structs read at fixed ``stride`` bytes (zeros past the end, as
    fread leaves them): alpha, mean, the 4 leading diagonal entries of cov,
    eigvec[..., :4]."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for i in range(n):
        a = np.frombuffer(data[i * stride:(i + 1) * stride].ljust(stride, b"\0"), "<f8")
        cov = a[52:628].reshape(4, 12, 12)
        out.append((a[:4], a[4:52].reshape(4, 12), np.stack([np.diag(c)[:4] for c in cov]),
                    a[628:628 + 48 * pca].reshape(4, 12, pca)[..., :4]))
    return out
