"""The sharded speech pipeline over ``torch.distributed`` (counterpart of
``jeicyboodsp_tpu/parallel/speech_sharded.py``).

The mesh form of ``pipelines.speech``, on an ("expert", "data")
``DeviceMesh`` (:func:`~jeicyboodsp_tpu_torch.parallel.mesh.make_mesh`):

- :func:`speech_train_sharded`: (C, T, 1024) int16 audio with the classes
  over ``expert`` and the blocks over ``data``.  Each rank's MFCC frames take
  a 512-sample left halo (the keep buffer of
  ``MFCCFeatureExtraction_auto_version1.cpp:205``); k-means and the EM
  iterations (``GMMAlgorithm_Train_Auto_ver2.cpp:255-438``) all-reduce
  their sufficient statistics over ``data``; classes never communicate,
  so the PCA export is local and the models are gathered over ``expert``.
- :func:`speech_classify_sharded`: the utterances split over the whole mesh
  (expert major), each rank scoring its own against the replicated class
  models with no collective, the (U, C) scores gathered.  In f32 with
  ``fft_engine="mxu3"`` (or ``mxu8``) the MFCC runs through K10.
- :func:`speech_decode_sharded`: the corrected batched Viterbi decode of
  each rank's utterances, the paths and scores gathered.

As in ``parallel.sharded``, each public function takes the whole input,
keeps this rank's share, runs the ``*_local`` body (a function of the
rank's rows and the axes' process groups) and returns the whole result on
every rank.  The sharded training equals the unsharded ``speech_train`` up
to the all-reduces' summation order, except where data-rank 0 holds fewer
than 13 frames: the k-means seeds are frames 0, 4, 8 and 12 of data-rank 0,
with out-of-range indices clamped to its last frame as JAX's gather clamps
them, where the unsharded seeds are the class's frames 0, 4, 8 and 12
(ROADMAP R22).  A path given no mesh raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from jeicyboodsp_tpu_torch.models import gmm as GM
from jeicyboodsp_tpu_torch.models import hmm as H
from jeicyboodsp_tpu_torch.ops.features import KEEP_LEN, WINDOW_LEN, mel_dct, mfcc_blocks, mfcc_frames
from jeicyboodsp_tpu_torch.parallel.halo import all_gather_rows, axis_info, left_halo
from jeicyboodsp_tpu_torch.parallel.sharded import _device, _rows, _tensor, axis_group, em_step_local


def _mfcc_local(blocks_loc, dtype, group, fft_engine="xla"):
    """Shard-local MFCC over (..., T_loc, 1024) time-sharded blocks ->
    (..., 2 T_loc, 12).  The first frame of a shard takes the previous
    shard's trailing 512 samples (one left halo over ``group``; zeros on
    the first rank, as ``mfcc_blocks``' zero start).  Runs ``mfcc_frames``,
    as JAX's sharded training does: ``mxu*`` engines take the matmul DFT,
    not K10."""
    *lead, t_loc, b = blocks_loc.shape
    flat = blocks_loc.reshape(*lead, t_loc * b)
    moved = flat.movedim(-1, 0)  # the time axis first, for the halo
    halo = left_halo(moved, KEEP_LEN, group).movedim(0, -1)
    rows = torch.cat([halo, flat], -1).reshape(*lead, 2 * t_loc + 1, KEEP_LEN)
    frames = torch.cat([rows[..., :-1, :], rows[..., 1:, :]], -1)
    feats = mfcc_frames(frames.reshape(-1, WINDOW_LEN), *mel_dct(dtype, blocks_loc.device),
                        dtype=dtype, fft_engine=fft_engine)
    return feats.reshape(*lead, 2 * t_loc, feats.shape[-1])


def _seed_means(f_loc, group):
    """The k-means seeds, frames 0, 4, 8 and 12 of data-rank 0, on every
    rank of ``group`` (a masked all-reduce).  Indices past data-rank 0's
    last frame are clamped to it, as JAX's gather clamps them (R22)."""
    idx, _ = axis_info(group)
    pick = (torch.arange(GM.NUM_OF_MIXTURE, device=f_loc.device) * GM.SEED_STRIDE).clamp_max(
        f_loc.shape[-2] - 1)
    cand = f_loc[..., pick, :]
    cand = cand.contiguous() if idx == 0 else torch.zeros_like(cand)
    dist.all_reduce(cand, group=group)
    return cand


def speech_train_local(blocks_loc, data_group, dtype=torch.float32, fft_engine: str = "xla",
                       iterations: int = GM.EM_ITERATIONS):
    """A rank's (C_loc, T_loc, 1024) blocks -> the PCA export of its C_loc
    classes (alpha, mean, cov, eigvec8), the statistics all-reduced over
    ``data_group``."""
    feats = _mfcc_local(blocks_loc, dtype, data_group, fft_engine)  # (C_loc, 2 T_loc, 12)
    mask = torch.ones(feats.shape[:-1], dtype=torch.bool, device=feats.device)
    # k-means with its sums over the frames all-reduced: every rank of the group reads the
    # same cost each pass, so the ranks stop at the same pass (the loop's one host read)
    mean, cov = GM.kmeans_counted(feats, mask, _seed_means(feats, data_group),
                                  reduce=lambda t: dist.all_reduce(t, group=data_group))[:2]
    alpha = torch.full((*feats.shape[:-2], GM.NUM_OF_MIXTURE), 1.0 / GM.NUM_OF_MIXTURE,
                       dtype=feats.dtype, device=feats.device)
    for _ in range(iterations):
        alpha, mean, cov = em_step_local(feats, mask, alpha, mean, cov, data_group)
    return GM.pca_export(alpha, mean, cov)


def speech_train_sharded(class_blocks, mesh, expert_axis: str = "expert", data_axis: str = "data",
                         dtype=torch.float32, fft_engine: str = "xla",
                         iterations: int = GM.EM_ITERATIONS):
    """(C, T, 1024) int16 audio -> the PCA-exported GMM of every class
    (alpha (C, 4), mean (C, 4, 12), cov (C, 4, 12, 12), eigvec (C, 4, 12, 8))
    on every rank, the classes over ``expert_axis`` and the blocks over
    ``data_axis``.  C must divide by the expert axis's size, T by the data
    axis's."""
    ge, gd = axis_group(mesh, expert_axis), axis_group(mesh, data_axis)
    x = _tensor(class_blocks)
    C, T, _ = x.shape
    ne, nd = axis_info(ge)[1], axis_info(gd)[1]
    if C % ne or T % nd:
        raise ValueError(f"C={C} / T={T} not divisible by mesh ({ne}, {nd})")
    local = _rows(_rows(x, ge, mesh), gd, mesh, dim=1)  # (C_loc, T_loc, 1024)
    export = speech_train_local(local, gd, dtype, fft_engine, iterations)
    return tuple(all_gather_rows(v, ge) for v in export)


def _groups(mesh, axes):
    return [axis_group(mesh, a) for a in axes]


def _mesh_rows(x, groups, mesh):
    """This rank's share of ``x``'s leading axis split over every axis of
    ``groups`` in row-major order (the first axis major), as JAX's
    ``P(axes)`` lays a batch out."""
    idx, n = 0, 1
    for g in groups:
        i, k = axis_info(g)
        idx, n = idx * k + i, n * k
    x = _tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"U={x.shape[0]} not divisible by mesh size {n}")
    k = x.shape[0] // n
    return x[idx * k:(idx + 1) * k].contiguous().to(_device(mesh))


def _mesh_gather(y, groups):
    """The inverse of :func:`_mesh_rows`: every rank's rows, in order, on
    every rank."""
    for g in reversed(groups):
        y = all_gather_rows(y, g)
    return y


def speech_classify_local(blocks_loc, alphas, means, covs, eigvecs4, dtype=torch.float32,
                          fft_engine: str = "xla"):
    """A rank's (U_loc, T, 1024) utterances -> (U_loc, C) class scores; no
    collective."""
    feats = mfcc_blocks(blocks_loc, *mel_dct(dtype, blocks_loc.device), dtype=dtype,
                        fft_engine=fft_engine)
    return torch.stack([GM.score_frames_all_classes(f, alphas, means, covs, eigvecs4)
                        for f in feats])


def speech_classify_sharded(utt_blocks, alphas, means, covs, eigvecs4, mesh,
                            axes=("expert", "data"), dtype=torch.float32,
                            fft_engine: str = "xla"):
    """(U, T, 1024) utterances split over every axis of ``axes`` -> (U, C)
    class log-likelihood scores (argmax = decision) on every rank, against
    the replicated models (``models.gmm.model_to_port``)."""
    groups = _groups(mesh, axes)
    local = _mesh_rows(utt_blocks, groups, mesh)
    model = [_tensor(v).to(local.device) for v in (alphas, means, covs, eigvecs4)]
    return _mesh_gather(speech_classify_local(local, *model, dtype=dtype, fft_engine=fft_engine),
                        groups)


def speech_decode_local(blocks_loc, alpha, mean, cov, eigvec4, trans, dtype=torch.float32):
    """A rank's (U_loc, T, 1024) utterances -> (paths (U_loc, 2T), scores
    (U_loc,)): the MFCC by ``torch.fft`` and the corrected batched decode
    over the full lengths; no collective."""
    feats = mfcc_blocks(blocks_loc, *mel_dct(dtype, blocks_loc.device), dtype=dtype)
    lengths = torch.full((feats.shape[0],), feats.shape[1], dtype=torch.int64,
                         device=feats.device)
    return H._viterbi_batched(feats, lengths, alpha, mean, cov, eigvec4, trans, compat=False)


def speech_decode_sharded(utt_blocks, alpha, mean, cov, eigvec4, trans, mesh,
                          axes=("expert", "data"), dtype=torch.float32):
    """(U, T, 1024) utterances split over every axis of ``axes`` and a
    6-state HMM (``models.hmm.hmm_to_port``) -> (paths (U, 2T), scores (U,))
    on every rank."""
    groups = _groups(mesh, axes)
    local = _mesh_rows(utt_blocks, groups, mesh)
    hmm = [_tensor(v).to(local.device) for v in (alpha, mean, cov, eigvec4, trans)]
    paths, scores = speech_decode_local(local, *hmm, dtype=dtype)
    return _mesh_gather(paths, groups), _mesh_gather(scores, groups)
