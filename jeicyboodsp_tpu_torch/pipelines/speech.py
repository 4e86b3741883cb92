"""End-to-end speech recognition (counterpart of
``jeicyboodsp_tpu/pipelines/speech.py``): raw audio in, trained models,
class scores or state paths out, with no feature file in between (the
reference chains three programs through feature files on disk).

- :func:`speech_train`: (C, T, 1024) int16 audio per class -> PCA-exported
  GMM parameters of every class (batched MFCC, then batched k-means, EM and
  PCA export).
- :func:`speech_classify`: a (T, 1024) int16 utterance and stacked class
  models -> (C,) class scores.
- :func:`speech_decode`: an utterance and a 6-state HMM -> the Viterbi state
  path and score.

With ``fft_engine="mxu3"`` (or ``mxu8``) in f32 the MFCC runs through K10;
training, scoring and decoding are torch ops.  Runs on the audio's device.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.models.gmm import score_frames_all_classes, train_classes_batched
from jeicyboodsp_tpu_torch.models.hmm import viterbi
from jeicyboodsp_tpu_torch.ops.features import mel_dct, mfcc_blocks


def _mfcc(blocks, dtype, fft_engine):
    return mfcc_blocks(blocks, *mel_dct(dtype, blocks.device), dtype=dtype, fft_engine=fft_engine)


def speech_train(class_blocks, dtype=torch.float32, fft_engine: str = "xla"):
    """(C, T, 1024) int16 -> (alpha, mean, cov, eigvec8) of every class:
    the MFCC of all classes' audio in one batch, then every class trained at
    once (every frame valid; real corpora with per-class frame masks go to
    ``models.gmm.train_classes_batched`` with their features)."""
    feats = _mfcc(class_blocks, dtype, fft_engine)  # (C, 2T, 12)
    return train_classes_batched(feats, torch.ones(feats.shape[:2], dtype=torch.bool,
                                                   device=feats.device))


def speech_classify(blocks, alphas, means, covs, eigvecs4, dtype=torch.float32,
                    fft_engine: str = "xla"):
    """(T, 1024) int16 utterance -> (C,) class scores (PCA-4 scorer), the
    model tensors on the utterance's device (``models.gmm.model_to_port``)."""
    return score_frames_all_classes(_mfcc(blocks[None], dtype, fft_engine)[0], alphas, means,
                                    covs, eigvecs4)


def speech_decode(blocks, alpha, mean, cov, eigvec4, trans, dtype=torch.float32, compat=True):
    """(T, 1024) int16 utterance + 6-state HMM -> (path, score), the MFCC by
    ``torch.fft`` as JAX's ``speech_decode`` runs it."""
    return viterbi(_mfcc(blocks[None], dtype, "xla")[0], alpha, mean, cov, eigvec4, trans,
                   compat=compat)
