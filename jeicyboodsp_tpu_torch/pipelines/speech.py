"""End-to-end speech classification (counterpart of
``jeicyboodsp_tpu/pipelines/speech.py``): raw audio in, per-class scores
out, with no feature file in between.

- :func:`speech_classify`: a (T, 1024) int16 utterance and stacked class
  models -> (C,) class scores.  With ``fft_engine="mxu3"`` (or ``mxu8``) in
  f32 the MFCC runs through K10.

Training (``speech_train``) and HMM decoding (``speech_decode``) wait
(ROADMAP queue 1, item 8).  Runs on the utterance's device.
"""

from __future__ import annotations

import torch

from jeicyboodsp_tpu_torch.models.gmm import score_frames_all_classes
from jeicyboodsp_tpu_torch.ops.features import mel_dct, mfcc_blocks


def speech_classify(blocks, alphas, means, covs, eigvecs4, dtype=torch.float32,
                    fft_engine: str = "xla"):
    """(T, 1024) int16 utterance -> (C,) class scores (PCA-4 scorer), the
    model tensors on the utterance's device (``models.gmm.model_to_port``)."""
    feats = mfcc_blocks(blocks[None], *mel_dct(dtype, blocks.device), dtype=dtype,
                        fft_engine=fft_engine)[0]
    return score_frames_all_classes(feats, alphas, means, covs, eigvecs4)
