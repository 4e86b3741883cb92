#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main paths at their full size -- the Wiener /
spectral-subtraction chain of engines mxu8f, mxu8t (kernel K1), mxu8 (K2,
K3) and mxu3 (K4, K5) at T = 16384 blocks of 512 samples per call (8.39 M
samples), and its float64 compat path (the CLI's default command, torch ops,
no kernel) with the f32 xla / mxu paths (K14, the noise latch); the 7-band GEQ (K6, and K7 for its linear engine) at 2048 streams
x 49,152 samples; the NLMS (K8) and BNLMS (K9) echo cancellers at 1024
streams x 65,536 samples; the MFCC (K10) over 8192 blocks of 1024 samples
with speech classification against 25 class models, and pitch method 2
(K11) over 16,384 frames of 1024; the RIR fast convolution over 2048 blocks
of 1024 (2041 segments of 8192; the shared-memory FFT K12 for engines mxu
and mxu3), the FFT program over 16,384 blocks of 512 (K12 for ``fourstep``), the
two-kernel f32 enhancement engine ``_enhance_fused`` (K4, K13) at T = 16384,
the VAD kernel K14 under engines mxu8f and mxu8t; streaming with checkpoints
(``EnhanceSession`` over the T = 16384 signal, K15 in f64, K14 in f32; ``GEQSession``
(K6), ``AECSession`` (K8, K9) over one stream each; the ``stream`` CLI killed
and resumed), the MVDR beamformer over 16,384 stereo blocks, speech
recognition (GMM training over 25 classes x 512 frames, ``gmm-train`` and
``gmm-test`` through the CLI, ``speech_train(mxu3)`` through K10, Viterbi at
4096 frames and 512 utterances x 512) and the ``awgn`` CLI over 16,384
blocks; the f32 echo cancellers (``nlms --fast``, ``bnlms --fast``: the f32
instances of K8 and K9) at 1024 streams x 65,536 samples with NLMS
``--verbose``, the time-parallel BNLMS over one session of 1024 blocks,
LPC over 8192 frames of 512, the linear GEQ scan ``geq_apply_fast`` over
2048 x 49,152, and every ``parallel/sharded.py`` path in a world of one
NCCL rank (K8, K9, K14 under them) with ``parallel/speech_sharded.py``'s
training over 25 classes x 256 blocks, classification (K10) and decoding
over 512 utterances x 256 blocks on an (expert, data) mesh of (1, 1) -- in
phases that each print lines and raise on failure:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the CUDA sources with nvcc and prints the seconds;
3. each kernel against its plain version on the same inputs:
   - at T = 16384, wiener and specsub: K1 >= 90 dB of the int16 outputs with
     forward planes bit-equal (the tensor-core pass K1 and K2 share); K2
     re/im/|X| planes bit-equal and flags equal; K4 (the shared-memory real
     FFT of csrc/rfft1024.cuh) flags equal, planes within 2^-16 of each
     row's largest sum of |a*b| of the plain version's, and against float64
     products of the frames and the f64 window-folded bases within 1e-5 of
     each plane's row max (re/im within 2^-18 of the sum of |a*b|); the
     noise latch
     within 1e-6; K3 and K5 >= 90 dB; the inverse pass of K1 (both modes)
     and K3 (wiener), hq and turbo: uv bit-equal to the plain inverse of the
     kernel's own q8 and rowsc (the tensor-core pass K1 and K3 share), with
     the scratch bytes that differ from the plain version's printed;
   - at the full stream counts and a shorter T for the plain loops: K6 in
     f64 and in its f32 instance and K7 (T = 4096), K8 (T = 2048, both
     update pairings, and T = 257 from a nonzero state with coefficients
     holding -0.0, compared bit for bit), K9 (8 blocks) and K6 at B = 3072,
     each bit-equal (else the differing samples are printed and the phase
     fails);
   - at full size: K10 >= 90 dB over the finite features with equal NaN and
     infinity masks (a silent stretch gives NaN frames); K11 bit-equal at
     lo = 96 and lo = 0, and at lo = 96 on frames of random full-scale
     extremes (sums past 2^24);
   - K12 at (2041, 8192), forward on real segments and inverse on their
     filtered spectra, and at (16384, 512), within 1e-5 of max |X| (it sums
     in another order than the four-step plain version: not bit-equal); K13 on
     K4's planes at T = 16384, wiener and specsub, within 1e-5 of each frame
     row's max with equal NaN masks; K14's flags bit-equal on the chain's
     signal and on rows at its energy and ZCR thresholds, with the f32
     window and the f64-built w2; engines mxu8f and mxu8t through K14
     bit-equal to the same chain with the VAD as torch ops;
   - K15 (the f64 stream chunk in one launch) against its plain version, the
     torch-op chain on the card, over 2048 blocks in chunks of 2 and 64, wiener
     and specsub, each carrying its own state: written samples within one
     step (the differing count printed), mask and integer state equal, the
     float state within 1e-12 of its largest value;
   - the f32 instances of K8 (T = 2048, both pairings, and T = 257 from a
     nonzero state with -0.0 coefficients) and K9 (8 blocks, some gates
     shut) at 1024 streams, bit-equal to their plain f32 versions;
   - the reference contracts (``utils.gpu_checks.run_checks("cuda")``, the
     JAX package's ``tpu_checks`` probes through the port's entry points
     against its oracles: the GEQ through K6 bit-exact, NLMS and BNLMS
     through K8 and K9 int16-exact, engines mxu3, mxu8, mxu8f and mxu8t at
     their floors and mxu1 below the 60 dB bar, the MVDR collapse, the int8
     fast convolution at its floors, K11's pitch lags): its dict on a line
     ``[3 checks] run_checks('cuda') on <card>: {...}`` and the launches it
     made per kernel; fails unless ``all_ok``;
4. main paths, every launch counter set to 0 just before each and read just
   after, each kernel launched at least once:
   - enhancement: the file-in/file-out pipelines of every engine on a
     192-block probe and on the full-size signal, against a float64 numpy
     reference of the reference program (floors: mxu8f and mxu8 78 dB, mxu8t
     65 dB, mxu3 85 dB), plus the empty-payload and partial-final-block cases;
   - the compat path: the ``wiener`` and ``specsub`` CLI's default command
     (float64 ``xla``) on the probe, the partial and empty cases and the
     full-size signal, each at most one int16 step from the reference on
     under 0.1% of the samples (the flipped count printed, the full-size
     time too); ``run_stream`` f32 ``xla`` >= 95 dB and ``mxu`` >= 90 dB
     with the log-depth scan; ``wiener --fast --engine mxu8f`` from the CLI;
   - GEQ, NLMS, BNLMS: the ``geq``, ``nlms`` and ``bnlms`` pipelines on probe
     files against the port's float64 oracles
     (GEQ byte-identical with a full-scale wrap-stress section, a partial
     last block and an empty payload; NLMS and BNLMS int16-equal; the BNLMS
     gate decisions that differ from the direct f64 sums printed, and none
     may), ``geq --fast`` from the CLI (K6 in f32) byte-identical to a numpy
     float32 copy of the cascade, its SNR and differing samples against the
     float64 reference printed, and the
     batched ops at full size, where two chained calls with state must
     equal one whole call (K6, K8, K9), sampled streams (for NLMS and
     BNLMS every block of an echo and a double-talk stream) must equal the
     references, B = 3072 runs (K6), and the GEQ's linear engine (K7)
     must come within 55 dB of a float64 linear cascade;
   - features, against the port's float64 oracles of the MFCC,
     pitch and GMM-scoring oracles: the ``pitch1``-``pitch3`` pipelines in
     f64 and ``pitch2`` through K11 in f64 and from the CLI with ``--fast
     --engine mxu`` on a speech probe with a silent stretch, a partial last
     block and an empty payload (lags equal; f64 values and f0 equal, to
     1e-9 for method 1's FFT); the ``mfcc`` pipeline in f64 and f32 xla/mxu3
     (>= 100 dB); ``mfcc_blocks(mxu3)`` at full size through K10 (>= 85 dB);
     ``speech_classify(mxu3)`` of 25 utterances against 25 class models the
     script builds from the reference's features (every argmax the class,
     scores within 1e-4); ``pitch_frames(method=2, mxu)`` at full size
     through K11 (256 frames: f64 equal, f32 lags equal up to f32 ties);
   - fastconv, the FFT program and ``_enhance_fused`` (K12, K13 counted):
     the ``fastconv`` pipeline of every engine (f64 xla, f32 xla, gemm,
     gemm8, gemm8hq, mxu, mxu3, auto) and the ``fft`` pipeline (f64 radix2,
     ``--verbose`` lines) on probe files with a partial last block, an empty
     payload and (fastconv) T <= 7, then every fastconv engine and
     ``fastconv_blocks_sparse`` at 2048 blocks, ``roundtrip_blocks`` f32
     radix2 / xla / fourstep and f64 radix2 at 16,384 blocks and
     ``_enhance_fused`` at T = 16384, each against the port's float64
     oracles (f64 within one step; f32 at the floors of
     tests/test_engine_matrix.py; ``_enhance_fused`` >= 85 dB);
   - streaming (K6, K8, K9, K14, K15 counted; their launches added to the
     earlier phases'; K15's equal to the f64 chunks served):
     ``EnhanceSession`` wiener at T = 16384 in f64 (K15) and f32, in chunks
     of 4 blocks with a checkpoint at the middle restored into a fresh session (the second halves bit-equal) and in ragged
     chunks; f64 within one step on under 0.1% of ``reference_enhance`` and
     of the one-shot ``run_stream``, f32 >= 95 dB of the one-shot f32
     ``xla`` chain (the differing samples counted); the ``stream`` CLI in
     subprocesses with ``--chunk-blocks 64``, killed twice by
     ``--crash-after`` and finished, byte-identical to an uninterrupted
     run; ``GEQSession`` over 49,152 samples and both ``AECSession`` s over
     65,536, each with a mid-stream checkpoint, bit-equal to
     ``reference_geq`` / ``reference_nlms_blocks`` / ``reference_bnlms_blocks``
     and to one uninterrupted session;
   - MVDR (no kernel): ``mvdr_blocks`` at T = 16384 against
     ``reference_mvdr``, the port's f64 oracle: f64 ``xla``
     and ``steering_delay(0.3)`` within one step on under 1%, f32 ``xla``
     and ``mxu3`` with ``collapse=False`` >= 60 dB, the ``mxu3`` collapse
     within one step on under 1% and >= 90 dB;
   - speech recognition (K10 counted, its launches added to the earlier
     phases'; the rest torch ops, as the JAX modules are plain XLA), against
     the port's float64 oracles ``oracle/gmm.py`` and
     ``oracle/viterbi.py``: ``train_classes_batched`` in f64 over the
     benchmark's 25 classes x 512 frames and the ``gmm-train`` CLI's model
     file at tests/test_gmm.py's bounds (eigenvector signs aligned first);
     ``gmm-test`` on that same file, misaligned (the CLI) and aligned, every
     printed decision equal to ``reference_score_file``'s;
     ``speech_train(mxu3)`` over 25 x 64 blocks and ``speech_classify`` of
     an utterance a class, every decision that of the f64 reference's
     scores; ``viterbi`` compat at T = 4096 on the benchmark's packed HMM
     (its observation, all NaN, and state 0 held, finite) equal to
     ``reference_hmm_decode`` and the ``viterbi --verbose`` CLI's lines
     within ``%f``'s rounding of its values; the corrected decode against
     ``viterbi_assoc`` in f64 and both in f32 against the f64 decode (paths
     equal but for f32 ties); ``viterbi_batched`` over 512 x 512 against
     single decodes; the ``awgn`` CLI's noise at tests/test_fft_awgn.py's
     bounds;
   - the f32 echo cancellers and the modules after them (``drive_aec_fast``,
     ``drive_timeparallel``, ``drive_lpc``, ``drive_geq_fast``,
     ``drive_parallel``; together ~15 s): nlms_apply and
     bnlms_apply in f32 at 1024 x 65,536 (K8 and K9 f32 counted), every
     block of an echo and a double-talk stream >= 60 dB est and >= 40 dB err
     against the f64 references, ``nlms --fast`` / ``bnlms --fast`` from the
     CLI likewise, ``nlms --verbose`` lines equal to the reference's
     per-block coefficients under %f; ``bnlms_apply_timeparallel`` over 1024
     blocks within 2 steps and >= 60 dB of the f64 sequential path (ms,
     peak memory) -- its first 16 blocks, the drift over the session
     printed (ROADMAP R20), the whole session within one step on under 1%
     of the same op on the CPU; ``lpc_run`` over 8192 frames, ``solve``
     f64 within 1e-9 of ``reference_lpc`` (a float64 copy of
     ``oracle/lpc.py``) and
     ``levinson`` f32 at a per-frame median bound, a few near-singular
     frames allowed to lose their digits;
     ``geq_apply_fast`` f64 at 2048 x 49,152 in one call against
     ``reference_geq_linear`` on two streams; each ``parallel/sharded.py``
     path in a world of one NCCL rank against its unsharded op (max |diff|
     printed, tests/test_sharded.py's contracts; K14 counted under the f32
     enhancement paths, its launches added to K14's), then on an (expert,
     data) mesh of (1, 1) ``speech_train_sharded`` over 25 classes x 256
     blocks of ``class_signal`` in f64 ``xla`` against ``speech_train`` at
     tests/test_speech_sharded.py's contract (rtol 1e-9 / atol 1e-11,
     eigenvectors by |cosine| within 1e-8, NaN equal) and in f32 ``mxu3``
     (its difference from ``speech_train(mxu3)`` printed),
     ``speech_classify_sharded`` f32 ``mxu3`` of 25 utterances against the
     f64 models (K10 counted around this call alone and added to K10's;
     every decision and score that of ``speech_classify(mxu3)``, within
     SCORE_RTOL) and ``speech_decode_sharded`` over 512 utterances x 256
     blocks against ``mfcc_blocks`` + ``viterbi_batched`` (f64 paths equal,
     scores within 1e-10; f32 paths equal), each call's ms printed; run
     after phase 5 so that the NCCL world's threads do not share the host
     with it;
5. timing (CUDA events around batches of back-to-back calls, see
   ``median_ms``): ``enhance_blocks`` of each engine, the ops ``geq_apply``
   (f64 and f32), ``nlms_apply`` and ``bnlms_apply`` (with the gate alone at
   three FFT lengths, and K9's resident blocks per SM), ``mfcc_blocks(mxu3)``,
   ``pitch_frames(method=2, mxu)`` and ``speech_classify`` at full size, and
   each kernel alone against its plain version (K6-K9 at their shorter T)
   and one PyTorch call of its GEMM core where there is one (for K4 and K10
   also ``torch.fft.rfft`` of the windowed f32 frames, the faster of the two
   as their library time, both timed in turns with the kernel), the median of
   7 batches after warm-up (of 3 for the plain versions of K6-K11),
   with the bytes, operations and dependency-chain bounds (K6 and K8 also
   with their chain figures before the redesign, K6-K9 with their previous
   times); ``speech_classify``
   once more under ``torch.profiler`` (device busy time, host ops); each
   fastconv engine at 2048 blocks, ``roundtrip_blocks`` per engine at 16,384
   blocks, ``_enhance_fused``, engines mxu8f / mxu8t with the torch VAD and
   with K14 in turns, and K12 at (2041, 8192) and (16384, 512) (with
   ``torch.fft.fft`` on the same complex64 batch), K13 (with its f32 matmul
   core) and K14 alone, K14 also over 50 calls under ``torch.profiler`` (its
   device busy time and host share a call); K5 and K13 once more in turns with that core, Wiener
   and spectral subtraction; ``mvdr_blocks`` per engine (ms, samples/s);
   ``EnhanceSession`` ms a chunk, f64 and f32, at 4 and 64 blocks, and one
   chunk of 4 under ``torch.profiler`` (device busy, idle share); K15 alone
   at chunks of 2 and 64 beside its plain version, its device time a call
   under ``torch.profiler``, its bound and its one-SM chain's estimate;
   ``train_classes_batched`` f64 and f32, ``speech_train(mxu3)``, each
   decode form (ms, frames/s, and under ``torch.profiler``), ``gmm-test``
   per file and the ``awgn`` CLI (host clock); the f32 instances of K8 and
   K9 at 1024 x 65,536 beside the f64 instances, their plain versions, the
   bounds in f32 operations and K9 f32's resident blocks, the f32 ops, and
   ``lpc_frames`` per solver.  Every kernel's bytes, operations, their
   type and the dependency chains come from
   ``jeicyboodsp_tpu_torch.utils.profiling.KERNELS`` at the timed shapes,
   the card's peaks from the same module, each bound printed with the basis
   of its count: K1-K3 their int8 dots, K4 and K10 their functions through
   a real FFT, K5 and K13 their bytes (their function, gain, inverse real
   FFT and OLA, is far less f32 work), K11 its pairs at one instruction
   each, K14 its bytes; the bytes are each function's inputs read once and
   outputs written once (a stream that frames overlap counts once).

The float64 references are the port's own, ``jeicyboodsp_tpu_torch.oracle``
(numpy only), each held byte-identical to the JAX package's oracle of the
same name by the CPU tests.

Then the card's line, one JSON line of per-kernel results and, last, the
``{"ok": true, ...}`` line.  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_FULL = 16384  # blocks per call (8.39 M samples), the benchmark's size
T_PROBE = 192   # blocks of the fidelity probe
FS = 16000
SEED = 20260817
# the engines' floors in dB against the reference, the port's copy of the JAX package's
# (jeicyboodsp_tpu_torch/config.py); read from the checkout, so the script alone stops here
sys.path.insert(0, ROOT)
from jeicyboodsp_tpu_torch.config import ENGINE_FIDELITY  # noqa: E402
# the float64 references the script holds the port to (numpy only)
from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI, c_short, stale_blocks  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.enhance import reference_enhance  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.fastconv import reference_fastconv  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.fftprog import reference_fft_roundtrip  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.geq import (  # noqa: E402
    reference_geq, reference_geq_f32, reference_geq_linear,
)
from jeicyboodsp_tpu_torch.oracle.gmm import (  # noqa: E402
    PCA_TEST, PCA_TRAIN, reference_read_models, reference_score, reference_score_file,
    reference_train_class,
)
from jeicyboodsp_tpu_torch.oracle.lpc import reference_lpc  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.mfcc import reference_mfcc  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.mvdr import reference_mvdr  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.nlms import (  # noqa: E402
    _double_talk, reference_bnlms_blocks, reference_nlms, reference_nlms_blocks,
)
from jeicyboodsp_tpu_torch.oracle.pitch import reference_pitch, reference_pitch_frames  # noqa: E402
from jeicyboodsp_tpu_torch.oracle.viterbi import reference_forward, reference_hmm_decode  # noqa: E402
# each kernel's bytes, operations and chain, and the card's peaks
from jeicyboodsp_tpu_torch.utils import profiling as PROF  # noqa: E402

FLOORS = {e: ENGINE_FIDELITY["enhance", e]["floor"] for e in ("mxu8f", "mxu8t", "mxu8", "mxu3")}
KERNEL_VS_PLAIN_DB = 90.0
F32_RTOL = 1e-5     # K4's f32 planes against f64: of each plane's row max
K4_F64_TOL = 2.0 ** -18  # K4's re/im vs f64 products: of each row's largest sum of |a*b|
K4_PLAIN_TOL = 2.0 ** -16  # K4 vs its plain version: of each row's largest sum of |a*b|
LATCH_RTOL = 1e-6
REPS = 7
BATCH_MS, BATCH_MAX = 2.0, 50  # back-to-back calls timed together (median_ms)
# the recursions at the sizes of the JAX package's benchmark (bench/all_configs.py:278, :498,
# :730), the shorter T of their plain loops, and their plain versions' timing T and repeats
GEQ_B, GEQ_T = 2048, 49152
AEC_B, AEC_T = 1024, 65536
PLAIN_T = {"K6": 4096, "K7": 4096, "K8": 2048, "K9": 8 * 1024}
PLAIN_TIME_T = {"K6": 256, "K7": 256, "K8": 256, "K9": 1024}
PLAIN_REPS = 3
GEQ_LINEAR_DB = 55.0  # K7's f32 cascade against a float64 one (tests/test_pallas_kernels.py:17)
# the figures of K6-K9 before their redesigns on the H100: chain cycles, and each
# kernel's time (NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 6)
OLD_CHAIN_CYCLES = {"K6": 60, "K8": 380, "K9": 9300}
PREVIOUS_MS = {"K6": 20.354, "K7": 6.951, "K8": 50.158, "K9": 15.567, "K11": 1.354, "K14": 0.035}
# the ops' times before K7, K9 and K11 were redesigned (the same card; PERF.md, section 5)
PREVIOUS_OP_MS = {"geq_apply f64": 3.371, "nlms_apply": 26.120, "bnlms_apply": 51.165,
                  "pitch_frames(method=2, mxu, f32)": 1.421}


def make_signal(n, rng):
    """Noisy gated 313 Hz tone: speech-like on/off segments over N(0, 20) noise."""
    t = np.arange(n) / FS
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


def vad_threshold_rows(w2):
    """(6, 512) int16 rows at the VAD's thresholds (WienerFilter_final.cpp:
    261-296) for the f32 window half w2, s = trunc(x * w2): three whose
    truncated samples alternate in sign (ZCR 511) with sum(s^2) = 700 *
    1024 - 1, + 0, + 1, and three of tiny energy with ZCR 199, 200, 201.
    Their flags: False, False, True, True, False, False."""
    w2 = np.asarray(w2, np.float32)

    def x_for(s, i):  # the smallest |x| whose truncated windowed value is s
        sign = 1 if s > 0 else -1
        for m in range(abs(s), 4 * abs(s) + 64):
            if int(np.trunc(np.float32(sign * m) * w2[i])) == s:
                return sign * m
        raise ValueError(f"no int16 sample gives {s} at {i}")

    unit = np.array([x_for((-1) ** i, i) for i in range(512)])  # s = +1, -1, ...
    rows = []
    for e in (716799, 716800, 716801):
        rest, abc = e - 509, None  # three large samples at 0..2, units elsewhere
        for a in range(int(rest ** 0.5), 0, -1):
            for b in range(min(a, int((rest - a * a) ** 0.5)), 0, -1):
                c = int(round((rest - a * a - b * b) ** 0.5))
                if 0 < c <= b and a * a + b * b + c * c == rest:
                    abc = (a, -b, c)
                    break
            if abc:
                break
        row = unit.copy()
        row[:3] = [x_for(s, i) for i, s in enumerate(abc)]
        rows.append(row)
    for z in (199, 200, 201):
        row = np.zeros(512, np.int64)
        row[: z + 1] = unit[: z + 1]
        rows.append(row)
    return np.array(rows, np.int16)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def card_clock_hz():
    """The card's highest SM clock, from nvidia-smi."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def median_ms(fn, sync, reps=REPS):
    """ms per call of fn: after a warm-up, ``reps`` batches of back-to-back
    calls between two CUDA events, each over its count, and their median.
    A batch runs for about BATCH_MS (one call where a call is longer), so a
    short kernel's time is the card's and not the host's launch path, as
    long as the host keeps ahead of the card."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()  # warm-up, and the length of one call
    b.record()
    sync()
    batch = max(1, min(BATCH_MAX, int(BATCH_MS / max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(reps):
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        sync()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def profile_call(fn, sync, top=8):
    """One warm-up call of fn, then one under torch.profiler: its wall ms
    (CUDA events), the device busy ms, and the ``top`` kernels by device time
    and host ops by self CPU time, each as (ms, count, name).  The port
    records its spans while the profiler runs (``utils.metrics``: with a
    drain before a session's output copy and NLMS's state copy); they are
    dropped after the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY

    fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    first = len(REGISTRY.spans())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
        sync()
    REGISTRY.take_spans(first)
    kernels, host = [], []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels.append((dev_us / 1e3, ev.count, ev.key))
        else:
            host.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
    busy = sum(k[0] for k in kernels)
    return a.elapsed_time(b), busy, sorted(kernels, reverse=True)[:top], sorted(host, reverse=True)[:top]


def bound_line(work):
    """A kernel's bound from its row of profiling.KERNELS, with the basis of
    the count: (ms, "bytes" or "operations", the text to print)."""
    b_ms, b_by = work.bound()
    return b_ms, b_by, (f"bound {b_ms:.4f} ms by {b_by} ({work.nbytes / 1e6:.1f} MB, "
                        f"{work.ops:.3g} {work.unit} ops; {work.basis})")


def rel_err(got, want):
    """max over rows of the max |error| over the row's max (0 on zero rows)"""
    return float(((got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-30)).max())


def int16_diff(got, want, what):
    """SNR, differing share and max |diff| of two int16 outputs; fails below
    KERNEL_VS_PLAIN_DB."""
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    got, want = got.cpu().numpy(), want.cpu().numpy()
    snr = snr_db(want, got)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"[3 kernel-vs-plain] {what} T={T_FULL}: {snr:.2f} dB, differing samples "
          f"{np.mean(d > 0):.3e}, max |diff| {d.max()}")
    if not snr >= KERNEL_VS_PLAIN_DB:
        raise RuntimeError(f"{what}: kernel vs plain {snr:.2f} dB < {KERNEL_VS_PLAIN_DB}")
    return int(d.max())


def _port():
    """The port's modules, imported from this checkout."""
    sys.path.insert(0, ROOT)
    from types import SimpleNamespace

    from jeicyboodsp_tpu_torch.kernels import _build
    from jeicyboodsp_tpu_torch.kernels import enhance_back_ola3 as K5
    from jeicyboodsp_tpu_torch.kernels import enhance_back_ola8 as K3
    from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K1
    from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
    from jeicyboodsp_tpu_torch.kernels import enhance_fwd_int8 as K2
    from jeicyboodsp_tpu_torch.ops import enhance as E
    from jeicyboodsp_tpu_torch.pipelines import registry

    from jeicyboodsp_tpu_torch.kernels import bnlms as K9
    from jeicyboodsp_tpu_torch.kernels import geq_cascade as K7
    from jeicyboodsp_tpu_torch.kernels import geq_cascade_quant as K6
    from jeicyboodsp_tpu_torch.kernels import nlms as K8
    from jeicyboodsp_tpu_torch.ops import geq as G
    from jeicyboodsp_tpu_torch.ops import nlms as N

    from jeicyboodsp_tpu_torch import cli
    from jeicyboodsp_tpu_torch.kernels import amdf as K11
    from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10
    from jeicyboodsp_tpu_torch.models import gmm as GM
    from jeicyboodsp_tpu_torch.ops import features as F
    from jeicyboodsp_tpu_torch.pipelines import speech as S

    from jeicyboodsp_tpu_torch.kernels import enhance_back as K13
    from jeicyboodsp_tpu_torch.kernels import fft_four_step as K12
    from jeicyboodsp_tpu_torch.kernels import enhance_chunk64 as K15
    from jeicyboodsp_tpu_torch.kernels import vad_flags as K14
    from jeicyboodsp_tpu_torch.ops import fastconv as FC
    from jeicyboodsp_tpu_torch.ops import fft as FT

    from jeicyboodsp_tpu_torch.models import hmm as H
    from jeicyboodsp_tpu_torch.ops import awgn as AW

    from jeicyboodsp_tpu_torch.ops import mvdr as MV
    from jeicyboodsp_tpu_torch.utils import cnum

    return SimpleNamespace(_build=_build, K1=K1, K2=K2, K3=K3, K4=K4, K5=K5, E=E,
                           registry=registry, K6=K6, K7=K7, K8=K8, K9=K9, G=G, N=N,
                           K10=K10, K11=K11, GM=GM, F=F, S=S, cli=cli,
                           K12=K12, K13=K13, K14=K14, K15=K15, FC=FC, FT=FT, H=H, AW=AW,
                           K8f32=K8, K9f32=K9, MV=MV, cnum=cnum)


K1_ENGINES = {"mxu8f": True, "mxu8t": False}  # the engines of K1: hq
MODES = ("wiener", "specsub")
RS_SLOTS = ("q_re", "q2_re", "q_im", "q2_im", "Yren", "y512")


def check_inv8(P, what, pk, pp, C, hq, sync):
    """The int8 inverse pass (K1's and K3's, on the tensor cores): uv
    bit-equal to the plain inverse of the kernel's own q8 and rowsc, else
    it raises.  Also prints where the kernel's scratch differs from the
    plain version's (pp): q8 bytes and rowsc slots."""
    import torch

    want = P.K1.inv8_plain(pk["q8"], pk["rowsc"], C, hq)
    sync()
    differ = int((pk["uv"].view(torch.int32) != want.view(torch.int32)).sum())
    q8_diff = int((pk["q8"] != pp["q8"]).sum())
    rs_diff = {k: int((pk["rowsc"][:, i].view(torch.int32) != pp["rowsc"][:, i].view(torch.int32))
                      .sum()) for i, k in enumerate(RS_SLOTS)}
    print(f"[3 kernel-vs-plain] {what} T={T_FULL}: uv bit-equal to the plain inverse of the "
          f"kernel's own q8 and rowsc {differ == 0} ({differ} of {want.numel()} differ); against "
          f"the plain version's scratch: q8 bytes differing {q8_diff} of {pk['q8'].numel()}, "
          f"rowsc rows differing {json.dumps(rs_diff)}")
    if differ:
        raise RuntimeError(f"{what}: {differ} uv values differ from the plain inverse")


def k4_f64_bases(device):
    """float64 (1024, 512) window-folded cos and sin bases of K4's function:
    the Hamming window with REF_PI times exp(-2 pi i n k / 1024)."""
    import torch

    n = np.arange(1024)
    ang = -2.0 * np.pi * n[:, None] * np.arange(512)[None, :] / 1024
    ham = (0.54 - 0.46 * np.cos(2.0 * REF_PI * n / 1023))[:, None]
    return tuple(torch.from_numpy(ham * f(ang)).to(device) for f in (np.cos, np.sin))


def check_k4(P, blocks, got, want, sync):
    """K4's planes: re, im and |X| within K4_PLAIN_TOL of each row's largest
    sum of |a*b| of the plain version; against float64 products of the
    frames and the f64 window-folded bases within F32_RTOL of each plane's
    row max and re, im within K4_F64_TOL of each row's largest sum of
    |a*b|.  Raises otherwise.  The plain version's own distance from f64 is
    printed beside: its cuBLAS f32 sums lose several 1e-5 of the im plane's
    row max where that plane is small beside re, more than the FFT does."""
    import torch

    WC, WS = k4_f64_bases(blocks.device)
    frames = P.K4.frames_f32(blocks).double()
    a = frames.abs()
    scale = torch.maximum(a @ WC.abs(), a @ WS.abs()).amax(1, keepdim=True).clamp_min(1e-30)
    re64, im64 = frames @ WC, frames @ WS
    exact = (re64, im64, torch.sqrt(re64 * re64 + im64 * im64))
    planes = (0, 1, 3)  # re, im, |X|
    vs_plain = max(float(((got[i].double() - want[i].double()).abs() / scale).max())
                   for i in planes)
    f64_rel = max(rel_err(got[i].double(), w) for i, w in zip(planes, exact))
    plain_rel = max(rel_err(want[i].double(), w) for i, w in zip(planes, exact))
    f64_sum = max(float(((got[i].double() - exact[i]).abs() / scale).max()) for i in (0, 1))
    sync()
    print(f"[3 kernel-vs-plain] K4 T={len(blocks)}: against the plain version max |err| / the "
          f"row's largest sum of |a*b| {vs_plain:.3e} (limit {K4_PLAIN_TOL:.3e}); against "
          f"float64 max err/rowmax {f64_rel:.2e} (limit {F32_RTOL}; the plain version's own "
          f"{plain_rel:.2e}), re/im max |err| / the row's largest sum of |a*b| {f64_sum:.3e} "
          f"(limit {K4_F64_TOL:.3e})")
    if not vs_plain <= K4_PLAIN_TOL:
        raise RuntimeError(f"K4: {vs_plain:.3e} of the row's sum of |a*b| from the plain "
                           f"version > {K4_PLAIN_TOL}")
    if not f64_rel <= F32_RTOL:
        raise RuntimeError(f"K4: planes differ from f64 by {f64_rel:.2e} of the row max > "
                           f"{F32_RTOL}")
    if not f64_sum <= K4_F64_TOL:
        raise RuntimeError(f"K4: {f64_sum:.3e} of the row's sum of |a*b| against f64 > "
                           f"{K4_F64_TOL}")


def check_kernels(P, blocks, C, rowpack, speech, sync):
    """Phase 3: every kernel against its plain version on the same inputs.
    Returns the max |kernel - plain| of each and the K3 / K5 inputs (the
    forward kernels' planes and the latch over them)."""
    import torch

    err = {"K1": 0}
    for mode in MODES:
        for eng, hq in K1_ENGINES.items():
            got, pk = P.K1.enhance_full8(blocks, rowpack, C, mode, hq, return_planes=True)
            want, pp = P.K1.enhance_full8_plain(blocks, rowpack, C, mode, hq, return_planes=True)
            sync()
            same = all(torch.equal(pk[k], pp[k]) for k in ("re", "im"))
            err["K1"] = max(err["K1"], int16_diff(got, want, f"K1 {mode} {eng}"))
            print(f"[3 kernel-vs-plain] K1 {mode} {eng}: forward planes bit-equal {same}")
            if not same:
                raise RuntimeError("K1: forward planes are not bit-equal to the plain version")
            check_inv8(P, f"K1 {mode} {eng}", pk, pp, C, hq, sync)

    back_ins = {}
    for name, (kernel, plain) in {"K2": (P.K2.enhance_fwd_int8, P.K2.enhance_fwd_int8_plain),
                                  "K4": (P.K4.enhance_fwd, P.K4.enhance_fwd_plain)}.items():
        got, want = kernel(blocks, C), plain(blocks, C)
        sync()
        planes = (0, 1, 3)  # re, im, |X|
        err[name] = max(float((got[i] - want[i]).abs().max()) for i in planes)
        rel = max(rel_err(got[i], want[i]) for i in planes)
        bit_equal = all(torch.equal(got[i], want[i]) for i in planes)
        flags_diff = int((got[5] != want[5]).sum())
        vad_diff = int(((got[5][:, 0] > 0.5) != speech).sum())
        print(f"[3 kernel-vs-plain] {name} T={T_FULL}: planes bit-equal {bit_equal}, "
              f"max err/rowmax {rel:.2e}, max |err| {err[name]:.3e}, Nyquist max |err| "
              f"{float((got[2] - want[2]).abs().max()):.3e}; speech flags differing from the "
              f"plain version {flags_diff}, from vad_flags {vad_diff} of {T_FULL}")
        if flags_diff:
            raise RuntimeError(f"{name}: {flags_diff} speech flags differ from the plain version")
        if name == "K2" and not bit_equal:
            raise RuntimeError("K2: re/im/|X| planes are not bit-equal to the plain version")
        if name == "K2" and not rel <= F32_RTOL:
            raise RuntimeError(f"{name}: planes differ by {rel:.2e} of the row max > {F32_RTOL}")
        if name == "K4":
            check_k4(P, blocks, got, want, sync)
        re, im, re_n, mag, mag_n, sp = got
        rp = P.E._latch_rowpack(sp[:, 0] > 0.5)
        ns, ns_n = P.K1.noise_latch(rp, mag, mag_n)
        want_ns = P.K1.latch_from_rowpack(rp, torch.cat([mag, mag_n], 1), 64)
        sync()
        lrel = float((torch.cat([ns, ns_n], 1) - want_ns).abs().max()
                     / want_ns.abs().max().clamp_min(1e-30))
        print(f"[3 kernel-vs-plain] noise latch on {name}'s planes: max err / max "
              f"{lrel:.2e}; {int((rp[:, 2] >= 0).sum())} rows latched")
        if not lrel <= LATCH_RTOL:
            raise RuntimeError(f"noise latch differs by {lrel:.2e} > {LATCH_RTOL}")
        back_ins[name] = (re, im, re_n, ns, ns_n)

    for name, (kernel, plain, fwd) in {
            "K3": (P.K3.enhance_back_ola8, P.K3.enhance_back_ola8_plain, "K2"),
            "K5": (P.K5.enhance_back_ola3, P.K5.enhance_back_ola3_plain, "K4")}.items():
        err[name] = 0
        for mode in MODES:
            got = kernel(*back_ins[fwd], C, mode)
            want = plain(*back_ins[fwd], C, mode)
            sync()
            err[name] = max(err[name], int16_diff(got, want, f"{name} {mode}"))
    for eng, hq in K1_ENGINES.items():  # K3's inverse pass, hq and turbo
        got, pk = P.K3.enhance_back_ola8(*back_ins["K2"], C, "wiener", hq, return_planes=True)
        want, pp = P.K3.enhance_back_ola8_plain(*back_ins["K2"], C, "wiener", hq,
                                                return_planes=True)
        err["K3"] = max(err["K3"], int16_diff(got, want, f"K3 wiener {eng}"))
        check_inv8(P, f"K3 wiener {eng}", pk, pp, C, hq, sync)
    return err, back_ins


def drive_main_path(P, dev, cases, refs, sync):
    """Phase 4: the file pipelines of every engine, with every launch
    counter set to 0 just before and read just after.  Returns the counts."""
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    counted = {"K1": P.K1.enhance_full8, "K2": P.K2.enhance_fwd_int8,
               "K3": P.K3.enhance_back_ola8, "K4": P.K4.enhance_fwd,
               "K5": P.K5.enhance_back_ola3, "latch": P.K1.noise_latch,
               "K14": P.K14.vad_flags}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    for c, x in cases.items():
        x.tofile(os.path.join(work, f"{c}.pcm"))
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = {}
    for c in cases:
        for mode in MODES:
            for eng in FLOORS:
                out = os.path.join(work, f"{c}_{mode}_{eng}.pcm")
                getattr(P.registry, mode)(os.path.join(work, f"{c}.pcm"), out,
                                          fft_engine=eng, device=dev)
                results[c, mode, eng] = np.fromfile(out, "<i2")
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0
    for (c, mode, eng), got in results.items():
        want = refs[c, mode]
        if got.shape != want.shape:
            raise RuntimeError(f"{c} {mode} {eng}: {got.shape} samples, want {want.shape}")
        if not len(want):
            continue
        snr = snr_db(want, got)
        print(f"[4 main-path] {c} {mode} {eng}: {len(got)} samples, {snr:.2f} dB vs reference")
        if not snr >= FLOORS[eng]:
            raise RuntimeError(f"{c} {mode} {eng}: {snr:.2f} dB < {FLOORS[eng]}")
    print(f"[4 main-path] empty payload -> 0 samples for every mode/engine; launches "
          f"{json.dumps(launches)} in {main_s:.1f} s")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the main path did not launch {missing}")
    return launches


COMPAT_FLIPPED = 1e-3  # f64 xla against the reference: one step, on under 0.1% of the samples
COMPAT_F32 = {"xla": 95.0, "mxu": 90.0}  # f32 with the log-depth scan (test_engine_matrix.py:39-55)


def drive_compat(P, dev, cases, refs, sync):
    """Phase 4, the compat path: the ``wiener`` / ``specsub`` CLI's default
    command (float64 ``xla``: torch ops, no kernel) on every case, f32
    ``xla`` and ``mxu`` with the log-depth scan on the probe, and ``wiener
    --fast --engine mxu8f`` from the CLI, the counters of the kernels these
    f32 paths run (K14, the latch, K1) set to 0 just before and read just
    after.  Returns the counts."""
    import torch

    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    counted = {"K1": P.K1.enhance_full8, "latch": P.K1.noise_latch, "K14": P.K14.vad_flags}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, secs = {}, {}
    for c in cases:
        for mode in MODES:
            path = os.path.join(work, f"{c}_{mode}_compat.pcm")
            t1 = time.perf_counter()
            P.cli.main([mode, os.path.join(work, f"{c}.pcm"), path, "--device", str(dev)])
            secs[c, mode] = time.perf_counter() - t1
            out[c, mode] = np.fromfile(path, "<i2")
    f32 = {(mode, eng): P.E.run_stream(cases["probe"], mode, dtype=torch.float32,
                                       use_assoc_scan=True, fft_engine=eng, device=dev)
           for mode in MODES for eng in COMPAT_F32}
    fast = os.path.join(work, "probe_wiener_fast_mxu8f.pcm")
    P.cli.main(["wiener", os.path.join(work, "probe.pcm"), fast, "--fast", "--engine", "mxu8f",
                "--device", str(dev)])
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0
    for (c, mode), got in out.items():
        want = refs[c, mode]
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        flipped = int((d > 0).sum())
        ok = got.shape == want.shape and d.max(initial=0) <= 1 and flipped < COMPAT_FLIPPED * max(
            len(want), 1)
        print(f"[4 compat] {mode} IN OUT (f64 xla) {c}: {len(got)} samples, {flipped} flipped, "
              f"max |diff| {d.max(initial=0)}, {secs[c, mode]:.3f} s from the CLI")
        if not ok:
            raise RuntimeError(f"compat {mode} {c}: {flipped} samples flipped, max |diff| "
                               f"{d.max(initial=0)}")
    for (mode, eng), got in f32.items():
        snr = snr_db(refs["probe", mode], got)
        print(f"[4 compat] run_stream {mode} f32 {eng} (log-depth scan) probe: {snr:.2f} dB "
              f"(floor {COMPAT_F32[eng]})")
        if not snr >= COMPAT_F32[eng]:
            raise RuntimeError(f"f32 {eng} {mode}: {snr:.2f} dB < {COMPAT_F32[eng]}")
    snr = snr_db(refs["probe", "wiener"], np.fromfile(fast, "<i2"))
    print(f"[4 compat] wiener IN OUT --fast --engine mxu8f probe: {snr:.2f} dB (floor "
          f"{FLOORS['mxu8f']}); launches {json.dumps(launches)} in {main_s:.1f} s")
    if not snr >= FLOORS["mxu8f"]:
        raise RuntimeError(f"--fast --engine mxu8f: {snr:.2f} dB < {FLOORS['mxu8f']}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the compat phase's f32 paths did not launch {missing}")
    return launches


def gemm_cores(P, blocks, C, back_ins):
    """One PyTorch call per kernel that computes its GEMM core on the same
    operands (timed as library_ms; the port never calls them); None for K1,
    whose function no single call computes."""
    import torch

    K1, i8 = P.K1, torch.int8
    cur = blocks.to(torch.int32)
    ph, pl = K1._split8(torch.cat([torch.zeros_like(cur[:1]), cur[:-1]]))  # prev rows
    ch, cl = K1._split8(cur)
    a2 = torch.cat([torch.cat([ph, ch], 1), torch.cat([pl, cl], 1)]).to(i8)  # (2T, 1024)
    w8 = C["fwd8"].transpose(1, 2)  # [k, n]: WhCp WlCp WhCc WlCc WhSp WlSp WhSc WlSc
    # B operands column-major, the layout cuBLAS's int8 GEMM takes without a copy
    b2 = torch.cat([torch.cat([w8[i], w8[i + 1], w8[i + 4], w8[i + 5]], 1)
                    for i in (0, 2)]).t().contiguous().t()  # (1024, 2048): 16 dots' MACs
    re, im, re_n, ns, ns_n = back_ins["K2"]
    g, _ = K1.bin_gain(re, im, re_n[:, 0], ns, ns_n[:, 0], "wiener")
    qre, qim = (K1._quant_row_int8(Y, True) for Y in (re * g, im * g))
    a3 = torch.cat([torch.cat([qre[i], qim[i]], 1) for i in (0, 1, 3)]).to(i8)  # h, l, z2
    u8 = C["back8"].transpose(1, 2)  # [k, s]: Uh Ul Vh Vl
    b3 = torch.cat([torch.cat([u8[0], u8[1]], 1),
                    torch.cat([u8[2], u8[3]], 1)]).t().contiguous().t()  # (1024, 1024)
    frames = P.K4.frames_f32(blocks)
    wcs = torch.cat([C["WC"], C["WS"]], 1)  # (1024, 1024)
    re, im, re_n, ns, ns_n = back_ins["K4"]
    g, _ = K1.bin_gain(re, im, re_n[:, 0], ns, ns_n[:, 0], "wiener")
    y5 = torch.stack([re * g, im * g])
    b5 = torch.stack([C["UC512"], C["VS512"]])
    return {"K1": None, "K2": lambda: torch._int_mm(a2, b2), "K3": lambda: torch._int_mm(a3, b3),
            "K4": lambda: frames @ wcs, "K5": lambda: torch.matmul(y5, b5)}


def time_kernels(P, blocks, C, rowpack, back_ins, card, sync):
    """Phase 5: each kernel, its plain version and its GEMM core at
    T = 16384 in turns, with its bound.  Returns the numbers per kernel."""
    import torch

    K1, K2, K3, K4, K5 = P.K1, P.K2, P.K3, P.K4, P.K5
    runs = {  # kernel, plain version
        "K1": (lambda: K1.enhance_full8(blocks, rowpack, C, "wiener", True),
               lambda: K1.enhance_full8_plain(blocks, rowpack, C, "wiener", True)),
        "K2": (lambda: K2.enhance_fwd_int8(blocks, C),
               lambda: K2.enhance_fwd_int8_plain(blocks, C)),
        "K3": (lambda: K3.enhance_back_ola8(*back_ins["K2"], C, "wiener"),
               lambda: K3.enhance_back_ola8_plain(*back_ins["K2"], C, "wiener")),
        "K4": (lambda: K4.enhance_fwd(blocks, C), lambda: K4.enhance_fwd_plain(blocks, C)),
        "K5": (lambda: K5.enhance_back_ola3(*back_ins["K4"], C, "wiener"),
               lambda: K5.enhance_back_ola3_plain(*back_ins["K4"], C, "wiener")),
    }
    library = gemm_cores(P, blocks, C, back_ins)
    times = {}
    for name, (kern, plain) in runs.items():
        ms, plain_ms = median_ms(kern, sync), median_ms(plain, sync)
        lib_ms = median_ms(library[name], sync) if library[name] else None
        b_ms, b_by, b_text = bound_line(PROF.KERNELS[name](T_FULL))
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms)
        print(f"[5 timing] {name} wiener T={T_FULL} on {card}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, GEMM core {'-' if lib_ms is None else '%.3f ms' % lib_ms}, "
              f"{b_text}")
    win = torch.from_numpy(P.K4.rfft_constants()[P.K4.WINDOW:]).to(blocks.device)
    windowed = P.K4.frames_f32(blocks) * win
    times["K4"]["library_ms"] = fft_library_turns(
        "K4", lambda: K4.enhance_fwd(blocks, C), library["K4"],
        lambda: torch.fft.rfft(windowed), card, sync)
    mag, mag_n = K2.enhance_fwd_int8(blocks, C)[3:5]
    latch = (median_ms(lambda: K1.noise_latch(rowpack, mag, mag_n), sync),
             median_ms(lambda: K1.latch_from_rowpack(rowpack, torch.cat([mag, mag_n], 1), 64),
                       sync))
    print(f"[5 timing] noise latch T={T_FULL} on {card}: kernel {latch[0]:.3f} ms, "
          f"plain {latch[1]:.3f} ms")
    return times


def fft_library_turns(name, kern, core, rfft, card, sync):
    """K4 or K10 in turns with its two PyTorch calls of the same function (the
    f32 matmul of the dense-DFT core, torch.fft.rfft of the windowed f32
    frames): kernel, core, rfft, rfft, core, kernel.  Prints them and the
    kernel's and rfft's device time under torch.profiler; returns the faster
    call's ms."""
    t = [median_ms(f, sync) for f in (kern, core, rfft, rfft, core, kern)]
    k, c, r = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
    print(f"[5 timing] {name} in turns on {card}: kernel {t[0]:.4f} / {t[5]:.4f} ms, f32 "
          f"matmul core {t[1]:.4f} / {t[4]:.4f} ms, torch.fft.rfft {t[2]:.4f} / {t[3]:.4f} ms; "
          f"faster than the core {k < c}, than rfft {k < r}")
    for what, fn in (("kernel", kern), ("torch.fft.rfft", rfft)):
        wall, busy, kernels, _ = profile_call(fn, sync, top=4)
        top = ", ".join(f"{kn[:40]} x{cnt} {ms:.4f}" for ms, cnt, kn in kernels)
        print(f"[5 profile] {name} {what} alone under torch.profiler on {card}: wall {wall:.4f} "
              f"ms, device busy {busy:.4f} ms; kernels by device time (ms): {top}")
    return min(c, r)


def time_chains(P, blocks, C, card, sync):
    """Phase 5: ``enhance_blocks`` of each engine against the same chain of
    plain versions."""
    import torch

    K1, E = P.K1, P.E

    def plain_chain(eng):
        sp = E.vad_flags(blocks, torch.float32)
        if eng in K1_ENGINES:
            return K1.enhance_full8_plain(blocks, E._latch_rowpack(sp), C, "wiener",
                                          K1_ENGINES[eng])
        fwd, back = ((P.K2.enhance_fwd_int8_plain, P.K3.enhance_back_ola8_plain)
                     if eng == "mxu8" else
                     (P.K4.enhance_fwd_plain, P.K5.enhance_back_ola3_plain))
        re, im, re_n, mag, mag_n, sp = fwd(blocks, C)
        ns = K1.latch_from_rowpack(E._latch_rowpack(sp[:, 0] > 0.5),
                                   torch.cat([mag, mag_n], 1), 64)
        return back(re, im, re_n, ns[:, :512].contiguous(), ns[:, 512:].contiguous(), C,
                    "wiener")

    for eng in FLOORS:
        ms = median_ms(lambda: E.enhance_blocks(blocks, "wiener", fft_engine=eng,
                                                resynth="ratio"), sync)
        plain_ms = median_ms(lambda: plain_chain(eng), sync)
        print(f"[5 timing] wiener {eng} T={T_FULL} on {card}: enhance_blocks {ms:.3f} ms = "
              f"{T_FULL * 512 / (ms * 1e-3):.4g} samples/s; plain version {plain_ms:.3f} ms = "
              f"{T_FULL * 512 / (plain_ms * 1e-3):.4g} samples/s")


def make_geq_streams(B, T, dev):
    """(B, T) int16 audio at 48 kHz: per stream a tone (50-8050 Hz, amplitude
    up to 8000) over N(0, 500) noise; the first B/8 streams full-scale random
    int16, where the +12 dB bands overflow and wrap.  Made on the card from
    SEED."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.arange(T, **f32) / 48000.0
    f = 50.0 + 8000.0 * torch.rand(B, 1, generator=g, **f32)
    amp = 8000.0 * torch.rand(B, 1, generator=g, **f32)
    x = amp * torch.sin(2 * np.pi * f * t) + 500.0 * torch.randn(B, T, generator=g, **f32)
    x = x.clamp(-32768, 32767).to(torch.int16)
    x[: B // 8] = torch.randint(-32768, 32768, (B // 8, T), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int16)
    return x


def make_aec_streams(B, T, dev):
    """(B, T) int16 far ends N(0, 3000) and near ends: the far end's echo
    (0.5 x[t] + 0.2 x[t-7] - 0.1 x[t-19]) plus N(0, 50) noise; in the last
    quarter of the streams an independent N(0, 2000) near-end talker too
    (double talk).  Made on the card from SEED."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32 = dict(dtype=torch.float32, device=dev)
    x = (3000.0 * torch.randn(B, T, generator=g, **f32)).clamp(-32768, 32767).round()

    def delay(v, k):
        return torch.nn.functional.pad(v, (k, 0))[:, :T]

    r = 0.5 * x + 0.2 * delay(x, 7) - 0.1 * delay(x, 19)
    r = r + 50.0 * torch.randn(B, T, generator=g, **f32)
    r[3 * B // 4:] += 2000.0 * torch.randn(B - 3 * B // 4, T, generator=g, **f32)
    return x.to(torch.int16), r.clamp(-32768, 32767).to(torch.int16)


def _bit_equal(name, what, pairs):
    """Fails unless every (kernel, plain) pair is bit-equal; returns the max
    |difference| (0)."""
    pairs = list(pairs)
    diff = sum(int((g != w).sum()) for g, w in pairs)
    worst = max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
                for g, w in pairs)
    print(f"[3 kernel-vs-plain] {name} {what}: bit-equal {diff == 0}, differing values {diff}, "
          f"max |diff| {worst:g}")
    if diff:
        raise RuntimeError(f"{name} {what}: {diff} values differ from the plain version")
    return worst


def check_recursions(P, geq, aec, sync):
    """Phase 3 for K6-K9: each kernel against its plain version at the full
    stream count and the shorter T of PLAIN_T.  Returns the max |kernel -
    plain| of each."""
    import torch

    dev = geq.device
    b, a = P.G.geq_coefficients()
    c64 = torch.from_numpy(P.K7.pack_coefficients(b, a, np.float64)).to(dev)
    c32 = torch.from_numpy(P.K7.pack_coefficients(b, a)).to(dev)
    err = {}
    x = geq[:, :PLAIN_T["K6"]].contiguous()
    got = P.K6.geq_cascade_quant(x, c64)
    want = P.K6.geq_cascade_quant_plain(x, c64, P.K6.init_state(len(x), dev))
    sync()
    err["K6"] = _bit_equal("K6", f"B={len(x)} T={x.shape[1]} (y, state)", zip(got, want))
    got = P.K6.geq_cascade_quant(x, c32)  # the f32 instance (geq_apply's default, geq --fast)
    want = P.K6.geq_cascade_quant_plain(x, c32, P.K6.init_state(len(x), dev))
    sync()
    err["K6"] = max(err["K6"], _bit_equal("K6", f"f32 B={len(x)} T={x.shape[1]} (y, state)",
                                          zip(got, want)))
    x3 = geq.repeat(-(-3072 // len(geq)), 1)[:3072, :512].contiguous()  # B = 3072
    got = P.K6.geq_cascade_quant(x3, c64)
    want = P.K6.geq_cascade_quant_plain(x3, c64, P.K6.init_state(len(x3), dev))
    sync()
    err["K6"] = max(err["K6"], _bit_equal("K6", "B=3072 T=512 (y, state)", zip(got, want)))
    xf = geq[:, :PLAIN_T["K7"]].float().contiguous()
    got, want = P.K7.geq_cascade(xf, c32), P.K7.geq_cascade_plain(xf, c32)
    sync()
    err["K7"] = _bit_equal("K7", f"B={len(xf)} T={xf.shape[1]}", [(got, want)])
    xa, ra = (v[:, :PLAIN_T["K8"]].contiguous() for v in aec)
    err["K8"] = 0.0
    for compat in (True, False):
        got = P.K8.nlms(xa, ra, compat=compat)
        want = P.K8.nlms_plain(xa, ra, *P.K8.init_state(len(xa), dev), compat=compat)
        sync()
        pairs = list(zip(got[:2], want[:2])) + list(zip(got[2], want[2]))
        err["K8"] = max(err["K8"], _bit_equal(
            "K8", f"compat={compat} B={len(xa)} T={xa.shape[1]} (est, err, coef, hist)", pairs))
    # T = 257 (the window's first 256 samples and a chunk's edge) from a nonzero state:
    # the 255 far-end samples before it as history, small coefficients, every fifth -0.0
    t0 = PLAIN_T["K8"]
    xa, ra = (v[:, t0:t0 + 257].contiguous() for v in aec)
    hist = aec[0][:, t0 - 255:t0].contiguous()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    coef = 1e-3 * torch.randn(len(xa), 256, generator=g, dtype=torch.float64, device=dev)
    coef[:, ::5] = -0.0
    for compat in (True, False):
        got = P.K8.nlms(xa, ra, (coef, hist), compat=compat)
        want = P.K8.nlms_plain(xa, ra, coef, hist, compat=compat)
        sync()
        pairs = list(zip(got[:2], want[:2])) + [(got[2][0].view(torch.int64),
                                                 want[2][0].view(torch.int64)),
                                                (got[2][1], want[2][1])]
        err["K8"] = max(err["K8"], _bit_equal(
            "K8", f"compat={compat} B={len(xa)} T=257 from a nonzero state (est, err, "
            "coef bits, hist)", pairs))
    xa, ra = (v[:, :PLAIN_T["K9"]].contiguous() for v in aec)
    keep = torch.zeros(len(xa), 127, dtype=torch.int16, device=dev)
    gates = P.K9.bnlms_gates(xa, ra, keep, keep)
    gates[::3, 1::2] = False  # random audio opens every gate: shut some for the kernel's other path
    got = P.K9.bnlms(xa, ra, gates)
    want = P.K9.bnlms_plain(xa, ra, gates, *P.K9.init_state(len(xa), dev))
    sync()
    pairs = list(zip(got[:2], want[:2])) + list(zip(got[2], want[2]))
    err["K9"] = _bit_equal("K9", f"B={len(xa)} {xa.shape[1] // 1024} blocks, "
                           f"{int(gates.sum())} of {gates.numel()} gates open "
                           "(est, err, coef, keep)", pairs)
    return err


def _probe_signals():
    """The pipelines' probe signals, from SEED: a GEQ probe of 8 blocks of
    tone and 2 of full-scale random int16; an echo pair of 6 blocks; and a
    pair whose gate stays shut (a non-negative far end against a
    non-positive near end)."""
    rng = np.random.default_rng(SEED + 2)
    n = 8 * 512
    t = np.arange(n) / 48000.0
    tone = 8000 * np.sin(2 * np.pi * 440 * t) + 4000 * np.sin(2 * np.pi * 3000 * t)
    tone = np.clip(tone + rng.normal(0, 500, n), -32768, 32767).astype(np.int16)
    geq = np.concatenate([tone, rng.integers(-32768, 32768, 2 * 512).astype(np.int16)])
    m = 6 * 1024
    x = np.clip(rng.normal(0, 3000, m), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    r = np.clip(np.convolve(x.astype(np.float64), h)[:m] + rng.normal(0, 50, m),
                -32768, 32767).astype(np.int16)
    xs = np.abs(x[:3 * 1024].astype(np.int32)).clip(0, 32767).astype(np.int16)
    return geq, {"echo": (x, r), "partial": (x[:4 * 1024 + 300], r[:4 * 1024 + 500]),
                 "shut": (xs, -(xs // 2)), "empty": (x[:0], r[:0])}


def drive_recursions(P, geq, aec, sync):
    """Phase 4 for the GEQ, NLMS and BNLMS paths, every K6-K9 launch counter
    set to 0 just before and read just after: the file pipelines on the
    probes, then the batched ops at full size, chained and whole.  Returns
    the counts."""
    import torch

    G, N, dev = P.G, P.N, geq.device
    counted = {"K6": P.K6.geq_cascade_quant, "K7": P.K7.geq_cascade, "K8": P.K8.nlms,
               "K9": P.K9.bnlms}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    b, a = G.geq_coefficients()
    c32 = torch.from_numpy(P.K7.pack_coefficients(b, a)).to(dev)
    gprobe, pairs = _probe_signals()
    geq_cases = {"probe": gprobe, "partial": gprobe[: 5 * 512 + 300], "empty": gprobe[:0]}
    hdr = np.arange(22, dtype=np.int16)  # 44 header bytes, skipped by geq and for IN
    for c, x in geq_cases.items():
        np.concatenate([hdr, x]).tofile(os.path.join(work, f"geq_{c}.wav"))
    for c, (x, r) in pairs.items():
        np.concatenate([hdr, x]).tofile(os.path.join(work, f"aec_{c}_in.wav"))
        r.tofile(os.path.join(work, f"aec_{c}_ref.pcm"))
    refs = {("geq", c): reference_geq(x, b, a) for c, x in geq_cases.items()}
    refs.update({("geq --fast", c): reference_geq_f32(x, b, a) for c, x in geq_cases.items()})
    for c, (x, r) in pairs.items():
        refs["nlms", c] = reference_nlms(x, r)
        refs["bnlms", c] = reference_nlms(x, r, bnlms=True)
    zeros = {"xh": torch.zeros(GEQ_B, 2, dtype=torch.int32),
             "yh": torch.zeros(GEQ_B, 7, 2, dtype=torch.int32)}
    half = GEQ_T // 2

    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = {}
    for c in geq_cases:
        path = os.path.join(work, f"geq_{c}.pcm")
        P.registry.geq(os.path.join(work, f"geq_{c}.wav"), path, device=dev)
        out["geq", c] = np.fromfile(path, "<i2")
        path = os.path.join(work, f"geq_fast_{c}.pcm")  # K6's f32 instance, from the CLI
        P.cli.main(["geq", os.path.join(work, f"geq_{c}.wav"), path, "--fast", "--device", str(dev)])
        out["geq --fast", c] = np.fromfile(path, "<i2")
    for prog in ("nlms", "bnlms"):
        for c in pairs:
            est, errp = (os.path.join(work, f"{prog}_{c}_{k}.pcm") for k in ("est", "err"))
            getattr(P.registry, prog)(os.path.join(work, f"aec_{c}_in.wav"),
                                      os.path.join(work, f"aec_{c}_ref.pcm"), est, errp, device=dev)
            out[prog, c] = (np.fromfile(est, "<i2"), np.fromfile(errp, "<i2"))
    # the batched ops at full size: one whole call, and two chained with state;
    # the GEQ's fast engine, which callers run as the kernel wrapper
    yl = P.K7.geq_cascade(geq.float(), c32)
    f64 = torch.float64  # the reference's arithmetic: K6's record stays comparable
    yw, sw = G.geq_apply(geq, b, a, zeros, dtype=f64)
    y1, s1 = G.geq_apply(geq[:, :half], b, a, zeros, dtype=f64)
    y2, s2 = G.geq_apply(geq[:, half:], b, a, s1, dtype=f64)
    fw, fsw = G.geq_apply(geq, b, a, zeros)  # the op's default, f32: K6's f32 instance
    f1, fs1 = G.geq_apply(geq[:, :half], b, a, zeros)
    f2, fs2 = G.geq_apply(geq[:, half:], b, a, fs1)
    x, r = aec
    n0 = N.nlms_init_state()
    nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in n0.items()}
    ew, rw, nw = N.nlms_apply(x, r, nz)
    e1, r1, ns = N.nlms_apply(x[:, :AEC_T // 2], r[:, :AEC_T // 2], nz)
    e2, r2, ns = N.nlms_apply(x[:, AEC_T // 2:], r[:, AEC_T // 2:], ns)
    bz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.bnlms_init_state().items()}
    xb, rb = x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024)
    nb2 = xb.shape[1] // 2
    bw, bew, bsw = N.bnlms_apply(xb, rb, bz)
    b1, be1, bs = N.bnlms_apply(xb[:, :nb2], rb[:, :nb2], bz)
    b2, be2, bs = N.bnlms_apply(xb[:, nb2:], rb[:, nb2:], bs)
    # B = 3072 (the JAX op raises there): the streams repeated
    g3 = geq.repeat(-(-3072 // len(geq)), 1)[:3072, :2048]
    z3 = {k: torch.zeros(3072, *v.shape[1:], dtype=v.dtype) for k, v in zeros.items()}
    y3, _ = G.geq_apply(g3, b, a, z3, dtype=f64)
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0

    for c, want in [(c, refs["geq", c]) for c in geq_cases]:
        got = out["geq", c]
        ok = got.shape == want.shape and np.array_equal(got, want)
        print(f"[4 main-path] geq {c}: {len(got)} samples, byte-identical to the reference {ok}")
        if not ok:
            raise RuntimeError(f"geq {c}: differs from the reference")
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    for c in geq_cases:  # f32: equal to its numpy copy, no floor against the reference
        got, want, ref = out["geq --fast", c], refs["geq --fast", c], refs["geq", c]
        ok = got.shape == want.shape and np.array_equal(got, want)
        n_diff = int((got != ref).sum()) if got.shape == ref.shape else -1
        snr = snr_db(ref, got) if len(ref) else float("nan")
        print(f"[4 main-path] geq --fast {c}: {len(got)} samples, byte-identical to the float32 "
              f"copy {ok}; against the float64 reference {snr:.2f} dB, {n_diff} samples differ")
        if not ok:
            raise RuntimeError(f"geq --fast {c}: differs from the float32 copy")
    for i in (0, GEQ_B - 1):  # a wrap-stress stream and a tone
        got = c_short(yl[i].cpu().numpy())
        snr = snr_db(reference_geq_linear(geq[i].cpu().numpy(), b, a), got)
        print(f"[4 main-path] full size, K7 (the linear engine) stream {i}: {snr:.2f} dB vs a "
              f"float64 linear cascade (floor {GEQ_LINEAR_DB})")
        if not snr >= GEQ_LINEAR_DB:
            raise RuntimeError(f"K7 stream {i}: {snr:.2f} dB < {GEQ_LINEAR_DB}")
    for prog in ("nlms", "bnlms"):
        for c in pairs:
            want = refs[prog, c]
            got = out[prog, c]
            ok = all(g.shape == w.shape and np.array_equal(g, w) for g, w in zip(got, want))
            print(f"[4 main-path] {prog} {c}: {len(got[0])} samples, est and err int16-equal to "
                  f"the reference {ok}")
            if not ok:
                raise RuntimeError(f"{prog} {c}: differs from the reference")
    # the gate: the port's float64 FFT against the direct float64 sums
    gdiff, gn = 0, 0
    for c, (xp, rp) in pairs.items():
        nb = -(-min(len(xp), len(rp)) // 1024)
        if nb == 0:
            continue
        xs = torch.from_numpy(stale_blocks(xp, 1024)[:nb].reshape(1, -1)).to(dev)
        rs = torch.from_numpy(stale_blocks(rp, 1024)[:nb].reshape(1, -1)).to(dev)
        keep = torch.zeros(1, 127, dtype=torch.int16, device=dev)
        got = P.K9.bnlms_gates(xs, rs, keep, keep)[0, 1:].tolist()  # the written blocks
        gdiff += sum(g != w for g, w in zip(got, refs["bnlms", c][2][1:]))
        gn += len(got)
    S = 8  # full-size streams whose every gate is checked
    keep = torch.zeros(S, 127, dtype=torch.int16, device=dev)
    xs8, rs8 = x[-S:].contiguous(), r[-S:].contiguous()  # double-talk streams
    got8 = P.K9.bnlms_gates(xs8, rs8, keep, keep).cpu().numpy()
    for i in range(S):
        u = np.concatenate([np.zeros(127), xs8[i].cpu().numpy().astype(np.float64)])
        v = np.concatenate([np.zeros(127), rs8[i].cpu().numpy().astype(np.float64)])
        for k in range(AEC_T // 1024):
            want = not _double_talk(u[k * 1024:k * 1024 + 1151], v[k * 1024:k * 1024 + 1151])
            gdiff += int(bool(got8[i, k]) != want)
            gn += 1
    print(f"[4 main-path] bnlms gate decisions (float64 FFT) differing from the direct float64 "
          f"sums: {gdiff} of {gn} (probes, and all blocks of {S} full-size double-talk streams)")
    if gdiff:
        raise RuntimeError(f"{gdiff} gate decisions differ from the direct float64 sums")

    chained = {
        "K6 geq_apply": (torch.equal(torch.cat([y1, y2], 1), yw)
                         and all(torch.equal(s2[k], sw[k]) for k in sw)),
        "K6 geq_apply f32 (the default)": (torch.equal(torch.cat([f1, f2], 1), fw)
                                           and all(torch.equal(fs2[k], fsw[k]) for k in fsw)),
        "K8 nlms_apply": (torch.equal(torch.cat([e1, e2], 1), ew)
                          and torch.equal(torch.cat([r1, r2], 1), rw)
                          and all(torch.equal(ns[k], nw[k]) for k in nw)),
        "K9 bnlms_apply": (torch.equal(torch.cat([b1, b2], 1), bw)
                           and torch.equal(torch.cat([be1, be2], 1), bew)
                           and all(torch.equal(bs[k], bsw[k]) for k in bsw)),
    }
    for what, ok in chained.items():
        print(f"[4 main-path] {what} at full size: two chained calls with state equal one "
              f"whole call {ok}")
        if not ok:
            raise RuntimeError(f"{what}: chained calls differ from the whole call")
    sampled = {
        "full size, geq stream 0 (wrap stress)": (yw[0].cpu().numpy(),
                                                  reference_geq(geq[0].cpu().numpy(), b, a)),
        f"full size, geq stream {GEQ_B - 1} (tone)": (yw[-1].cpu().numpy(),
                                          reference_geq(geq[-1].cpu().numpy(), b, a)),
        "full size, geq f32 stream 0 (wrap stress)": (
            fw[0].cpu().numpy(), reference_geq_f32(geq[0].cpu().numpy(), b, a)),
    }
    for i in (0, 2047, 2048, 3071):
        sampled[f"geq B=3072 T=2048 stream {i}"] = (y3[i].cpu().numpy(),
                                                     reference_geq(g3[i].cpu().numpy(), b, a))
    # every block of an echo stream and of a double-talk stream, est and err
    for i, kind in ((0, "echo"), (AEC_B - 1, "double talk")):
        xi, ri = (v[i].cpu().numpy().reshape(-1, 1024) for v in (x, r))
        ref_n = reference_nlms_blocks(xi, ri)
        sampled[f"full size, nlms stream {i} ({kind}), all {len(xi)} blocks"] = (
            np.concatenate([ew[i].cpu().numpy(), rw[i].cpu().numpy()]),
            np.concatenate([ref_n[0].reshape(-1), ref_n[1].reshape(-1)]))
        ref_b = reference_bnlms_blocks(xi, ri)
        sampled[f"full size, bnlms stream {i} ({kind}), all {len(xi)} blocks"] = (
            np.concatenate([bw[i].cpu().numpy().reshape(-1), bew[i].cpu().numpy().reshape(-1)]),
            np.concatenate([ref_b[0].reshape(-1), ref_b[1].reshape(-1)]))
    for what, (got, want) in sampled.items():
        ok = np.array_equal(got, want)
        print(f"[4 main-path] {what}: equal to the reference {ok} "
              f"({int((got != want).sum()) if got.shape == want.shape else 'shape'} differ)")
        if not ok:
            raise RuntimeError(f"{what}: differs from the reference")
    print(f"[4 main-path] GEQ {GEQ_B}x{GEQ_T}, NLMS/BNLMS {AEC_B}x{AEC_T}: launches "
          f"{json.dumps(launches)} in {main_s:.1f} s")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the main path did not launch {missing}")
    return launches


def time_recursions(P, geq, aec, card, sync):
    """Phase 5 for K6-K9: each kernel at full size (median of REPS) and its
    plain version at PLAIN_TIME_T (median of PLAIN_REPS), with the bytes,
    operations and chain bounds.  Returns the numbers per kernel."""
    import torch

    dev = geq.device
    b, a = P.G.geq_coefficients()
    c64 = torch.from_numpy(P.K7.pack_coefficients(b, a, np.float64)).to(dev)
    c32 = torch.from_numpy(P.K7.pack_coefficients(b, a)).to(dev)
    gf = geq.float()
    x, r = aec
    keep = torch.zeros(AEC_B, 127, dtype=torch.int16, device=dev)
    gates = P.K9.bnlms_gates(x, r, keep, keep)
    n_open = int(gates.sum())
    gate_ms = median_ms(lambda: P.K9.bnlms_gates(x, r, keep, keep), sync)
    st6 = P.K6.init_state(GEQ_B, dev)
    st8, st9 = P.K8.init_state(AEC_B, dev), P.K9.init_state(AEC_B, dev)
    cut = lambda v, k: v[:, :PLAIN_TIME_T[k]].contiguous()  # noqa: E731
    n_geq, n_aec = GEQ_B * GEQ_T, AEC_B * AEC_T
    runs = {  # kernel, plain at its timing T, its work (profiling.KERNELS)
        "K6": (lambda: P.K6.geq_cascade_quant(geq, c64),
               lambda: P.K6.geq_cascade_quant_plain(cut(geq, "K6"), c64, st6),
               PROF.KERNELS["K6"](GEQ_B, GEQ_T)),
        "K7": (lambda: P.K7.geq_cascade(gf, c32),
               lambda: P.K7.geq_cascade_plain(cut(gf, "K7"), c32),
               PROF.KERNELS["K7"](GEQ_B, GEQ_T)),
        "K8": (lambda: P.K8.nlms(x, r),
               lambda: P.K8.nlms_plain(cut(x, "K8"), cut(r, "K8"), *st8),
               PROF.KERNELS["K8"](AEC_B, AEC_T)),
        "K9": (lambda: P.K9.bnlms(x, r, gates),
               lambda: P.K9.bnlms_plain(cut(x, "K9"), cut(r, "K9"), cut(gates, "K9"), *st9),
               PROF.KERNELS["K9"](AEC_B, AEC_T, n_open)),
    }
    clock_hz = card_clock_hz()
    times = {}
    for name, (kern, plain, work) in runs.items():
        ms = median_ms(kern, sync)
        plain_ms = median_ms(plain, sync, reps=PLAIN_REPS)
        b_ms, b_by, b_text = bound_line(work)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        T = GEQ_T if name in ("K6", "K7") else AEC_T
        old_chain = (f"; {OLD_CHAIN_CYCLES[name]} cycles before the redesign"
                     if name in OLD_CHAIN_CYCLES else "")
        print(f"[5 timing] {name} {GEQ_B if T == GEQ_T else AEC_B}x{T} on {card}: kernel "
              f"{ms:.3f} ms = {(n_geq if T == GEQ_T else n_aec) / (ms * 1e-3):.4g} samples/s; "
              f"plain {plain_ms:.3f} ms at T={PLAIN_TIME_T[name]}; {b_text}; chain bound "
              f"{work.chain_ms(clock_hz):.3f} ms ({work.chain_cycles} cycles x "
              f"{work.chain_steps} steps at {clock_hz / 1e6:.0f} MHz{old_chain}); library call: "
              f"none; previously {PREVIOUS_MS[name]:.3f} ms")
    k6_f32 = median_ms(lambda: P.K6.geq_cascade_quant(geq, c32), sync)
    print(f"[5 timing] K6 f32 instance {GEQ_B}x{GEQ_T} on {card}: kernel {k6_f32:.3f} ms = "
          f"{n_geq / (k6_f32 * 1e-3):.4g} samples/s (f64 {times['K6']['ms']:.3f} ms)")
    print(f"[5 timing] K9 resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, "
          f"{P.K9.THREADS} threads a block): {P.K9.occupancy(dev)}")
    print(f"[5 timing] bnlms gates {AEC_B}x{AEC_T} (float64 FFT, torch.fft, m = {P.K9.GATE_M}) "
          f"on {card}: {gate_ms:.3f} ms; {n_open} of {gates.numel()} open; previously (float64 "
          f"matmul DFT) about 33 ms")
    # the ops a user calls, state dicts in and out (through the host), as one call each
    G, N = P.G, P.N
    gz = {"xh": torch.zeros(GEQ_B, 2, dtype=torch.int32),
          "yh": torch.zeros(GEQ_B, 7, 2, dtype=torch.int32)}
    nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.nlms_init_state().items()}
    bz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.bnlms_init_state().items()}
    xb, rb = x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024)
    op_runs = {  # op, its shape, and the time of its device work alone (above)
        "geq_apply f64": (lambda: G.geq_apply(geq, b, a, gz, dtype=torch.float64),
                          (GEQ_B, GEQ_T), times["K6"]["ms"]),
        "geq_apply f32": (lambda: G.geq_apply(geq, b, a, gz), (GEQ_B, GEQ_T), k6_f32),
        "nlms_apply": (lambda: N.nlms_apply(x, r, nz), (AEC_B, AEC_T), times["K8"]["ms"]),
        "bnlms_apply": (lambda: N.bnlms_apply(xb, rb, bz), (AEC_B, AEC_T),
                        times["K9"]["ms"] + gate_ms)}
    for op, (fn, (B, T), alone) in op_runs.items():
        ms = median_ms(fn, sync)
        before = f"; previously {PREVIOUS_OP_MS[op]:.3f} ms" if op in PREVIOUS_OP_MS else ""
        print(f"[5 timing] op {op} {B}x{T} on {card}: {ms:.3f} ms = {B * T / (ms * 1e-3):.4g} "
              f"samples/s; its kernels (and gates) alone {alone:.3f} ms, the rest "
              f"{ms - alone:.3f} ms{before}")
    return times


# ---- speech features: MFCC (K10) with GMM classification, AMDF pitch (K11) ---

MFCC_T = 8192     # blocks of 1024 per call: 16,384 frames, 8.39 M samples (bench/all_configs.py:612)
PITCH_T = 16384   # frames of 1024 at hop 512: 8.39 M samples (bench/all_configs.py:681)
CLASSES = 25      # the class models gmm_train trains (jeicyboodsp_tpu/pipelines/registry.py:159)
TRAIN_BLOCKS, UTT_BLOCKS = 64, 32  # blocks of 1024 behind a class model / in an utterance
MFCC_FULL_DB = 85.0   # mfcc_blocks(mxu3) at full size vs the f64 reference: the TPU kernel's level
MFCC_PIPE_DB = ENGINE_FIDELITY["mfcc", "mxu3"]["floor"]  # the mfcc pipeline vs the reference
SCORE_RTOL = 1e-4     # speech_classify's scores (f32 features) vs the f64 reference's
PITCH_SAMPLED = 256   # full-size frames held against the reference
AMDF_LO = 96          # K11's first lag on the pitch path


def speech_signal(n, rng, silent=None):
    """Speech-like int16 at 16 kHz: f0 gliding over 80-150 Hz with a third
    harmonic over N(0, 300); the sample range ``silent`` (start, stop) set
    to digital silence."""
    t = np.arange(n) / FS
    phase = 2 * np.pi * np.cumsum(115.0 + 35.0 * np.sin(2 * np.pi * 0.7 * t)) / FS
    x = 8000 * np.sin(phase) + 2000 * np.sin(3 * phase) + rng.normal(0, 300, n)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    if silent:
        x[silent[0]:silent[1]] = 0
    return x


def class_signal(c, n, rng):
    """Class c of the classification probe: a tone at 150 Hz x 1.12^c with a
    3% vibrato and a second harmonic, amplitude-modulated, over N(0, 300)."""
    t = np.arange(n) / FS
    f0 = 150.0 * 1.12 ** c
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 1.3 * t))) / FS
    amp = 6000 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t + rng.uniform(0, 6)) ** 2)
    x = amp * (np.sin(phase) + 0.4 * np.sin(2 * phase)) + rng.normal(0, 300, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def class_models(feats):
    """Class models in the test layout from each class's float64 features:
    four contiguous quarters of the frames as the mixtures, each with its
    mean and covariance and their top-4 eigenpairs (numpy.linalg.eigh).
    Returns alphas (C, 4), means (C, 4, 12), covs (C, 4, 12, 12), eigvecs
    (C, 4, 12, 4)."""
    C = len(feats)
    alphas = np.full((C, 4), 0.25)
    means, covs, eigs = np.zeros((C, 4, 12)), np.zeros((C, 4, 12, 12)), np.zeros((C, 4, 12, 4))
    for c, f in enumerate(feats):
        q = len(f) // 4
        for k in range(4):
            seg = f[k * q:(k + 1) * q]
            vals, vecs = np.linalg.eigh(np.cov(seg.T, bias=True))
            top = np.argsort(-vals, kind="stable")[:4]
            means[c, k, :4] = seg.mean(0) @ vecs[:, top]
            covs[c, k, np.arange(4), np.arange(4)] = vals[top]
            eigs[c, k] = vecs[:, top]
    return alphas, means, covs, eigs



def feature_inputs(dev):
    """The full-size inputs, from SEED: MFCC_T blocks of speech with 8192
    samples of digital silence (14 whole frames, NaN features), as the
    signal and its zero-prefixed (2T + 1, 512) row view whose rows[:-1],
    rows[1:] are K10's frame halves; PITCH_T frames [previous block, block]
    of speech with a silent stretch (every lag ties: lag 101)."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    x = speech_signal(MFCC_T * 1024, rng, silent=(300_000, 308_192))
    flat = torch.from_numpy(np.concatenate([np.zeros(512, np.int16), x])).to(dev)
    blocks = speech_signal(PITCH_T * 512, rng, silent=(1_000_000, 1_010_000)).reshape(-1, 512)
    prev = np.concatenate([np.zeros((1, 512), np.int16), blocks[:-1]])
    frames = torch.from_numpy(np.concatenate([prev, blocks], 1)).to(dev)
    return x, flat.reshape(-1, 512), frames


def _finite_db(got, want, what, floor):
    """SNR over the finite features; fails below ``floor`` or unless the NaN
    and infinity masks (with signs) agree.  Returns the dB and the max
    |diff| over the finite features."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(w)
    same = (g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
            and np.array_equal(np.isinf(g), np.isinf(w)) and np.array_equal(g[~fin & ~np.isnan(w)],
                                                                             w[~fin & ~np.isnan(w)]))
    err = g[fin] - w[fin] if same else np.array([np.inf])
    db = 10 * np.log10(np.sum(w[fin] ** 2) / max(np.sum(err ** 2), 1e-300))
    print(f"{what}: {db:.2f} dB over {int(fin.sum())} finite values, NaN {int(np.isnan(w).sum())}, "
          f"masks equal {same}, max |diff| {np.abs(err).max():.3e}")
    if not (same and db >= floor):
        raise RuntimeError(f"{what}: {db:.2f} dB (floor {floor}), masks equal {same}")
    return db, float(np.abs(err).max())


def check_features(P, feat, sync):
    """Phase 3 for K10 and K11: each against its plain version at full size.
    Returns the max |kernel - plain| of each."""
    import torch

    _, rows, frames = feat
    got, want = P.K10.mfcc_fused(rows[:-1], rows[1:]), P.K10.mfcc_fused_plain(rows[:-1], rows[1:])
    sync()
    _, err10 = _finite_db(got.cpu(), want.cpu(), f"[3 kernel-vs-plain] K10 N={len(got)}",
                          KERNEL_VS_PLAIN_DB)
    pairs = []
    for lo in (AMDF_LO, 0):
        pairs.append((P.K11.amdf(frames, lo), P.K11.amdf_plain(frames, lo)))
        sync()
    # random full-scale extremes: sums past 2^24, where an f32 sum would round
    rng = np.random.default_rng(SEED + 6)
    extremes = torch.from_numpy(np.where(rng.random((PITCH_T, 1024)) < 0.5, -32768, 32767)
                                .astype(np.int16)).to(frames.device)
    pairs.append((P.K11.amdf(extremes, AMDF_LO), P.K11.amdf_plain(extremes, AMDF_LO)))
    sync()
    if any(g.dtype != torch.float64 for g, _ in pairs):
        raise RuntimeError("K11 must return float64")
    err11 = _bit_equal("K11", f"T={PITCH_T} lo={AMDF_LO} and lo=0, and on random full-scale "
                       f"extremes at lo={AMDF_LO} (f64)", pairs)
    return {"K10": err10, "K11": err11}


def _write_probe(work, name, x):
    path = os.path.join(work, f"{name}.wav")
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(path)  # 44 header bytes, skipped
    return path


def _pitch_lines(text):
    """(lag, value, f0) arrays from the pitch pipeline's printed lines."""
    rows = [line.split() for line in text.splitlines() if line.startswith("Estimation arg")]
    return (np.array([int(r[2]) for r in rows], np.int64), np.array([float(r[5]) for r in rows]),
            np.array([float(r[7]) for r in rows]))


def drive_features(P, feat, dev, sync):
    """Phase 4 for the speech features, the K10 and K11 launch counters set
    to 0 just before and read just after: the pitch and mfcc pipelines and
    CLI on probe files, mfcc_blocks(mxu3) and pitch_frames(method=2, mxu)
    at full size, speech_classify(mxu3) of CLASSES utterances against
    CLASSES class models.  Returns the counts and the classification
    inputs."""
    import contextlib
    import io

    import torch

    counted = {"K10": P.K10.mfcc_fused, "K11": P.K11.amdf}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(SEED + 4)
    probe = speech_signal(40 * 512 + 300, rng, silent=(4096, 8192))  # partial last blocks
    cases = {"probe": probe, "empty": probe[:0]}
    paths = {c: _write_probe(work, f"feat_{c}", x) for c, x in cases.items()}
    mfcc_runs = {"f64 xla": (torch.float64, "xla"), "f32 xla": (torch.float32, "xla"),
                 "f32 mxu3": (torch.float32, "mxu3")}
    lists = {}
    for r in mfcc_runs:  # the probe first: its first frame is the run's, skipped
        tag = r.replace(" ", "_")
        lists[r] = os.path.join(work, f"mfcc_{tag}.list")
        with open(lists[r], "w") as f:
            f.writelines(f"{paths[c]} {os.path.join(work, f'{c}_{tag}.mfc')}\n" for c in cases)
    x, rows, frames = feat
    train = [class_signal(c, TRAIN_BLOCKS * 1024, rng) for c in range(CLASSES)]
    utts = [class_signal(c, UTT_BLOCKS * 1024, rng) for c in range(CLASSES)]
    model = class_models([reference_mfcc(t, skip_first=False) for t in train])
    tmodel = P.GM.model_to_port(*model, dev)
    ublocks = [torch.from_numpy(u.reshape(-1, 1024)).to(dev) for u in utts]

    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    printed = {}
    for c in cases:
        for m in (1, 2, 3):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                P.registry.pitch(paths[c], m, dtype=torch.float64, device=dev)
            printed[f"pitch{m} f64 xla", c] = out.getvalue()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            P.registry.pitch(paths[c], 2, dtype=torch.float64, fft_engine="mxu", device=dev)
        printed["pitch2 f64 mxu (K11)", c] = out.getvalue()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            P.cli.main(["pitch2", paths[c], "--fast", "--engine", "mxu", "--device", str(dev)])
        printed["cli pitch2 --fast --engine mxu (K11)", c] = out.getvalue()
    for r, (dtype, eng) in mfcc_runs.items():
        P.registry.mfcc(lists[r], dtype=dtype, fft_engine=eng, device=dev)
    mel_m, dct_m = P.F.mel_dct(torch.float32, dev)
    full_blocks = rows[1:].reshape(MFCC_T, 1024)
    feats_full = P.F.mfcc_blocks(full_blocks, mel_m, dct_m, dtype=torch.float32, fft_engine="mxu3")
    scores = [P.S.speech_classify(b, *tmodel, dtype=torch.float32, fft_engine="mxu3")
              for b in ublocks]
    lag64, val64, f064 = P.F.pitch_frames(frames, method=2, dtype=torch.float64, fft_engine="mxu")
    lag32, val32, _ = P.F.pitch_frames(frames, method=2, dtype=torch.float32, fft_engine="mxu")
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0

    for (run, c), text in printed.items():
        m = int(run.split("pitch")[1][0])
        want = reference_pitch(cases[c], m)
        got = _pitch_lines(text)
        ok = got[0].shape == want[0].shape and np.array_equal(got[0], want[0])
        if "--fast" not in run:  # f64: values and f0 too
            if m == 1:  # the FFTs' last bits differ between libraries
                ok = ok and np.allclose(got[1], want[1], rtol=1e-9, atol=0)
            else:  # exact integer sums and one IEEE division
                ok = ok and np.array_equal(got[1], want[1])
            ok = ok and np.array_equal(got[2], want[2])
        print(f"[4 main-path] {run} {c}: {len(got[0])} blocks, equal to the reference {ok}")
        if not ok:
            raise RuntimeError(f"{run} {c}: differs from the reference")
    for r in mfcc_runs:
        first = True
        for c, x_c in cases.items():
            got = np.fromfile(os.path.join(work, f"{c}_{r.replace(' ', '_')}.mfc"), "<f8")
            want = reference_mfcc(x_c, skip_first=first).reshape(-1)
            first = False
            if not len(want):
                if len(got):
                    raise RuntimeError(f"mfcc {r} {c}: {len(got)} values, want 0")
                continue
            _finite_db(got, want, f"[4 main-path] mfcc pipeline {r} {c}", MFCC_PIPE_DB)
    _finite_db(feats_full.cpu(), reference_mfcc(x, skip_first=False),
               f"[4 main-path] mfcc_blocks(mxu3) {MFCC_T}x1024 (K10)", MFCC_FULL_DB)
    worst, argmax_ok = 0.0, True
    for c, u in enumerate(utts):
        f = reference_mfcc(u, skip_first=False)
        want = np.array([reference_score(f, *(m[j] for m in model)) for j in range(CLASSES)])
        got = scores[c].cpu().numpy()
        worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
        argmax_ok &= int(np.argmax(got)) == int(np.argmax(want)) == c
    print(f"[4 main-path] speech_classify(mxu3, K10) {CLASSES} utterances x {CLASSES} classes: "
          f"every argmax the reference's and the class {argmax_ok}, largest relative score "
          f"difference {worst:.3e} (limit {SCORE_RTOL})")
    if not (argmax_ok and worst <= SCORE_RTOL):
        raise RuntimeError("speech_classify differs from the reference")
    idx = np.linspace(0, PITCH_T - 1, PITCH_SAMPLED).astype(np.int64)
    idx[1] = 1_000_000 // 512 + 2  # a frame inside the silent stretch
    wl, wv, wf = reference_pitch_frames(frames[torch.from_numpy(idx).to(dev)].cpu().numpy(), 2)
    gl, gv, gf = (v.cpu().numpy()[idx] for v in (lag64, val64, f064))
    ok64 = np.array_equal(gl, wl) and np.array_equal(gv, wv) and np.array_equal(gf, wf)
    l32, v32 = lag32.cpu().numpy()[idx], val32.cpu().numpy()[idx]
    ties = np.flatnonzero(l32 != wl)  # an f32 tie with a smaller lag is allowed
    ok32 = all(np.float32(wv[i]) == v32[i] for i in ties)
    print(f"[4 main-path] pitch_frames(method=2, mxu, K11) {PITCH_T} frames, {PITCH_SAMPLED} "
          f"sampled: f64 lags, values and f0 equal to the reference {ok64}; f32 lags differing "
          f"{len(ties)}, each an f32 tie {ok32}; the silent frame's lag {int(gl[1])}")
    if not (ok64 and ok32 and gl[1] == 101):
        raise RuntimeError("pitch_frames(method=2, mxu) differs from the reference")
    print(f"[4 main-path] features: launches {json.dumps(launches)} in {main_s:.1f} s")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the main path did not launch {missing}")
    return launches, (ublocks, tmodel)


def time_features(P, feat, classify, card, sync):
    """Phase 5 for K10 and K11: the ops at full size, each kernel alone, its
    plain version and (K10) one f32 torch.matmul of its GEMM core, with the
    bounds.  Returns the numbers per kernel."""
    import torch

    _, rows, frames = feat
    prev, cur = rows[:-1], rows[1:]
    N = prev.shape[0]
    mel_m, dct_m = P.F.mel_dct(torch.float32, frames.device)
    full_blocks = rows[1:].reshape(MFCC_T, 1024)
    frames_f32 = torch.cat([prev, cur], 1).float()
    cs = torch.cat([torch.from_numpy(a) for a in P.K10.mfcc_consts()[:2]], 1).to(frames.device)
    ops_ms = {
        "mfcc_blocks(mxu3)": median_ms(lambda: P.F.mfcc_blocks(
            full_blocks, mel_m, dct_m, dtype=torch.float32, fft_engine="mxu3"), sync),
        "pitch_frames(method=2, mxu, f32)": median_ms(lambda: P.F.pitch_frames(
            frames, method=2, dtype=torch.float32, fft_engine="mxu"), sync),
    }
    for op, ms in ops_ms.items():
        before = f"; previously {PREVIOUS_OP_MS[op]:.3f} ms" if op in PREVIOUS_OP_MS else ""
        print(f"[5 timing] {op} {MFCC_T * 1024 if 'mfcc' in op else PITCH_T * 512} samples on "
              f"{card}: {ms:.3f} ms = {(MFCC_T * 1024 if 'mfcc' in op else PITCH_T * 512) / (ms * 1e-3):.4g} samples/s{before}")
    ublocks, tmodel = classify
    per_utt = median_ms(lambda: [P.S.speech_classify(b, *tmodel, dtype=torch.float32,
                                                      fft_engine="mxu3") for b in ublocks],
                        sync) / len(ublocks)
    print(f"[5 timing] speech_classify(mxu3) of a {UTT_BLOCKS}-block utterance against "
          f"{CLASSES} classes on {card}: {per_utt:.3f} ms per utterance")
    wall, busy, kernels, host = profile_call(
        lambda: [P.S.speech_classify(b, *tmodel, dtype=torch.float32, fft_engine="mxu3")
                 for b in ublocks], sync)
    n = len(ublocks)
    top = lambda rows: ", ".join(f"{k[:60]} x{c / n:g} {ms / n:.4f}" for ms, c, k in rows)  # noqa: E731
    print(f"[5 profile] speech_classify under torch.profiler, ms per utterance: wall "
          f"{wall / n:.3f}, device busy {busy / n:.4f} (idle {100 * (1 - busy / wall):.1f}%); "
          f"kernels by device time: {top(kernels)}; host ops by self CPU time: {top(host)}")
    runs = {  # kernel, plain, its work (profiling.KERNELS), library call
        "K10": (lambda: P.K10.mfcc_fused(prev, cur), lambda: P.K10.mfcc_fused_plain(prev, cur),
                PROF.KERNELS["K10"](N), lambda: frames_f32 @ cs),
        "K11": (lambda: P.K11.amdf(frames, AMDF_LO), lambda: P.K11.amdf_plain(frames, AMDF_LO),
                PROF.KERNELS["K11"](PITCH_T, AMDF_LO), None),
    }
    times = {}
    for name, (kern, plain, work, lib) in runs.items():
        ms = median_ms(kern, sync)
        plain_ms = median_ms(plain, sync, reps=PLAIN_REPS)
        lib_ms = median_ms(lib, sync) if lib else None
        b_ms, b_by, b_text = bound_line(work)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        n_samples = MFCC_T * 1024 if name == "K10" else PITCH_T * 512
        before = f" (previously {PREVIOUS_MS[name]:.3f} ms)" if name in PREVIOUS_MS else ""
        print(f"[5 timing] {name} at full size on {card}: kernel {ms:.3f} ms{before} = "
              f"{n_samples / (ms * 1e-3):.4g} samples/s; plain {plain_ms:.3f} ms; "
              f"{'f32 matmul core %.3f ms' % lib_ms if lib_ms else 'library call: none'}; "
              f"{b_text}")
    win = torch.from_numpy(P.K4.rfft_constants()[P.K4.WINDOW:]).to(frames.device)
    pre = torch.cat([torch.zeros_like(frames_f32[:, :1]),
                     frames_f32[:, 1:] - P.F.PRE_EMPHASIS * frames_f32[:, :-1]], 1) * win
    times["K10"]["library_ms"] = fft_library_turns(
        "K10", runs["K10"][0], runs["K10"][3], lambda: torch.fft.rfft(pre), card, sync)
    return times



# ---- fast convolution and the FFT program (K12), the f32 back half (K13), the VAD (K14) ----

FC_T = 2048    # blocks of 1024 per fastconv call: 2041 segments of 8192 (bench/all_configs.py:332)
FFT_T = 16384  # blocks of 512 per FFT-program call (bench/all_configs.py:651)
# f32 fastconv engines against the f64 reference (tests/test_engine_matrix.py:134-163); the
# port's mxu3 is mxu's f32 kernel, so it keeps mxu's floor
FC_FLOORS = {"xla": 88.0, "gemm": 95.0, "gemm8": 70.0, "gemm8hq": 85.0, "mxu": 88.0,
             "mxu3": 88.0, "auto": 85.0}
FC_SPARSE_DB = 95.0    # fastconv_blocks_sparse in f32 (tests/test_engine_matrix.py:153-160)
FC_F64_FLIPPED = 3e-3  # f64 fastconv: one int16 step on under 0.3% (tests/test_fastconv.py:16-25)
FFT_FLOORS = {"radix2": 65.0, "xla": 68.0, "fourstep": 65.0}  # f32 roundtrip (:166-176)
FFT_F64_DB = 70.0      # f64 radix2: one step at most, >= 70 dB (tests/test_fft_awgn.py:12-24)
FUSED_DB = 85.0        # _enhance_fused against the reference: the mxu3 floor
FFT_RTOL = 1e-5        # K12 against its plain version: of max |X| (test_pallas_kernels.py:78-81)
ROW_RTOL = 1e-5        # K13 against its plain version: of each frame row's max


def transform_inputs():
    """The full-size signals, from SEED: FC_T blocks of 1024 and FFT_T blocks
    of 512 of the gated tone (the JAX benchmark's mixed_signal)."""
    rng = np.random.default_rng(SEED + 5)
    return make_signal(FC_T * 1024, rng), make_signal(FFT_T * 512, rng)


def _fft_pair(got, want, what):
    """K12 against its plain version within FFT_RTOL of max |X|; prints the
    entries past the tolerance and fails if there are any.  Returns max |err|."""
    import torch

    err = torch.sqrt((got[0] - want[0]) ** 2 + (got[1] - want[1]) ** 2)
    scale = float(torch.sqrt(want[0] ** 2 + want[1] ** 2).max())
    bad = (err > FFT_RTOL * scale).nonzero()[:5].tolist()
    worst = float(err.max())
    print(f"[3 kernel-vs-plain] K12 {what}: max |err| / max |X| {worst / scale:.2e}, entries past "
          f"{FFT_RTOL}: {int((err > FFT_RTOL * scale).sum())} {bad}")
    if bad:
        raise RuntimeError(f"K12 {what}: {worst / scale:.2e} of max |X| > {FFT_RTOL}")
    return worst


def _old_vad_chain(P, blocks, C, hq):
    """Engines mxu8f / mxu8t as they ran before K14: the VAD as torch ops."""
    rowpack = P.E._latch_rowpack(P.K2.vad_rows(blocks, P.E._vad_window(blocks.device)))
    return P.K1.enhance_full8(blocks, rowpack, C, "wiener", hq)


def check_transforms(P, xc, xf, blocks, C, back_ins, sync):
    """Phase 3 for K12-K14: K12 at (2041, 8192), forward on the fastconv
    segments and inverse on their filtered spectra, and at (16384, 512);
    K13 on K4's planes at T = 16384; K14 on the chain's signal and on rows at
    its thresholds, with both windows; engines mxu8f / mxu8t through K14
    against the same chain with the torch VAD.  Returns the max |kernel -
    plain| of each."""
    import torch

    K12, FC, dev = P.K12, P.FC, blocks.device
    err = {"K12": 0.0}
    segs = FC._segments(FC._warm(torch.from_numpy(xc.reshape(FC_T, 1024)).to(dev),
                                 torch.float32), FC_T)
    Hr, Hi = (torch.from_numpy(a).to(dev) for a in FC.filter_spectrum(dtype=torch.float32))
    fb = torch.from_numpy(xf.reshape(FFT_T, 512)).to(dev).float()
    for n, x, filt in ((8192, segs, (Hr, Hi)), (512, fb, None)):
        X = K12.fft_pallas(x, None, n, True)
        err["K12"] = max(err["K12"], _fft_pair(X, K12.fft_four_step(x, None, n, True),
                                               f"({len(x)}, {n}) forward, real input"))
        if filt:  # the inverse of the mxu engine: the filtered spectrum
            X = (X[0] * filt[0] - X[1] * filt[1], X[0] * filt[1] + X[1] * filt[0])
        Y = K12.fft_pallas(*X, n, False)
        err["K12"] = max(err["K12"], _fft_pair(Y, K12.fft_four_step(*X, n, False),
                                               f"({len(x)}, {n}) inverse, complex input"))
    err["K13"] = 0.0
    for mode in MODES:
        got = P.K13.enhance_back(*back_ins["K4"], C, mode)
        want = P.K13.enhance_back_plain(*back_ins["K4"], C, mode)
        sync()
        rowmax = torch.cat(want, 1).nan_to_num(0.0).abs().amax(1, keepdim=True)
        nan_ok = all(torch.equal(g.isnan(), w.isnan()) for g, w in zip(got, want))
        diffs = [(g - w).nan_to_num(0.0).abs() for g, w in zip(got, want)]
        rel = max(float((d / rowmax.clamp_min(1e-30)).max()) for d in diffs)
        err["K13"] = max(err["K13"], max(float(d.max()) for d in diffs))
        bad = [(name, (d > ROW_RTOL * rowmax).nonzero()[:3].tolist())
               for name, d in zip(("head", "w2", "y512"), diffs)]
        print(f"[3 kernel-vs-plain] K13 {mode} T={T_FULL}: max err / frame row max {rel:.2e}, "
              f"NaN masks equal {nan_ok}, entries past {ROW_RTOL}: {bad}")
        if not (nan_ok and rel <= ROW_RTOL):
            raise RuntimeError(f"K13 {mode}: {rel:.2e} of the row max > {ROW_RTOL} or NaN masks differ")
    for what, w2 in (("f32 window", P.E._vad_window(dev)), ("f64-built w2", C["w2"])):
        rows = torch.cat([blocks, torch.from_numpy(vad_threshold_rows(w2.cpu().numpy())).to(dev)])
        got, want = P.K14.vad_flags(rows, w2), P.K2.vad_rows(rows, w2)
        odd = _odd_offset_copy(rows)  # K14's 2-byte-load variant
        odd_same = torch.equal(P.K14.vad_flags(odd, w2), got)
        sync()
        diff = (got != want).nonzero()[:, 0].tolist()
        edge = got[-6:].tolist() == [False, False, True, True, False, False]
        print(f"[3 kernel-vs-plain] K14 {what} T={T_FULL} + 6 threshold rows: bit-equal "
              f"{not diff}, differing rows {diff[:10]}, threshold flags right {edge}, "
              f"the same at an odd offset {odd_same}; {int(got[:T_FULL].sum())} speech rows")
        if diff or not edge or not odd_same:
            raise RuntimeError(f"K14 {what}: {len(diff)} flags differ, threshold flags right "
                               f"{edge}, the same at an odd offset {odd_same}")
    err["K14"] = 0
    odd = _odd_offset_copy(blocks)
    for eng, hq in K1_ENGINES.items():
        new = P.E.enhance_blocks(blocks, "wiener", fft_engine=eng, resynth="ratio")[0]
        same = torch.equal(new, _old_vad_chain(P, blocks, C, hq))
        odd_same = torch.equal(
            P.E.enhance_blocks(odd, "wiener", fft_engine=eng, resynth="ratio")[0], new)
        print(f"[3 kernel-vs-plain] {eng} through K14 T={T_FULL}: int16 output equal to the "
              f"torch-VAD chain's {same}, the same from blocks at an odd offset {odd_same}")
        if not (same and odd_same):
            raise RuntimeError(f"{eng}: K14 changed the chain's output, or the output differs "
                               "from blocks at an odd offset")
    return err


def _odd_offset_copy(x):
    """A contiguous copy of the int16 tensor x one sample past a 16-byte
    boundary, as a view into a larger buffer can lie."""
    import torch

    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    out.copy_(x)
    return out


def _write_wav(work, name, x):
    path = os.path.join(work, f"{name}.wav")
    np.concatenate([np.arange(22, dtype=np.int16), x]).tofile(path)  # 44 header bytes, skipped
    return path


def _fc_verdict(got, want, what, floor=None):
    """One fastconv result against the f64 reference: f64 (floor None)
    within one step on under FC_F64_FLIPPED of the samples, f32 at its
    floor.  Returns the dB."""
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    if got.shape != want.shape:
        raise RuntimeError(f"{what}: {got.shape} samples, want {want.shape}")
    if not len(want):
        return None
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    snr = snr_db(want, got)
    ok = (d.max() <= 1 and (d > 0).mean() < FC_F64_FLIPPED) if floor is None else snr >= floor
    print(f"[4 main-path] {what}: {len(got)} samples, {snr:.2f} dB vs the f64 reference, "
          f"max |diff| {d.max()}, flipped {(d > 0).mean():.2e} "
          f"({'one step, < %g' % FC_F64_FLIPPED if floor is None else 'floor %g' % floor})")
    if not ok:
        raise RuntimeError(f"{what}: outside its contract")
    return snr


def drive_transforms(P, xc, xf, x_enh, blocks, dev, sync):
    """Phase 4 for fastconv, the FFT program and _enhance_fused, the K12 and
    K13 launch counters set to 0 just before and read just after: the
    ``fastconv`` pipeline per engine and the ``fft`` pipeline on probe files
    (a partial last block, an empty payload, fastconv with T <= 7), every
    fastconv engine at FC_T blocks, ``roundtrip_blocks`` at FFT_T blocks and
    ``_enhance_fused`` at T_FULL, each against its f64 reference.  Returns
    the counts."""
    import contextlib
    import io

    import torch

    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    FC, FT = P.FC, P.FT
    counted = {"K12": P.K12.fft_pallas, "K13": P.K13.enhance_back}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    probe = make_signal(40 * 1024 + 300, np.random.default_rng(SEED + 6))
    fc_cases = {"probe": probe, "short": probe[: 5 * 1024 + 7], "empty": probe[:0]}
    fft_cases = {"probe": probe[: 30 * 512 + 77], "empty": probe[:0]}
    paths = {("fc", c): _write_wav(work, f"fc_{c}", x) for c, x in fc_cases.items()}
    paths.update({("fft", c): _write_wav(work, f"fft_{c}", x) for c, x in fft_cases.items()})
    fc_runs = {"f64 xla": (torch.float64, "xla", None),
               **{f"f32 {e}": (torch.float32, e, FC_FLOORS[e]) for e in FC_FLOORS}}
    refs = {("fc", c): reference_fastconv(x) for c, x in fc_cases.items()}
    refs.update({("fft", c): reference_fft_roundtrip(x) for c, x in fft_cases.items()})
    ref_fc, ref_fft = reference_fastconv(xc), reference_fft_roundtrip(xf)
    ref_enh = reference_enhance(x_enh, "wiener")
    cb = torch.from_numpy(xc.reshape(FC_T, 1024)).to(dev)
    fb = torch.from_numpy(xf.reshape(FFT_T, 512)).to(dev)

    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out, printed = {}, {}
    for c in fc_cases:
        for run, (dtype, eng, _) in fc_runs.items():
            path = os.path.join(work, f"fc_{c}_{run.replace(' ', '_')}.pcm")
            P.registry.fastconv(paths["fc", c], path, dtype=dtype, fft_engine=eng, device=dev)
            out["fc", c, run] = np.fromfile(path, "<i2")
    for c in fft_cases:
        path = os.path.join(work, f"fft_{c}.pcm")
        with contextlib.redirect_stdout(io.StringIO()) as text:
            P.registry.fft_roundtrip(paths["fft", c], path, verbose=True, device=dev)
        out["fft", c], printed[c] = np.fromfile(path, "<i2"), text.getvalue()
    full = {run: FC.run_stream(xc, dtype=dtype, fft_engine=eng, device=dev)
            for run, (dtype, eng, _) in fc_runs.items()}
    sparse = FC.fastconv_blocks_sparse(cb, torch.float32).reshape(-1).cpu().numpy()
    rts = {f"f32 {e}": FT.roundtrip_blocks(fb, torch.float32, e).reshape(-1).cpu().numpy()
           for e in FFT_FLOORS}
    rts["f64 radix2"] = FT.run_stream(xf, device=dev)
    fused, mask = P.E._enhance_fused(blocks, "wiener", False)
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0

    for (kind, c, run), got in [(k, v) for k, v in out.items() if k[0] == "fc"]:
        _fc_verdict(got, refs["fc", c], f"fastconv pipeline {run} {c}", fc_runs[run][2])
    for run, got in full.items():
        _fc_verdict(got, ref_fc, f"fastconv.run_stream {run} {FC_T} blocks", fc_runs[run][2])
    _fc_verdict(sparse, ref_fc, f"fastconv_blocks_sparse f32 {FC_T} blocks", FC_SPARSE_DB)
    for c in fft_cases:
        got, want = out["fft", c], refs["fft", c]
        lines = printed[c].count("512-point FFT Calculation add 2304 multiply 2048")
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        ok = (got.shape == want.shape and d.max(initial=0) <= 1 and lines == 2 * len(want) // 512
              and printed[c].endswith("Break! The buffer is insufficient.\nProcessing End\n"))
        print(f"[4 main-path] fft pipeline f64 radix2 --verbose {c}: {len(got)} samples, max |diff| "
              f"{d.max(initial=0)}, flipped {int((d > 0).sum())}, {lines} op-count lines, as the "
              f"reference {ok}")
        if not ok:
            raise RuntimeError(f"fft pipeline {c}: differs from the reference")
    for run, got in rts.items():
        snr = snr_db(ref_fft, got)
        d = np.abs(got.astype(np.int64) - ref_fft.astype(np.int64))
        floor = FFT_F64_DB if run.startswith("f64") else FFT_FLOORS[run.split()[1]]
        ok = snr >= floor and (d.max() <= 1 or not run.startswith("f64"))
        print(f"[4 main-path] roundtrip_blocks {run} {FFT_T} blocks: {snr:.2f} dB vs the f64 "
              f"reference (floor {floor}), max |diff| {d.max()}, flipped {(d > 0).mean():.2e}")
        if not ok:
            raise RuntimeError(f"roundtrip_blocks {run}: {snr:.2f} dB, max |diff| {d.max()}")
    got = fused[mask].reshape(-1).cpu().numpy()
    snr = snr_db(ref_enh, got) if got.shape == ref_enh.shape else -np.inf
    print(f"[4 main-path] _enhance_fused wiener T={T_FULL}: {snr:.2f} dB vs the f64 reference "
          f"(floor {FUSED_DB})")
    if not snr >= FUSED_DB:
        raise RuntimeError(f"_enhance_fused: {snr:.2f} dB < {FUSED_DB}")
    print(f"[4 main-path] fastconv, fft, _enhance_fused: launches {json.dumps(launches)} in "
          f"{main_s:.1f} s")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the main path did not launch {missing}")
    return launches


def time_transforms(P, xc, xf, blocks, C, back_ins, card, sync):
    """Phase 5 for fastconv, the FFT program, _enhance_fused, engines mxu8f /
    mxu8t before and after K14, and K12-K14 alone with their plain
    versions, one PyTorch call of the same function where there is one, and
    their bounds.  Returns the numbers per kernel."""
    import torch

    FC, FT, K12, dev = P.FC, P.FT, P.K12, blocks.device
    cb = torch.from_numpy(xc.reshape(FC_T, 1024)).to(dev)
    fb = torch.from_numpy(xf.reshape(FFT_T, 512)).to(dev)
    spec = {(d, r): FC.filter_spectrum(dtype=d, real_fft=r)
            for d in (torch.float32, torch.float64) for r in (False, True)}
    fc_ops = {
        "xla f64": lambda: FC.fastconv_blocks(cb, *spec[torch.float64, False]),
        "xla f32 rfft": lambda: FC.fastconv_blocks(cb, *spec[torch.float32, True],
                                                   dtype=torch.float32, real_fft=True),
        "gemm": lambda: FC.fastconv_blocks_gemm(cb),
        "gemm8": lambda: FC.fastconv_blocks_gemm_int8(cb, terms=2),
        "gemm8hq (auto)": lambda: FC.fastconv_blocks_gemm_int8(cb, terms=3),
        "mxu / mxu3 (K12)": lambda: FC.fastconv_blocks_mxu(cb, *spec[torch.float32, False]),
        "sparse f32": lambda: FC.fastconv_blocks_sparse(cb),
    }
    for name, fn in fc_ops.items():
        ms = median_ms(fn, sync)
        print(f"[5 timing] fastconv {name} {FC_T} blocks on {card}: {ms:.3f} ms = "
              f"{FC_T * 1024 / (ms * 1e-3):.4g} samples/s")
    for dtype, eng in ((torch.float32, "xla"), (torch.float32, "fourstep"),
                       (torch.float32, "radix2"), (torch.float64, "radix2")):
        ms = median_ms(lambda: FT.roundtrip_blocks(fb, dtype, eng), sync)
        print(f"[5 timing] roundtrip_blocks {str(dtype)[6:]} {eng} {FFT_T} blocks on {card}: "
              f"{ms:.3f} ms = {FFT_T * 512 / (ms * 1e-3):.4g} samples/s")
    ms = median_ms(lambda: P.E._enhance_fused(blocks, "wiener", False), sync)
    print(f"[5 timing] _enhance_fused wiener T={T_FULL} on {card}: {ms:.3f} ms = "
          f"{T_FULL * 512 / (ms * 1e-3):.4g} samples/s")
    for name, fn in (("fastconv gemm8hq", fc_ops["gemm8hq (auto)"]),
                     ("fastconv mxu (K12)", fc_ops["mxu / mxu3 (K12)"]),
                     ("roundtrip_blocks f32 xla", lambda: FT.roundtrip_blocks(fb, torch.float32, "xla")),
                     ("roundtrip_blocks f32 fourstep (K12)",
                      lambda: FT.roundtrip_blocks(fb, torch.float32, "fourstep")),
                     ("_enhance_fused", lambda: P.E._enhance_fused(blocks, "wiener", False))):
        wall, busy, kernels, _ = profile_call(fn, sync, top=6)
        top = ", ".join(f"{k[:50]} x{c} {ms:.4f}" for ms, c, k in kernels)
        print(f"[5 profile] {name} under torch.profiler on {card}: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms (idle {100 * (1 - busy / wall):.1f}%); kernels by device time "
              f"(ms): {top}")
    for eng, hq in K1_ENGINES.items():  # in turns: torch VAD, K14, K14, torch VAD
        old = lambda: _old_vad_chain(P, blocks, C, hq)  # noqa: E731
        new = lambda: P.E.enhance_blocks(  # noqa: E731
            blocks, "wiener", fft_engine=eng, resynth="ratio")
        t = [median_ms(f, sync) for f in (old, new, new, old)]
        print(f"[5 timing] {eng} enhance_blocks T={T_FULL} on {card}: torch VAD {t[0]:.3f} / "
              f"{t[3]:.3f} ms, K14 {t[1]:.3f} / {t[2]:.3f} ms")

    # the kernels alone: K12 as the mxu engine's inverse (2 planes in, 2 out)
    segs = FC._segments(FC._warm(cb, torch.float32), FC_T)
    Hr, Hi = (torch.from_numpy(a).to(dev) for a in spec[torch.float32, False])
    Xr, Xi = K12.fft_pallas(segs, None, FC.FFT_SIZE, True)
    Yr, Yi = Xr * Hr - Xi * Hi, Xr * Hi + Xi * Hr
    Z = torch.complex(Yr, Yi)
    nseg = len(segs)
    fwd_ms = median_ms(lambda: K12.fft_pallas(segs, None, FC.FFT_SIZE, True), sync)
    ins13 = back_ins["K4"]
    w = P.E._vad_window(dev)
    runs = {  # kernel, plain version, its work (profiling.KERNELS), library call
        "K12": (lambda: K12.fft_pallas(Yr, Yi, FC.FFT_SIZE, False),
                lambda: K12.fft_four_step(Yr, Yi, FC.FFT_SIZE, False),
                PROF.KERNELS["K12"](nseg, FC.FFT_SIZE), lambda: torch.fft.fft(Z)),
        "K13": (lambda: P.K13.enhance_back(*ins13, C, "wiener"),
                lambda: P.K13.enhance_back_plain(*ins13, C, "wiener"),
                PROF.KERNELS["K13"](T_FULL), gemm_cores(P, blocks, C, back_ins)["K5"]),
        "K14": (lambda: P.K14.vad_flags(blocks, w), lambda: P.K2.vad_rows(blocks, w),
                PROF.KERNELS["K14"](T_FULL), None),
    }
    times = {}
    for name, (kern, plain, work, lib) in runs.items():
        ms, plain_ms = median_ms(kern, sync), median_ms(plain, sync)
        lib_ms = median_ms(lib, sync) if lib else None
        b_ms, b_by, b_text = bound_line(work)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        print(f"[5 timing] {name} alone on {card}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {'-' if lib_ms is None else '%.3f ms' % lib_ms}, {b_text}")
    core = gemm_cores(P, blocks, C, back_ins)["K5"]
    for mode in MODES:  # K5 and K13 beside their f32 matmul core, in turns, both gains
        t = [median_ms(f, sync) for f in (
            lambda: P.K5.enhance_back_ola3(*ins13, C, mode), lambda: P.K13.enhance_back(*ins13, C, mode),
            core, lambda: P.K13.enhance_back(*ins13, C, mode),
            lambda: P.K5.enhance_back_ola3(*ins13, C, mode))]
        k5, k13 = (t[0] + t[4]) / 2, (t[1] + t[3]) / 2
        print(f"[5 timing] K5 / K13 {mode} T={T_FULL} on {card}: K5 {t[0]:.4f} / {t[4]:.4f} ms, "
              f"K13 {t[1]:.4f} / {t[3]:.4f} ms, f32 matmul core {t[2]:.4f} ms; faster than the "
              f"core: K5 {k5 < t[2]}, K13 {k13 < t[2]}")
    calls = 50  # back to back: one call under the profiler would time the profiler's start
    wall, busy, kernels, _ = profile_call(lambda: [runs["K14"][0]() for _ in range(calls)], sync,
                                          top=1)
    print(f"[5 profile] K14 alone under torch.profiler on {card}, {calls} calls: wall "
          f"{wall / calls:.4f} ms a call, device busy {busy / calls:.4f} ms a call; host share "
          f"{1 - busy / wall:.1%} (the wrapper's checks, the allocation and the ctypes launch); "
          f"a call in batches {times['K14']['ms']:.4f} ms (previously {PREVIOUS_MS['K14']:.3f})")
    print(f"[5 timing] K12 ({nseg}, {FC.FFT_SIZE}): the inverse above; the forward on real input "
          f"{fwd_ms:.3f} ms ({bound_line(PROF.KERNELS['K12'](nseg, FC.FFT_SIZE, True))[2]}); "
          f"library = torch.fft.fft on complex64")
    # K12 at the FFT program's shape, (16384, 512): forward on real blocks, inverse on their spectra
    fbf = fb.float()
    Fr, Fi = K12.fft_pallas(fbf, None, 512, True)
    Fz = torch.complex(Fr, Fi)
    for what, kern, plain, real, lib in (
            ("forward, real input", lambda: K12.fft_pallas(fbf, None, 512, True),
             lambda: K12.fft_four_step(fbf, None, 512, True), True,
             lambda: torch.fft.fft(fbf)),
            ("inverse, complex input", lambda: K12.fft_pallas(Fr, Fi, 512, False),
             lambda: K12.fft_four_step(Fr, Fi, 512, False), False,
             lambda: torch.fft.ifft(Fz))):
        t = [median_ms(f, sync) for f in (kern, plain, lib)]
        print(f"[5 timing] K12 ({FFT_T}, 512) {what} on {card}: kernel {t[0]:.4f} ms, plain "
              f"{t[1]:.3f} ms, torch.fft {t[2]:.4f} ms, "
              f"{bound_line(PROF.KERNELS['K12'](FFT_T, 512, real))[2]}")
    return times


# ---- streaming with checkpoints and MVDR ---------------------------------------

STREAM_CHUNK = 4          # blocks per chunk: JAX's default (stream --chunk-blocks)
STREAM_CHUNK_TIMED = (4, 64)
STREAM_RAGGED = (1, 3, 5, 7, 4, 11)  # chunk sizes in turn
STREAM_CLI_CHUNK, STREAM_CLI_EVERY, STREAM_CLI_CRASH = 64, 8, 50
MVDR_FLIPS = 0.01         # f64 against the reference: one step, on under 1% (tests/test_mvdr.py)
MVDR_F32_DB, MVDR_COLLAPSE_DB = 60.0, 90.0


def make_stereo(n, rng):
    """Two mics: the gated 400 Hz tone of tests/test_mvdr.py (0.8x on the
    right) switching on and off as make_signal's, over N(0, 15) on each."""
    t = np.arange(n) / FS
    speech = 6000 * np.sin(2 * np.pi * 400 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    xl = np.clip(speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    xr = np.clip(0.8 * speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    return xl, xr


def _session_run(sess, blocks, sizes):
    """Feed blocks to an EnhanceSession in chunks cycling through sizes."""
    outs, s, i = [], 0, 0
    while s < len(blocks):
        k = sizes[i % len(sizes)]
        outs.append(sess.process(blocks[s: s + k]))
        s, i = s + k, i + 1
    return np.concatenate(outs)


def _resumed(make, blocks, chunk, work, tag):
    """Chunks of ``chunk`` blocks through one session with a checkpoint at the
    middle block, and the second half again through a fresh session restored
    from it; returns (whole output, the restored session's second half, the
    first session's second half)."""
    half = len(blocks) // 2 // chunk * chunk
    sess = make()
    a = _session_run(sess, blocks[:half], [chunk])
    ck = os.path.join(work, f"stream_{tag}.npz")
    sess.checkpoint(ck)
    b = _session_run(sess, blocks[half:], [chunk])
    fresh = make()
    fresh.restore(ck)
    if fresh.sample_offset != half * 512:
        raise RuntimeError(f"stream {tag}: restored offset {fresh.sample_offset} != {half * 512}")
    return np.concatenate([a, b]), _session_run(fresh, blocks[half:], [chunk]), b


def _flip_count(got, want, what, share, tag="[4 stream]"):
    """int16 outputs at most one step apart on under ``share`` of the
    samples; prints the count and raises otherwise."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64)) if got.shape == want.shape else None
    flipped = int((d > 0).sum()) if d is not None else -1
    worst = int(d.max(initial=0)) if d is not None else -1
    print(f"{tag} {what}: {len(got)} samples, {flipped} differ, max |diff| {worst}")
    if d is None or worst > 1 or flipped >= share * max(len(want), 1):
        raise RuntimeError(f"{what}: {flipped} samples differ (max |diff| {worst}), shapes "
                           f"{got.shape} / {want.shape}")
    return flipped


def _cli_stream(dev, *args):
    """The port's ``stream`` command in a subprocess on the card; its exit code."""
    cmd = [sys.executable, "-m", "jeicyboodsp_tpu_torch.cli", "stream", *args, "--device", str(dev)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode not in (0, 137):
        print(res.stderr[-2000:], file=sys.stderr)
    return res.returncode


def _same(what, got, want):
    same = got.shape == want.shape and np.array_equal(got, want)
    differ = int((got != want).sum()) if got.shape == want.shape else -1
    print(f"[4 stream] {what}: bit-equal {same} ({differ} samples differ)")
    if not same:
        raise RuntimeError(f"{what}: not bit-equal ({differ} samples differ)")


def _vad_chunks_vs_plain(P, dev, blocks, sync):
    """K14 at the row counts a stream gives it: for each chunk size of the
    stream phase, the whole stream (``blocks``, (T, 512) int16 on the host)
    cut into chunks of that many rows, each chunk's flags from the wrapper
    bit-equal to K2.vad_rows on the same rows (the f32 window the stream's
    VAD reads).  Made after the stream phase's counts are read, so these
    launches are not counted."""
    import torch

    w = P.E._vad_window(dev)
    blocks = torch.from_numpy(blocks).to(dev)
    for n in sorted({STREAM_CHUNK, *STREAM_RAGGED}):
        cuts = range(0, blocks.shape[0], n)
        got = torch.cat([P.K14.vad_flags(blocks[s: s + n], w) for s in cuts])
        want = torch.cat([P.K2.vad_rows(blocks[s: s + n], w) for s in cuts])
        sync()
        diff = (got != want).nonzero()[:, 0].tolist()
        print(f"[4 stream] K14 in chunks of {n} rows ({len(cuts)} launches) vs vad_rows on the "
              f"same rows: bit-equal {not diff}, differing rows {diff[:10]}; "
              f"{int(got.sum())} speech rows")
        if diff:
            raise RuntimeError(f"K14 in chunks of {n} rows: {len(diff)} flags differ from "
                               f"vad_rows")


K15_CHUNKS = (2, 64)  # the live cell's chunk, and the stream CLI's --chunk-blocks here
K15_CHECK_T = 2048    # blocks of the signal K15 and its plain version run in phase 3
K15_STATE_RTOL = 1e-12


def _n_chunks(n, sizes):
    """How many chunks _session_run cuts n blocks into."""
    count, s = 0, 0
    while s < n:
        s += sizes[count % len(sizes)]
        count += 1
    return count


def check_k15(P, x_full, sync):
    """Phase 3 for K15: the kernel and its plain version (the torch-op chain
    on the card) over the first K15_CHECK_T blocks of the signal, in chunks
    of each of K15_CHUNKS, wiener and specsub, each carrying its own state:
    written samples within one step (the differing count printed), the mask
    and the integer leaves equal, the float leaves within K15_STATE_RTOL of
    their largest value with equal NaN masks.  Returns the largest |diff|."""
    import torch

    E, dev = P.E, torch.device("cuda")
    blocks = torch.from_numpy(x_full[: K15_CHECK_T * 512].reshape(-1, 512)).to(dev)
    worst = 0
    for mode in MODES:
        for Tc in K15_CHUNKS:
            ks = E.stream_init_state(torch.float64, dev)
            ps = E.stream_init_state(torch.float64, dev)
            flipped, state_err, ok = 0, 0.0, True
            for s in range(0, K15_CHECK_T, Tc):
                ko, km, ks = P.K15.enhance_chunk64(ks, blocks[s: s + Tc], mode)
                po, pm, ps = E.enhance_chunk_ops(ps, blocks[s: s + Tc], mode)
                d = (ko.long() - po.long()).abs()
                flipped += int((d > 0).sum())
                worst = max(worst, int(d.max()))
                ok &= torch.equal(km, pm) and all(torch.equal(ks[k], ps[k])
                                                  for k in ("cnt", "t", "prev_block"))
                for k in ("avg", "latched", "prev_tail"):
                    g, w = ks[k], ps[k]
                    ok &= torch.equal(g.isnan(), w.isnan())
                    scale = max(float(w.nan_to_num(0.0).abs().max()), 1.0)
                    state_err = max(state_err, float((g - w).nan_to_num(0.0).abs().max()) / scale)
            sync()
            print(f"[3 kernel-vs-plain] K15 {mode} chunks of {Tc} over {K15_CHECK_T} blocks: "
                  f"{flipped} written samples differ (max |diff| {worst}), mask and integer "
                  f"state equal {ok}, float state within {state_err:.2e} of its largest")
            if not ok or worst > 1 or state_err > K15_STATE_RTOL:
                raise RuntimeError(f"K15 {mode} chunks of {Tc}: max |diff| {worst}, state "
                                   f"{state_err:.2e}, exact parts equal {ok}")
    return worst


def time_k15(P, x_full, card, sync):
    """Phase 5 for K15, wiener, at each of K15_CHUNKS from a state carried
    over the signal's first 64 blocks (its noise estimate latched): ms a
    call back to back (CUDA events) beside its plain version's, its device
    time a call under torch.profiler (50 calls), its bound and its chain's
    estimate at the card's clock.  Returns its numbers at the live cell's
    chunk."""
    import torch

    E, dev = P.E, torch.device("cuda")
    blocks = torch.from_numpy(x_full.reshape(-1, 512)).to(dev)
    state = E.stream_init_state(torch.float64, dev)
    _, _, state = E.enhance_chunk_ops(state, blocks[:64], "wiener")
    clock = card_clock_hz()
    out = {}
    for Tc in K15_CHUNKS:
        b = blocks[64: 64 + Tc]
        kern = lambda b=b: P.K15.enhance_chunk64(state, b, "wiener")  # noqa: E731
        plain = lambda b=b: E.enhance_chunk_ops(state, b, "wiener")  # noqa: E731
        ms, plain_ms = median_ms(kern, sync), median_ms(plain, sync)
        calls = 50
        before = P.K15.enhance_chunk64.launches
        wall, busy, kernels, _ = profile_call(lambda: [kern() for _ in range(calls)], sync, top=2)
        launched = P.K15.enhance_chunk64.launches - before
        work = PROF.KERNELS["K15"](Tc)
        b_ms, b_by, b_text = bound_line(work)
        chain = work.chain_ms(clock)
        dev_ms = busy / calls
        print(f"[5 timing] K15 wiener chunk {Tc} on {card}: {ms:.4f} ms a call back to back, "
              f"device {dev_ms:.4f} ms a call under torch.profiler ({launched} launches for "
              f"{2 * calls} calls: {[(round(t, 4), c, k[:40]) for t, c, k in kernels]}), plain "
              f"chain {plain_ms:.3f} ms; {b_text}; one SM's chain {chain:.4f} ms "
              f"({work.chain_cycles} cycles a row at {clock / 1e9:.2f} GHz)")
        if Tc == K15_CHUNKS[0]:
            out = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, chain_ms=chain, library_ms=None)
    return out


def drive_stream(P, dev, x_full, refs, geq, aec, sync):
    """Phase 4 for streaming with checkpoints, the K6, K8, K9, K14 and K15
    counters set to 0 just before and read just after (K15's equal to the
    f64 chunks served): EnhanceSession at T_FULL in
    f64 and f32 (chunks of 4 with a checkpoint at the middle restored into a
    fresh session, and ragged chunks), the CLI's kill-and-resume in
    subprocesses, GEQSession and both AECSessions over one stream each with
    a mid-stream checkpoint.  Then K14 against its plain version at each
    chunk size of the phase (:func:`_vad_chunks_vs_plain`).  Returns the
    counts."""
    import torch

    from jeicyboodsp_tpu_torch.io import stream as ST
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    counted = {"K6": P.K6.geq_cascade_quant, "K8": P.K8.nlms, "K9": P.K9.bnlms,
               "K14": P.K14.vad_flags, "K15": P.K15.enhance_chunk64}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    blocks = x_full.reshape(T_FULL, 512)
    b, a = P.G.geq_coefficients()
    gx = np.concatenate([geq[GEQ_B // 8, : 3 * GEQ_T // 4].cpu().numpy(),
                         geq[0, 3 * GEQ_T // 4:].cpu().numpy()])  # a tone, then wrap stress
    ax, ar = aec[0][0].cpu().numpy(), aec[1][0].cpu().numpy()  # an echo
    bx, br = aec[0][-1].cpu().numpy(), aec[1][-1].cpu().numpy()  # double talk
    want_geq = reference_geq(gx, b, a)
    want_nlms = reference_nlms_blocks(ax.reshape(-1, 1024), ar.reshape(-1, 1024))
    want_bnlms = reference_bnlms_blocks(bx.reshape(-1, 1024), br.reshape(-1, 1024))
    one_f64 = P.E.run_stream(x_full, "wiener", device=dev)
    one_f32 = P.E.run_stream(x_full, "wiener", dtype=torch.float32, device=dev)
    x_full.tofile(os.path.join(work, "stream_in.pcm"))
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    runs = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        def make(dtype=dtype):
            return ST.EnhanceSession("wiener", dtype=dtype, device=dev)

        t1 = time.perf_counter()
        runs[name, "resumed"] = _resumed(make, blocks, STREAM_CHUNK, work, name)
        runs[name, "ragged"] = _session_run(make(), blocks, STREAM_RAGGED)
        print(f"[4 stream] EnhanceSession wiener {name} at T={T_FULL}: chunks of {STREAM_CHUNK} "
              f"with a checkpoint, then ragged chunks {STREAM_RAGGED}, "
              f"{time.perf_counter() - t1:.1f} s")
    whole = os.path.join(work, "stream_whole.pcm")
    killed, ck = os.path.join(work, "stream_killed.pcm"), os.path.join(work, "stream_ck.npz")
    for f in (killed, ck):
        if os.path.exists(f):
            os.remove(f)
    cli = ("--chunk-blocks", str(STREAM_CLI_CHUNK))
    rcs = [_cli_stream(dev, os.path.join(work, "stream_in.pcm"), whole, "wiener", *cli)]
    common = (os.path.join(work, "stream_in.pcm"), killed, "wiener", *cli, "--ckpt", ck,
              "--ckpt-every", str(STREAM_CLI_EVERY))
    rcs += [_cli_stream(dev, *common, "--crash-after", str(STREAM_CLI_CRASH)) for _ in range(2)]
    rcs.append(_cli_stream(dev, *common))
    aec_runs = {}
    g1 = ST.GEQSession(device=dev)
    ya = np.concatenate([g1.process(gx[s: s + 512]) for s in range(0, GEQ_T // 2, 512)])
    g1.checkpoint(os.path.join(work, "geq_session.npz"))
    yb = np.concatenate([g1.process(gx[s: s + 512]) for s in range(GEQ_T // 2, GEQ_T, 512)])
    g2 = ST.GEQSession(device=dev)
    g2.restore(os.path.join(work, "geq_session.npz"))
    geq_runs = [np.concatenate([ya, yb]), g2.process(gx[GEQ_T // 2:]), yb,
                ST.GEQSession(device=dev).process(gx)]
    for variant, (x, r) in (("nlms", (ax, ar)), ("bnlms", (bx, br))):
        s1 = ST.AECSession(variant, device=dev)
        half = AEC_T // 2
        pa = [s1.process(x[s: s + 1024], r[s: s + 1024]) for s in range(0, half, 1024)]
        s1.checkpoint(os.path.join(work, f"{variant}_session.npz"))
        pb = [s1.process(x[s: s + 1024], r[s: s + 1024]) for s in range(half, AEC_T, 1024)]
        s2 = ST.AECSession(variant, device=dev)
        s2.restore(os.path.join(work, f"{variant}_session.npz"))
        aec_runs[variant] = ([np.concatenate([p[i] for p in pa + pb]) for i in (0, 1)],
                             s2.process(x[half:], r[half:]),
                             [np.concatenate([p[i] for p in pb]) for i in (0, 1)],
                             ST.AECSession(variant, device=dev).process(x, r))
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"[4 stream] launches {json.dumps(launches)} in {time.perf_counter() - t0:.1f} s")
    half = T_FULL // 2 // STREAM_CHUNK * STREAM_CHUNK
    f64_chunks = (_n_chunks(half, [STREAM_CHUNK]) + 2 * _n_chunks(T_FULL - half, [STREAM_CHUNK])
                  + _n_chunks(T_FULL, STREAM_RAGGED))
    print(f"[4 stream] K15: {launches['K15']} launches for {f64_chunks} f64 chunks served")
    if launches["K15"] != f64_chunks:
        raise RuntimeError(f"K15 launched {launches['K15']} times for {f64_chunks} f64 chunks")
    _vad_chunks_vs_plain(P, dev, blocks, sync)

    for name in ("f64", "f32"):
        out, again, cont = runs[name, "resumed"]
        _same(f"{name} second half after restore vs the uninterrupted session", again, cont)
        ragged = runs[name, "ragged"]
        if name == "f64":
            _flip_count(out, refs["full", "wiener"], "f64 chunks of 4 vs reference_enhance",
                        COMPAT_FLIPPED)
            _flip_count(ragged, refs["full", "wiener"], "f64 ragged chunks vs reference_enhance",
                        COMPAT_FLIPPED)
            _flip_count(out, one_f64, "f64 chunks of 4 vs the one-shot run_stream", COMPAT_FLIPPED)
        else:
            for what, got in (("chunks of 4", out), ("ragged chunks", ragged)):
                d = int((got != one_f32).sum()) if got.shape == one_f32.shape else -1
                snr = snr_db(one_f32, got) if got.shape == one_f32.shape else float("nan")
                print(f"[4 stream] f32 {what} vs the one-shot f32 xla run_stream: {snr:.2f} dB, "
                      f"{d} samples differ")
                if d != 0:
                    raise RuntimeError(f"stream f32 {what}: {d} samples differ from the one-shot "
                                       f"run ({snr:.2f} dB)")
            snr = snr_db(refs["full", "wiener"], out)
            print(f"[4 stream] f32 chunks of 4 vs reference_enhance: {snr:.2f} dB")
    print(f"[4 stream] CLI stream --chunk-blocks {STREAM_CLI_CHUNK}: exit codes {rcs} "
          f"(uninterrupted, killed after {STREAM_CLI_CRASH} chunks twice, finished)")
    if rcs != [0, 137, 137, 0]:
        raise RuntimeError(f"CLI stream exit codes {rcs} != [0, 137, 137, 0]")
    _same("CLI stream killed twice and resumed vs uninterrupted", np.fromfile(killed, "<i2"),
          np.fromfile(whole, "<i2"))
    _flip_count(np.fromfile(whole, "<i2"), refs["full", "wiener"],
                "CLI stream vs reference_enhance", COMPAT_FLIPPED)
    for what, got in zip(("GEQSession with a checkpoint", "GEQSession restored (2nd half)",
                          "GEQSession uninterrupted"), (geq_runs[0], geq_runs[1], geq_runs[3])):
        want = want_geq if got.shape == want_geq.shape else want_geq[GEQ_T // 2:]
        _same(f"{what} over {len(got)} samples vs reference_geq", got, want)
    _same("GEQSession restored vs the first session's second half", geq_runs[1], geq_runs[2])
    for variant, want in (("nlms", want_nlms), ("bnlms", want_bnlms)):
        whole_run, again, cont, uninterrupted = aec_runs[variant]
        if variant == "bnlms":
            print(f"[4 stream] BNLMS stream with a near-end talker: gates open on "
                  f"{sum(want[2])} of {len(want[2])} blocks")
        for i, sig in enumerate(("est", "err")):
            ref = want[i].reshape(-1)
            _same(f"AECSession {variant} {sig} with a checkpoint over {AEC_T} samples vs "
                  f"reference", whole_run[i], ref)
            _same(f"AECSession {variant} {sig} uninterrupted vs reference", uninterrupted[i], ref)
            _same(f"AECSession {variant} {sig} restored vs the first session", again[i], cont[i])
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the stream phase did not launch {missing}")
    return launches


def time_stream(P, dev, x_full, card, sync):
    """Phase 5 for streaming: ms per chunk of EnhanceSession (median of REPS
    batches, CUDA events), f64 and f32 at chunks of 4 and 64 blocks, and one
    chunk of 4 under torch.profiler (device busy time, the idle share)."""
    import torch

    from jeicyboodsp_tpu_torch.io import stream as ST

    blocks = x_full.reshape(T_FULL, 512)
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        for chunk in STREAM_CHUNK_TIMED:
            sess = ST.EnhanceSession("wiener", dtype=dtype, device=dev)
            pos = [0]

            def step(sess=sess, chunk=chunk):
                s = pos[0]
                pos[0] = (s + chunk) % (T_FULL - chunk)
                sess.process(blocks[s: s + chunk])

            ms = median_ms(step, sync)
            print(f"[5 timing] EnhanceSession wiener {name} chunk {chunk} on {card}: {ms:.3f} ms "
                  f"a chunk, {chunk * 512 / ms * 1e3:.4g} samples/s")
            if chunk == STREAM_CHUNK:
                wall, busy, kernels, host = profile_call(step, sync, top=5)
                print(f"[5 timing] EnhanceSession {name} chunk {chunk} under torch.profiler "
                      f"(spans recorded, the output's copy drained first): "
                      f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                      f"{1 - busy / wall:.3f}; top kernels "
                      f"{[(round(t, 4), c, k[:40]) for t, c, k in kernels]}; top host ops "
                      f"{[(round(t, 3), c, k[:40]) for t, c, k in host]}")


def drive_mvdr(P, dev, card, sync):
    """Phase 4 and 5 for MVDR at T_FULL stereo blocks against reference_mvdr:
    f64 xla one step on under 1% of the samples; f32 xla and f32 mxu3 with
    collapse=False >= 60 dB; the mxu3 collapse one step on under 1% and >=
    90 dB; steering_delay(0.3) in f64 one step on under 1%.  Then each engine
    timed (median ms, samples/s).  No kernel runs on this path."""
    import torch

    from jeicyboodsp_tpu_torch.ops import mvdr as MV
    from jeicyboodsp_tpu_torch.utils.metrics import snr_db

    rng = np.random.default_rng(SEED + 3)
    xl, xr = make_stereo(T_FULL * 512, rng)
    t0 = time.perf_counter()
    want = reference_mvdr(xl, xr)
    dt = MV.steering_delay(0.3)
    want_dt = reference_mvdr(xl, xr, d_time=dt)
    print(f"[4 mvdr] reference_mvdr at T={T_FULL}, twice: {time.perf_counter() - t0:.1f} s")
    bl, br = (torch.from_numpy(x.reshape(T_FULL, 512)).to(dev) for x in (xl, xr))
    cases = {  # name: (dtype, engine, collapse, d_time)
        "f64 xla": (torch.float64, "xla", True, 0.0),
        "f32 xla": (torch.float32, "xla", True, 0.0),
        "f32 mxu3 collapse=False": (torch.float32, "mxu3", False, 0.0),
        "f32 mxu3 (collapse)": (torch.float32, "mxu3", True, 0.0),
        "f64 xla steering 0.3": (torch.float64, "xla", True, dt),
    }
    for name, (dtype, eng, col, d) in cases.items():
        out, mask = MV.mvdr_blocks(bl, br, d, dtype=dtype, fft_engine=eng, collapse=col)
        got = out[mask].reshape(-1).cpu().numpy()
        ref = want_dt if d else want
        if np.isnan(snr := snr_db(ref, got)) or got.shape != ref.shape:
            raise RuntimeError(f"mvdr {name}: {got.shape} samples, want {ref.shape}")
        if dtype == torch.float64 or col and eng == "mxu3":
            _flip_count(got, ref, f"{name} vs reference_mvdr ({snr:.2f} dB)", MVDR_FLIPS,
                        tag="[4 mvdr]")
        if dtype == torch.float32:
            floor = MVDR_COLLAPSE_DB if col and eng == "mxu3" else MVDR_F32_DB
            print(f"[4 mvdr] {name}: {snr:.2f} dB vs reference_mvdr (floor {floor})")
            if not snr >= floor:
                raise RuntimeError(f"mvdr {name}: {snr:.2f} dB < {floor}")
        def call(dtype=dtype, eng=eng, col=col, d=d):
            return MV.mvdr_blocks(bl, br, d, dtype=dtype, fft_engine=eng, collapse=col)

        ms = median_ms(call, sync)
        wall, busy, kernels, _ = profile_call(call, sync, top=4)
        print(f"[5 timing] mvdr_blocks {name} T={T_FULL} on {card}: {ms:.3f} ms, "
              f"{T_FULL * 512 / ms * 1e3:.4g} samples/s; under torch.profiler device busy "
              f"{busy:.3f} of {wall:.3f} ms, top kernels "
              f"{[(round(t, 3), c, k[:48]) for t, c, k in kernels]}")


# ---- speech recognition: GMM training and classification, HMM decoding (no kernel but K10) ----

# bytes of a GMMParameter struct: alpha, mean, cov, eigvec (PCA_LEN 8 as trained, 4 as tested)
TRAIN_STRUCT, TEST_STRUCT = 8 * (4 + 48 + 576 + 48 * PCA_TRAIN), 8 * (4 + 48 + 576 + 48 * PCA_TEST)


GMM_C, GMM_F = 25, 512    # classes x frames of the training corpus (bench/all_configs.py:938)
GMM_TEST_FILES, GMM_TEST_FRAMES = 2, 128  # a class's test files (the benchmark's 4 x 128, :990)
HMM_T = 4096              # frames of the decoded utterance (bench/all_configs.py:822)
VIT_U, VIT_T = 512, 512   # the corpus decode: utterances x frames (:904)
VIT_SAMPLED = 8           # batched utterances held against their single decodes
ALPHA_RTOL, MEAN_TOL, COV_TOL, DOT_TOL = 1e-6, 1e-5, 1e-4, 1e-5  # tests/test_gmm.py:25-41
VIT_RTOL = 1e-9           # compat scores (tests/test_gmm.py:136)
ASSOC_RTOL, ASSOC_ATOL = 1e-5, 1e-2  # corrected against viterbi_assoc (tests/test_gmm.py:406)
PRINTED_ATOL = 5e-7       # half a unit of %f's last digit
F32_TIE_ULPS = 4          # an f32 decode may pick another state where two states' f64 values
                          # differ by this few f32 spacings of the score (2^-8 at T = 4096): its
                          # partial sums round there (seen: up to 1.42 on the CPU, three seeds)
TRAIN_REPS = 3


def synth_class(seed, n):
    """bench/all_configs.py:940-947: four separated sub-clusters, frame i in
    cluster (i // 4) % 4, so the k-means seeds land in distinct clusters."""
    r = np.random.default_rng(seed)
    center = r.normal(0, 10, 12)
    sub = center + r.normal(0, 4.0, (4, 12))
    ids = (np.arange(n) // 4) % 4
    return sub[ids] + r.normal(0, 0.5, (n, 12))


def _c_argmax(scores):
    """GMMAlgorithm_Test_Auto_ver2.cpp:117-124: strict <, first wins, a NaN
    keeps the incumbent."""
    pred, best = 0, scores[0]
    for u in range(1, len(scores)):
        if best < scores[u]:
            best, pred = scores[u], u
    return pred


def _check_trained(what, got, refs):
    """The port's PCA export (numpy, per class) against reference_train_class
    at tests/test_gmm.py's bounds, the signs of the eigenvectors aligned
    first (cuSOLVER's differ from LAPACK's)."""
    worst = {"alpha": 0.0, "mean": 0.0, "cov": 0.0, "dots": 0.0}
    for c, ref in enumerate(refs):
        a, m, cv, e = (x[c] for x in got)
        s = np.sign(np.sum(e * ref.eigvec, axis=1))
        s[s == 0] = 1.0
        m = m.copy()
        m[:, :PCA_TRAIN] *= s
        worst["alpha"] = max(worst["alpha"], float(np.max(np.abs(a - ref.alpha) / np.abs(ref.alpha))))
        worst["mean"] = max(worst["mean"], float(np.max(np.abs(m - ref.mean) / (1 + np.abs(ref.mean)))))
        worst["cov"] = max(worst["cov"], float(np.max(np.abs(cv - ref.cov) / (1 + np.abs(ref.cov)))))
        dots = np.abs(np.sum(e * ref.eigvec, axis=1))[:, :4]
        worst["dots"] = max(worst["dots"], float(np.max(np.abs(dots - 1))))
    ok = (worst["alpha"] <= ALPHA_RTOL and worst["mean"] <= MEAN_TOL and worst["cov"] <= COV_TOL
          and worst["dots"] <= DOT_TOL)
    print(f"[4 speech] {what} against reference_train_class: worst alpha rel {worst['alpha']:.2e} "
          f"(limit {ALPHA_RTOL}), mean {worst['mean']:.2e} ({MEAN_TOL}), cov {worst['cov']:.2e} "
          f"({COV_TOL}), 1 - |top-4 eigenvector dots| {worst['dots']:.2e} ({DOT_TOL})")
    if not ok:
        raise RuntimeError(f"{what} differs from reference_train_class")


def _same_value(got, want, rtol, atol=0.0):
    return (np.isnan(got) and np.isnan(want)) or abs(got - want) <= atol + rtol * abs(want)


def bench_hmm(rng):
    """bench/all_configs.py:822-866: the f32 decode model (alpha 1/4, means
    N(0, 1), covariances 2 I, eigenvectors the identity's first 4 columns,
    uniform transitions) with HMM_T N(0, 1) frames; and the packed f64 HMM
    the reference binary decodes (projected means N(0, 2), variances 0.01,
    QR eigenvectors, transitions near uniform) with its observation, each
    frame near a random state's first mixture."""
    f32 = (rng.normal(0, 1.0, (HMM_T, 12)).astype(np.float32), np.full((6, 4), 0.25, np.float32),
           rng.normal(0, 1, (6, 4, 12)).astype(np.float32),
           np.broadcast_to(np.eye(12, dtype=np.float32), (6, 4, 12, 12)) * np.float32(2.0),
           np.ascontiguousarray(np.broadcast_to(np.eye(12, dtype=np.float32)[:, :4], (6, 4, 12, 4))),
           np.full((6, 6), 1.0 / 6, np.float32))
    states = []
    for _ in range(6):
        mn = np.zeros((4, 12))
        mn[:, :4] = rng.normal(0, 2, (4, 4))
        ev = np.zeros((4, 12, 4))
        for k in range(4):
            ev[k] = np.linalg.qr(rng.normal(0, 1, (12, 4)))[0]
        states.append((np.full(4, 0.25), mn, np.stack([np.eye(12) * 0.01 for _ in range(4)]), ev))
    transn = rng.dirichlet(np.ones(6), size=6) + 0.5
    transn /= transn.sum(axis=1, keepdims=True)
    seq = rng.integers(0, 6, HMM_T)
    obs = np.stack([states[s][3][0] @ states[s][1][0][:4] + rng.normal(0, 0.02, 12) for s in seq])
    # the same model's state 0 held throughout: state 0's value stays positive, so the
    # log-of-log recursion stays finite (a state 0 below 0 makes every later value NaN)
    obs0 = states[0][3][0] @ states[0][1][0][:4] + rng.normal(0, 0.02, (HMM_T, 12))
    return f32, (states, transn, obs, obs0)


def drive_speech(P, dev, sync):
    """Phase 4 for speech recognition, every launch counter set to 0 just
    before and read just after (K10 must launch):

    - train_classes_batched in f64 over GMM_C classes x GMM_F frames of
      synth_class against reference_train_class (tests/test_gmm.py's
      bounds, eigenvector signs aligned), with the k-means iterations;
    - the gmm-train CLI on those classes' feature files (its model file held
      to the same bounds), then gmm-test on that same file through the CLI
      (the reference's misaligned read) and the pipeline aligned, every
      printed decision equal to reference_score_file's under the reference's
      argmax;
    - speech_train(mxu3, f32, K10) over CLASSES x TRAIN_BLOCKS blocks of
      class_signal, then speech_classify(mxu3) of an utterance a class with
      the trained models in f64: every decision equal to that of
      reference_score_file on the f64 reference MFCC, the scores of the
      finite models within SCORE_RTOL, NaN where the reference's are;
    - viterbi(compat=True) on the packed HMM at HMM_T frames (its
      observation, and state 0 held) against reference_hmm_decode (paths
      equal, scores and per-time values within 1e-9, NaN equal), and the
      viterbi --verbose CLI's lines within %f's rounding of its values; the
      corrected viterbi against viterbi_assoc on the decode model in f64
      (paths equal, scores within 1e-5 / 1e-2), both in f32 against the f64
      decode (scores within HMM_T * 2^-24, paths equal but at f32 ties);
      viterbi_batched over VIT_U x VIT_T against single decodes of
      VIT_SAMPLED utterances;
    - the awgn CLI at T_FULL blocks: the noise recovered through the wrap
      has |mean| < 0.5 and 8.5 < std < 11.5, a 32760 stretch wraps
      negative, whiteness_ratio below 0.25 after the first block (and
      within 1e-9 of a numpy f64 autocorrelation).

    Returns the launch counts and the timing inputs."""
    import contextlib
    import io

    import torch

    counted = {k: getattr(getattr(P, k), SOURCES[k][0]) for k in SOURCES}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke", "speech")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(SEED + 7)
    feats = np.stack([synth_class(1000 + c, GMM_F) for c in range(GMM_C)])
    t0 = time.perf_counter()
    refs = [reference_train_class([feats[c]]) for c in range(GMM_C)]
    lists = []
    for c in range(GMM_C):
        p = os.path.join(work, f"c{c}.mfc")
        feats[c].astype("<f8").tofile(p)
        lists.append(os.path.join(work, f"c{c}.lst"))
        with open(lists[-1], "w") as f:
            f.write(p)  # no trailing whitespace: the reference's fscanf loop
    train_list, model = os.path.join(work, "train.lst"), os.path.join(work, "model.bin")
    with open(train_list, "w") as f:
        f.write("\n".join(lists))
    r2 = np.random.default_rng(555)
    test_lists, test_files = [], []
    for c in range(GMM_C):
        paths = []
        for j in range(GMM_TEST_FILES):
            fr = feats[c][r2.integers(0, GMM_F, GMM_TEST_FRAMES)] + r2.normal(0, 0.3, (GMM_TEST_FRAMES, 12))
            paths.append(os.path.join(work, f"t{c}_{j}.mfc"))
            fr.astype("<f8").tofile(paths[-1])
            test_files.append(fr)
        test_lists.append(os.path.join(work, f"t{c}.lst"))
        with open(test_lists[-1], "w") as f:
            f.write("\n".join(paths))
    test_list = os.path.join(work, "test.lst")
    with open(test_list, "w") as f:
        f.write("\n".join(test_lists))
    train = [class_signal(c, TRAIN_BLOCKS * 1024, rng) for c in range(CLASSES)]
    utts = [class_signal(c, UTT_BLOCKS * 1024, rng) for c in range(CLASSES)]
    audio = torch.from_numpy(np.stack(train).reshape(CLASSES, TRAIN_BLOCKS, 1024)).to(dev)
    ublocks = [torch.from_numpy(u.reshape(-1, 1024)).to(dev) for u in utts]
    (vf, va, vm, vc, ve, vt), (hstates, htrans, hobs, hobs0) = bench_hmm(rng)
    hmm_path, obs_path = os.path.join(work, "hmm.bin"), os.path.join(work, "obs.mfc")
    with open(hmm_path, "wb") as f:
        for a, m, cv, ev in hstates:
            f.write(b"".join(np.asarray(x, "<f8").tobytes() for x in (a, m, cv, ev)))
        f.write(np.asarray(htrans, "<f8").tobytes())
    hobs.astype("<f8").tofile(obs_path)
    obs_list = os.path.join(work, "obs.lst")
    with open(obs_list, "w") as f:
        f.write(obs_path)
    dec32 = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (vf, va, vm, vc, ve, vt)]
    hmm64 = P.H.hmm_to_port(*(np.stack([s[i] for s in hstates]) for i in range(4)), htrans, dev)
    corpus = torch.from_numpy(rng.normal(0, 1.0, (VIT_U, VIT_T, 12)).astype(np.float32)).to(dev)
    lengths = torch.full((VIT_U,), VIT_T, dtype=torch.int64, device=dev)
    awgn_x = make_signal(T_FULL * 512, rng)
    awgn_x[: 20 * 512] = 32760
    awgn_in, awgn_out = _write_probe(work, "awgn_in", awgn_x), os.path.join(work, "awgn_out.pcm")
    print(f"[4 speech] inputs and reference_train_class x {GMM_C}: {time.perf_counter() - t0:.1f} s")

    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ft = torch.from_numpy(feats).to(dev)
    masks = torch.ones(GMM_C, GMM_F, dtype=torch.bool, device=dev)
    trained = P.GM.train_classes_batched(ft, masks)
    counts = P.GM.kmeans_counted(ft, masks, ft[:, 0:16:4])[2]
    with contextlib.redirect_stdout(io.StringIO()):
        P.cli.main(["gmm-train", train_list, model])  # the card: the CLI's default device
    with contextlib.redirect_stdout(io.StringIO()) as out:
        P.cli.main(["gmm-test", test_list, model])
    printed_mis = out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        P.registry.gmm_test(test_list, model, emulate_layout_mismatch=False)
    printed_al = out.getvalue()
    s_model = P.S.speech_train(audio, dtype=torch.float32, fft_engine="mxu3")
    s_model64 = [x.double() for x in s_model[:3]] + [s_model[3][..., :4].double()]
    s_scores = [P.S.speech_classify(b, *s_model64, dtype=torch.float32, fft_engine="mxu3")
                for b in ublocks]  # the f32 features scored in f64, as against class_models
    compat_runs = [P.H.viterbi(torch.from_numpy(o).to(dev), *hmm64, compat=True, full=True)
                   for o in (hobs, hobs0)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        P.cli.main(["viterbi", obs_list, hmm_path, "--verbose"])
    printed_vit = out.getvalue()
    dec64 = [t.double() for t in dec32]
    corrected = {dt: (P.H.viterbi(*d, compat=False), P.H.viterbi_assoc(*d))
                 for dt, d in (("f64", dec64), ("f32", dec32))}
    paths_b, scores_b = P.H.viterbi_batched(corpus, lengths, *dec32[1:], compat=False)
    P.cli.main(["awgn", awgn_in, awgn_out])
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0

    # training
    got = [x.cpu().numpy() for x in trained]
    _check_trained(f"train_classes_batched f64 {GMM_C}x{GMM_F} (k-means iterations "
                   f"{sorted(set(counts.tolist()))})", got, refs)
    with open(model, "rb") as f:
        raw = np.frombuffer(f.read(), "<f8").reshape(GMM_C, -1)
    as_export = [raw[:, :4], raw[:, 4:52].reshape(-1, 4, 12), raw[:, 52:628].reshape(-1, 4, 12, 12),
                 raw[:, 628:].reshape(-1, 4, 12, 8)]
    _check_trained("the gmm-train CLI's model file", as_export, refs)
    # gmm-test on that same file
    for what, printed, stride, pca in (("gmm-test CLI (misaligned PCA-4 read)", printed_mis,
                                        TEST_STRUCT, PCA_TEST),
                                       ("gmm_test aligned", printed_al, TRAIN_STRUCT, PCA_TRAIN)):
        models = reference_read_models(model, GMM_C, stride, pca)
        want = []
        nan_files = 0
        for i, fr in enumerate(test_files):
            scores = [reference_score_file(fr, *m) for m in models]
            nan_files += any(np.isnan(scores))
            want.append(f"{i // GMM_TEST_FILES + 1} -th result {_c_argmax(scores) + 1}")
        lines = printed.splitlines()
        ok = lines == want
        right = sum(int(w.split()[-1]) == i // GMM_TEST_FILES + 1 for i, w in enumerate(want))
        print(f"[4 speech] {what}: {len(lines)} decisions equal to reference_score_file's {ok} "
              f"({nan_files} files with NaN scores; {right} of {len(want)} decisions the class)")
        if not ok:
            raise RuntimeError(f"{what}: decisions differ from the reference")
    # speech_train(mxu3) through K10 and speech_classify
    model64 = [x.cpu().numpy() for x in s_model64]
    ref_models = [(model64[0][c], model64[1][c], np.stack([np.diag(v)[:4] for v in model64[2][c]]),
                   model64[3][c]) for c in range(CLASSES)]
    finite = np.isfinite(model64[0]).all(1) & np.isfinite(model64[3]).all((1, 2, 3))
    dec_ok, fin_ok, right, worst = True, True, 0, 0.0
    for c, u in enumerate(utts):
        f = reference_mfcc(u, skip_first=False)
        want = np.array([reference_score_file(f, *m) for m in ref_models])
        got_c = s_scores[c].cpu().numpy()
        dec_ok &= _c_argmax(got_c.tolist()) == _c_argmax(want.tolist())
        fin_ok &= bool(np.array_equal(np.isnan(got_c), np.isnan(want))
                       and _c_argmax(got_c[finite].tolist()) == _c_argmax(want[finite].tolist()))
        worst = max(worst, float(np.max(np.abs(got_c[finite] - want[finite]) / np.abs(want[finite]))))
        right += int(np.flatnonzero(finite)[_c_argmax(got_c[finite].tolist())]) == c
    print(f"[4 speech] speech_train(mxu3, K10) {CLASSES}x{TRAIN_BLOCKS} blocks -> "
          f"{int(finite.sum())} finite class models (the others NaN, as the reference's k-means "
          f"seeding leaves them on these tones); speech_classify(mxu3) of {CLASSES} utterances: "
          f"every decision that of reference_score_file on the f64 MFCC {dec_ok}, NaN scores in "
          f"the same places and the decision among the finite models equal {fin_ok} ({right} the "
          f"class), largest relative score difference over the finite models {worst:.2e} (limit "
          f"{SCORE_RTOL})")
    if not (dec_ok and fin_ok and finite.any() and worst <= SCORE_RTOL):
        raise RuntimeError("speech_train / speech_classify decisions differ from the reference")
    # decodes
    states4 = [(a, m, np.stack([np.diag(c)[:4] for c in cv]), e) for a, m, cv, e in hstates]
    for what, o, (path_c, score_c, bests_c) in zip(("the benchmark's observation",
                                                     "state 0 held"), (hobs, hobs0), compat_runs):
        t1 = time.perf_counter()
        bests = []
        rpath, rscore = reference_hmm_decode(o, states4, htrans, bests)
        ref_s = time.perf_counter() - t1
        ok = np.array_equal(path_c.cpu().numpy(), rpath) and _same_value(float(score_c), rscore,
                                                                          VIT_RTOL)
        ok_b = all(_same_value(g, w, VIT_RTOL) for g, w in zip(bests_c.cpu().numpy()[1:][::-1], bests))
        print(f"[4 speech] viterbi(compat) T={HMM_T} f64, {what}: path and score equal to "
              f"reference_hmm_decode {ok} (score {float(score_c)!r}, reference {rscore!r}; NaN "
              f"values {int(np.isnan(bests).sum())} of {len(bests)}), per-time values {ok_b}; the "
              f"reference took {ref_s:.1f} s")
        if not (ok and ok_b):
            raise RuntimeError(f"viterbi compat ({what}) differs from reference_hmm_decode")
        if o is hobs:
            ref_bests, ref_path = bests, rpath
    vals = [float(v) for v in re.findall(r"max accumulated prob (\S+)", printed_vit)]
    ok_v = len(vals) == HMM_T - 1 and all(_same_value(g, w, VIT_RTOL, PRINTED_ATOL)
                                           for g, w in zip(vals, ref_bests))
    path_line = printed_vit.splitlines()[-1]
    ok_p = path_line == "".join("%d ," % d for d in ref_path) and "decoding result ! " in printed_vit
    print(f"[4 speech] viterbi --verbose CLI: {len(vals)} 'max accumulated prob' lines within "
          f"%f's rounding of the reference's {ok_v}, the path line identical {ok_p}")
    if not (ok_v and ok_p):
        raise RuntimeError("the viterbi --verbose lines differ from reference_hmm_decode's")
    (path_s, score_s), (path_a, score_a) = corrected["f64"]
    ok = (torch.equal(path_s, path_a)
          and abs(float(score_s) - float(score_a)) <= ASSOC_ATOL + ASSOC_RTOL * abs(float(score_a)))
    print(f"[4 speech] viterbi(compat=False) against viterbi_assoc T={HMM_T} f64: paths equal and "
          f"scores {float(score_s)!r} / {float(score_a)!r} within {ASSOC_RTOL} / {ASSOC_ATOL} {ok}")
    f32_rtol = HMM_T * 2.0 ** -24  # a sum of HMM_T f32 terms, rounded at every step
    P64 = reference_forward(*(t.cpu().numpy().astype(np.float64) for t in dec32))
    p64 = path_s.cpu().numpy()
    for form, (p32, s32) in zip(("viterbi(compat=False)", "viterbi_assoc"), corrected["f32"]):
        diff = np.flatnonzero(p32.cpu().numpy() != p64)
        a, b = p32.cpu().numpy()[diff], p64[diff]
        ulps = np.abs(P64[diff, a] - P64[diff, b]) / np.spacing(np.float32(abs(float(score_s))))
        ok32 = bool((ulps <= F32_TIE_ULPS).all()) and abs(float(s32) - float(score_s)) <= f32_rtol * abs(
            float(score_s))
        print(f"[4 speech] {form} T={HMM_T} f32 (the benchmark's dtype) against the f64 decode: "
              f"score {float(s32)!r} within {f32_rtol:.2e} relative, {len(diff)} frames of the "
              f"path differ, each an f32 tie (the two states' f64 values within "
              f"{F32_TIE_ULPS} f32 spacings of the score, largest "
              f"{ulps.max(initial=0):.2f}): {ok32}")
        ok &= ok32
    if not ok:
        raise RuntimeError("the corrected Viterbi forms differ")
    worst, ok = 0.0, True
    for u in np.linspace(0, VIT_U - 1, VIT_SAMPLED).astype(int):
        p1, s1 = P.H.viterbi(corpus[u], *dec32[1:], compat=False)
        ok &= torch.equal(p1, paths_b[u])
        worst = max(worst, abs(float(s1) - float(scores_b[u])) / abs(float(s1)))
    print(f"[4 speech] viterbi_batched {VIT_U}x{VIT_T} f32: {VIT_SAMPLED} sampled paths equal to "
          f"single decodes {ok}, largest relative score difference {worst:.2e} (limit {ASSOC_RTOL})")
    if not (ok and worst <= ASSOC_RTOL):
        raise RuntimeError("viterbi_batched differs from single decodes")
    # awgn
    got = np.fromfile(awgn_out, "<i2")
    x = awgn_x[: len(got)]
    noise = (got.astype(np.int32) - x).astype(np.int16)
    n = noise.astype(np.float64)
    wraps = bool(np.all(got[: 20 * 512][n[: 20 * 512] > 7] < 0))
    nb = torch.from_numpy(noise.reshape(-1, 512)).to(dev)
    ratios = P.AW.whiteness_ratio(nb).cpu().numpy()
    u = noise.reshape(-1, 512).astype(np.float64)
    frames = np.concatenate([np.concatenate([np.zeros((1, 512)), u[:-1]]), u], 1)
    X = np.fft.fft(frames, axis=1)
    ac = np.fft.ifft(X.real ** 2 + X.imag ** 2, axis=1).real[:, :512]
    want_r = np.abs(ac[:, 1:]).max(1) / np.maximum(ac[:, 0], 1e-30)
    ok = (len(got) == T_FULL * 512 and abs(n.mean()) < 0.5 and 8.5 < n.std() < 11.5 and wraps
          and ratios[1:].max() < 0.25 and np.allclose(ratios, want_r, rtol=1e-9, atol=0))
    print(f"[4 speech] awgn CLI {T_FULL} blocks: noise mean {n.mean():.4f}, std {n.std():.4f}, the "
          f"32760 stretch wraps {wraps}, whiteness max {ratios[1:].max():.4f} (< 0.25), ratios "
          f"within 1e-9 of numpy's {np.allclose(ratios, want_r, rtol=1e-9, atol=0)}: {ok}")
    if not ok:
        raise RuntimeError("awgn differs from its bounds")
    print(f"[4 speech] launches {json.dumps({k: n for k, n in launches.items() if n})} in "
          f"{main_s:.1f} s")
    if launches["K10"] == 0:
        raise RuntimeError("the speech phase did not launch K10")
    return launches, dict(ft=ft, masks=masks, test_list=test_list, model=model, audio=audio,
                          ublocks=ublocks, dec32=dec32, hmm64=hmm64, hobs=hobs, corpus=corpus,
                          lengths=lengths, awgn=(awgn_in, awgn_out),
                          n_test=len(test_files))


def time_speech(P, dev, card, sync, inp):
    """Phase 5 for speech recognition: train_classes_batched f64 and f32
    (frames/s), gmm-test per file, speech_train(mxu3), each decode form (ms,
    frames/s) and the awgn CLI, the decodes and training also under
    torch.profiler (device busy, idle share)."""
    import contextlib
    import io

    import torch

    ft, masks = inp["ft"], inp["masks"]
    ft32 = ft.float()
    hobs = torch.from_numpy(inp["hobs"]).to(dev)
    runs = {  # name: (call, frames a call)
        f"train_classes_batched f64 {GMM_C}x{GMM_F}": (
            lambda: P.GM.train_classes_batched(ft, masks), GMM_C * GMM_F),
        f"train_classes_batched f32 {GMM_C}x{GMM_F}": (
            lambda: P.GM.train_classes_batched(ft32, masks), GMM_C * GMM_F),
        f"speech_train(mxu3) f32 {CLASSES}x{TRAIN_BLOCKS} blocks": (
            lambda: P.S.speech_train(inp["audio"], dtype=torch.float32, fft_engine="mxu3"),
            CLASSES * TRAIN_BLOCKS * 2),
        f"viterbi(compat) f64 T={HMM_T}": (
            lambda: P.H.viterbi(hobs, *inp["hmm64"], compat=True), HMM_T),
        f"viterbi(compat=False) f32 T={HMM_T}": (
            lambda: P.H.viterbi(*inp["dec32"], compat=False), HMM_T),
        f"viterbi_assoc f32 T={HMM_T}": (lambda: P.H.viterbi_assoc(*inp["dec32"]), HMM_T),
        f"viterbi_batched f32 {VIT_U}x{VIT_T}": (
            lambda: P.H.viterbi_batched(inp["corpus"], inp["lengths"], *inp["dec32"][1:]),
            VIT_U * VIT_T),
    }
    for name, (call, frames) in runs.items():
        ms = median_ms(call, sync, reps=TRAIN_REPS)
        wall, busy, kernels, host = profile_call(call, sync, top=3)
        print(f"[5 timing] {name} on {card}: {ms:.3f} ms = {frames / ms * 1e3:.4g} frames/s; under "
              f"torch.profiler wall {wall:.3f} ms, device busy {busy:.3f} ms (idle "
              f"{100 * (1 - busy / wall):.1f}%), top kernels "
              f"{[(round(t, 3), c, k[:40]) for t, c, k in kernels]}, host ops "
              f"{[(round(t, 3), c, k[:30]) for t, c, k in host]}")

    def gmm_test():
        with contextlib.redirect_stdout(io.StringIO()):
            P.cli.main(["gmm-test", inp["test_list"], inp["model"]])

    def awgn():
        P.cli.main(["awgn", *inp["awgn"]])

    for name, call, n, unit in (("gmm-test CLI", gmm_test, inp["n_test"], "file"),
                                (f"awgn CLI {T_FULL} blocks", awgn, 1, "call")):
        call()
        sync()
        t0 = time.perf_counter()
        for _ in range(TRAIN_REPS):
            call()
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REPS / n
        extra = f" = {T_FULL * 512 / ms * 1e3:.4g} samples/s" if n == 1 else ""
        print(f"[5 timing] {name} on {card} (host clock, files included): {ms:.3f} ms a {unit}"
              f"{extra}")


# ---- f32 echo cancellers (K8, K9 f32 instances), time-parallel BNLMS, LPC, the linear GEQ
# ---- scan, and the sharded paths (parallel/) in a world of one NCCL rank

AEC_SNR_FLOORS = (60.0, 40.0)  # est, err dB against the f64 references (tests/test_nlms.py:24-26)
TP_T = 1024               # blocks of the time-parallel session (bench/all_configs.py:521-535)
TP_LSB, TP_DB = 2, 60.0   # time-parallel against the f64 sequential path (tests/test_nlms.py:39-65)
TP_HEAD = 16              # blocks held to those bounds: the linearized recursion drifts from the
                          # sequential one over a long session, in JAX's op too (ROADMAP R20);
                          # JAX's benchmark checks the first 16 (bench/all_configs.py:542-559)
LPC_T = 8192              # LPC frames of 512 (bench/all_configs.py:794-800)
LPC_F64_RTOL = 1e-9       # lpc solve f64 against reference_lpc, of the largest coefficient
# levinson f32 against reference_lpc, of each frame's largest coefficient.  JAX's f32 op on these
# LPC_T frames (jitted, CPU) reads a median frame error of 3.74e-7 and 1 frame above 1e-2 (a tone
# frame whose 12x12 system is near singular; worst 0.058); the limits are 4x those readings, the
# factor tests/test_torch_lpc.py allows the port's median frame against JAX's.  That file reads
# JAX's numbers anew and holds these limits to them.
LPC_F32_JAX = (3.74e-7, 1)  # JAX's f32 levinson here: median frame error, frames above 1e-2
LPC_F32_MEDIAN, LPC_F32_LOST = 4 * LPC_F32_JAX[0], 4 * LPC_F32_JAX[1]
GEQ_FAST_FLIPS = 1e-3     # c_short(geq_apply_fast f64) against reference_geq_linear: share of
                          # samples one step off (the scan groups its f64 sums otherwise)
AEC_SAMPLED = (0, AEC_B - 1)  # an echo stream and a double-talk stream


def check_aec_f32(P, aec, sync):
    """Phase 3 for the f32 instances of K8 and K9: each against its plain
    version at the full stream count and the shorter T of PLAIN_T (K8 both
    update pairings, and T = 257 from a nonzero state with -0.0
    coefficients), bit for bit.  Returns the max |kernel - plain| of each."""
    import torch

    dev = aec[0].device
    err = {"K8f32": 0.0}
    xa, ra = (v[:, :PLAIN_T["K8"]].contiguous() for v in aec)
    for compat in (True, False):
        got = P.K8.nlms_f32(xa, ra, compat=compat)
        want = P.K8.nlms_f32_plain(xa, ra, *P.K8.init_state(len(xa), dev, torch.float32),
                                   compat=compat)
        sync()
        pairs = list(zip(got[:2], want[:2])) + [(got[2][0].view(torch.int32),
                                                 want[2][0].view(torch.int32)),
                                                (got[2][1], want[2][1])]
        err["K8f32"] = max(err["K8f32"], _bit_equal(
            "K8 f32", f"compat={compat} B={len(xa)} T={xa.shape[1]} (est, err, coef bits, hist)",
            pairs))
    t0 = PLAIN_T["K8"]
    xa, ra = (v[:, t0:t0 + 257].contiguous() for v in aec)
    hist = aec[0][:, t0 - 255:t0].contiguous()
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    coef = 1e-3 * torch.randn(len(xa), 256, generator=g, dtype=torch.float32, device=dev)
    coef[:, ::5] = -0.0
    got = P.K8.nlms_f32(xa, ra, (coef, hist))
    want = P.K8.nlms_f32_plain(xa, ra, coef, hist)
    sync()
    pairs = list(zip(got[:2], want[:2])) + [(got[2][0].view(torch.int32),
                                             want[2][0].view(torch.int32))]
    err["K8f32"] = max(err["K8f32"], _bit_equal(
        "K8 f32", f"B={len(xa)} T=257 from a nonzero state (est, err, coef bits)", pairs))
    xa, ra = (v[:, :PLAIN_T["K9"]].contiguous() for v in aec)
    keep = torch.zeros(len(xa), 127, dtype=torch.int16, device=dev)
    gates = P.K9.bnlms_gates(xa, ra, keep, keep)
    gates[::3, 1::2] = False
    got = P.K9.bnlms_f32(xa, ra, gates)
    want = P.K9.bnlms_f32_plain(xa, ra, gates, *P.K9.init_state(len(xa), dev, torch.float32))
    sync()
    pairs = list(zip(got[:2], want[:2])) + [(got[2][0].view(torch.int32),
                                             want[2][0].view(torch.int32)),
                                            (got[2][1], want[2][1])]
    err["K9f32"] = _bit_equal("K9 f32", f"B={len(xa)} {xa.shape[1] // 1024} blocks, "
                              f"{int(gates.sum())} of {gates.numel()} gates open "
                              "(est, err, coef bits, keep)", pairs)
    return err


def _snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    e = ref - np.asarray(test, np.float64)
    if not (e ** 2).sum():
        return float("inf")
    return float(10 * np.log10((ref ** 2).sum() / (e ** 2).sum()))


def _aec_floors(what, pairs):
    """Print the est and err SNRs of (f64 reference, f32 output) pairs; fail
    below AEC_SNR_FLOORS."""
    s = [_snr_db(w, g) for w, g in pairs]
    print(f"[4 aec-fast] {what}: est {s[0]:.2f} dB, err {s[1]:.2f} dB against the f64 "
          f"reference (floors {AEC_SNR_FLOORS[0]:.0f}/{AEC_SNR_FLOORS[1]:.0f} dB)")
    if not (s[0] >= AEC_SNR_FLOORS[0] and s[1] >= AEC_SNR_FLOORS[1]):
        raise RuntimeError(f"{what}: f32 below the SNR floors")


def drive_aec_fast(P, dev, aec, sync):
    """Phase 4 for ``nlms --fast`` and ``bnlms --fast``: the K8 and K9 f32
    launch counters set to 0 just before and read just after: nlms_apply and
    bnlms_apply in f32 over AEC_B x AEC_T, the nlms and bnlms CLI with
    --fast on the echo probe, the nlms --verbose CLI.  Then every block of
    the AEC_SAMPLED streams against the script's f64 references (SNR
    floors), the CLI outputs likewise, and the verbose lines against the
    reference's per-block coefficients under %f.  Returns the counts."""
    import contextlib
    import io

    import torch

    N, f32 = P.N, torch.float32
    counted = {"K8f32": P.K8.nlms_f32, "K9f32": P.K9.bnlms_f32}
    work = os.path.join(ROOT, "jeicyboodsp_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    _, probes = _probe_signals()
    px, pr = probes["echo"]
    inp = _write_probe(work, "aec_in", px)
    refp = os.path.join(work, "aec_ref.pcm")
    pr.astype("<i2").tofile(refp)
    outs = {k: os.path.join(work, f"aec_{k}.pcm") for k in ("n_est", "n_err", "b_est", "b_err",
                                                            "v_est", "v_err")}
    x, r = aec
    nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.nlms_init_state(f32).items()}
    bz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.bnlms_init_state(f32).items()}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    e8, r8, s8 = N.nlms_apply(x, r, nz, dtype=f32)
    e9, r9, s9 = N.bnlms_apply(x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024), bz,
                               dtype=f32)
    P.cli.main(["nlms", inp, refp, outs["n_est"], outs["n_err"], "--fast"])
    P.cli.main(["bnlms", inp, refp, outs["b_est"], outs["b_err"], "--fast"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        P.cli.main(["nlms", inp, refp, outs["v_est"], outs["v_err"], "--verbose"])
    sync()
    launches = {k: fn.launches for k, fn in counted.items()}
    main_s = time.perf_counter() - t0
    if s8["coeff"].dtype != f32 or s9["coeff"].dtype != f32:
        raise RuntimeError("the f32 ops returned another state dtype")
    t1 = time.perf_counter()
    xs, rs = x[list(AEC_SAMPLED)].cpu().numpy(), r[list(AEC_SAMPLED)].cpu().numpy()
    for i, s in enumerate(AEC_SAMPLED):
        xb, rb = xs[i].reshape(-1, 1024), rs[i].reshape(-1, 1024)
        kind = "echo" if s < 3 * AEC_B // 4 else "double-talk"
        _aec_floors(f"nlms_apply f32 stream {s} ({kind}), {AEC_T // 1024} blocks",
                    zip([v.reshape(-1) for v in reference_nlms_blocks(xb, rb)],
                        (e8[s].cpu(), r8[s].cpu())))
        _aec_floors(f"bnlms_apply f32 stream {s} ({kind}), {AEC_T // 1024} blocks",
                    zip([v.reshape(-1) for v in reference_bnlms_blocks(xb, rb)[:2]],
                        (e9[s].reshape(-1).cpu(), r9[s].reshape(-1).cpu())))
    for kind, tag in (("nlms", "n"), ("bnlms", "b")):
        want = reference_nlms(px, pr, bnlms=kind == "bnlms")[:2]
        got = [np.fromfile(outs[f"{tag}_{k}"], "<i2") for k in ("est", "err")]
        _aec_floors(f"{kind} --fast CLI on the echo probe", zip(want, got))
    traj = []
    nb = -(-len(px) // 1024)
    ve, verr = reference_nlms_blocks(stale_blocks(px, 1024)[:nb], stale_blocks(pr, 1024)[:nb],
                                     traj)
    want = "".join("rgsdCoefficient[0] %f, rgsdCoefficient[1] %f, rgsdCoefficient[2] %f \n" % c
                   for c in traj)
    ok = out.getvalue() == want and np.array_equal(np.fromfile(outs["v_est"], "<i2"),
                                                   ve[1:].reshape(-1))
    print(f"[4 aec-fast] nlms --verbose CLI: {len(traj)} lines equal to the reference's "
          f"coefficient trajectory under %f, est int16-equal: {ok}")
    if not ok:
        raise RuntimeError("nlms --verbose lines differ from the reference's trajectory")
    print(f"[4 aec-fast] launches {json.dumps(launches)} in {main_s:.1f} s (checks "
          f"{time.perf_counter() - t1:.1f} s)")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"the f32 AEC path did not launch {missing}")
    return launches


def time_aec_fast(P, aec, card, sync):
    """Phase 5 for the f32 instances: each kernel at AEC_B x AEC_T (median of
    REPS) against its plain version at PLAIN_TIME_T and the f64 instance, the
    bounds, K9 f32's resident blocks, and the ops nlms_apply / bnlms_apply
    in f32 (ms, samples/s)."""
    import torch

    N, f32 = P.N, torch.float32
    x, r = aec
    dev = x.device
    keep = torch.zeros(AEC_B, 127, dtype=torch.int16, device=dev)
    gates = P.K9.bnlms_gates(x, r, keep, keep)
    n_open = int(gates.sum())
    st8, st9 = P.K8.init_state(AEC_B, dev, f32), P.K9.init_state(AEC_B, dev, f32)
    cut = lambda v, k: v[:, :PLAIN_TIME_T[k]].contiguous()  # noqa: E731
    n_aec = AEC_B * AEC_T
    runs = {
        "K8f32": (lambda: P.K8.nlms_f32(x, r), lambda: P.K8.nlms(x, r),
                  lambda: P.K8.nlms_f32_plain(cut(x, "K8"), cut(r, "K8"), *st8), "K8",
                  PROF.KERNELS["K8f32"](AEC_B, AEC_T)),
        "K9f32": (lambda: P.K9.bnlms_f32(x, r, gates), lambda: P.K9.bnlms(x, r, gates),
                  lambda: P.K9.bnlms_f32_plain(cut(x, "K9"), cut(r, "K9"), cut(gates, "K9"),
                                               *st9), "K9",
                  PROF.KERNELS["K9f32"](AEC_B, AEC_T, n_open)),
    }
    times = {}
    for name, (kern, f64_kern, plain, base, work) in runs.items():
        ms = median_ms(kern, sync)
        ms64 = median_ms(f64_kern, sync, reps=3)
        plain_ms = median_ms(plain, sync, reps=PLAIN_REPS)
        b_ms, b_by, b_text = bound_line(work)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"[5 timing] {name} {AEC_B}x{AEC_T} on {card}: kernel {ms:.3f} ms = "
              f"{n_aec / (ms * 1e-3):.4g} samples/s; the f64 instance {ms64:.3f} ms; plain "
              f"{plain_ms:.3f} ms at T={PLAIN_TIME_T[base]}; {b_text}; library call: none")
    print(f"[5 timing] K9 f32 resident blocks per SM ({P.K9.THREADS} threads a block): "
          f"{P.K9.occupancy(dev, f32)} (f64 instance {P.K9.occupancy(dev)})")
    nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.nlms_init_state(f32).items()}
    bz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in N.bnlms_init_state(f32).items()}
    xb, rb = x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024)
    for op, fn in (("nlms_apply f32", lambda: N.nlms_apply(x, r, nz, dtype=f32)),
                   ("bnlms_apply f32", lambda: N.bnlms_apply(xb, rb, bz, dtype=f32))):
        ms = median_ms(fn, sync, reps=3)
        print(f"[5 timing] op {op} {AEC_B}x{AEC_T} on {card}: {ms:.3f} ms = "
              f"{n_aec / (ms * 1e-3):.4g} samples/s")
    return times


def tp_inputs(dev):
    """One session of TP_T blocks: the bench's mixed signal over 512 blocks
    tiled, and its echo through a random 32-tap room (lead 0.5)."""
    import torch

    rng = np.random.default_rng(SEED + 11)
    x = make_signal(512 * 1024, rng)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    r = np.clip(np.convolve(x.astype(np.float64), h)[:len(x)], -32768, 32767).astype(np.int16)
    reps = -(-TP_T * 1024 // len(x))
    xt = np.tile(x, reps)[:TP_T * 1024].reshape(TP_T, 1024)
    rt = np.tile(r, reps)[:TP_T * 1024].reshape(TP_T, 1024)
    return torch.from_numpy(xt).to(dev), torch.from_numpy(rt).to(dev)


def drive_timeparallel(P, tp, card, sync):
    """bnlms_apply_timeparallel (f32) over one session of TP_T blocks on the
    card: its first TP_HEAD blocks against the f64 sequential path (the
    gates and K9 f64, int16-equal to the reference) at TP_LSB steps and
    TP_DB on the error signal, as JAX's benchmark checks it
    (bench/all_configs.py:542-559); the whole session within one step on
    under 1% of the samples of the same op on the CPU; the drift of the
    linearized recursion from the sequential path over the session printed
    (ROADMAP R20); its time (median of 3) and peak memory.  Returns (est,
    err)."""
    import torch

    x, r = tp
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    est, err = P.N.bnlms_apply_timeparallel(x, r)
    sync()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    e_seq, r_seq, _ = P.N.bnlms_apply(x, r, P.N.bnlms_init_state())
    d_e = (e_seq.to(torch.int64) - est.to(torch.int64)).abs()
    d_r = (r_seq.to(torch.int64) - err.to(torch.int64)).double()
    a = r_seq.double()

    def db(k):
        return float(10 * torch.log10((a[:k] ** 2).sum().clamp_min(1e-30)
                                      / (d_r[:k] ** 2).sum().clamp_min(1e-30)))

    drift = ", ".join(f"{k} blocks {db(k):.2f} dB" for k in (16, 64, 256, TP_T) if k <= TP_T)
    head = (int(d_e[:TP_HEAD].max()), int(d_r[:TP_HEAD].abs().max()), db(TP_HEAD))
    t1 = time.perf_counter()
    c_est, c_err = P.N.bnlms_apply_timeparallel(x.cpu(), r.cpu())
    cpu_s = time.perf_counter() - t1
    cpu = [_lsb_share(g.cpu(), w) for g, w in ((est, c_est), (err, c_err))]
    ok = (head[0] <= TP_LSB and head[1] <= TP_LSB and head[2] >= TP_DB
          and all(m <= 1 and sh < 0.01 for m, sh in cpu))
    ms = median_ms(lambda: P.N.bnlms_apply_timeparallel(x, r), sync, reps=3)
    print(f"[4 timeparallel] bnlms_apply_timeparallel f32 T={TP_T} blocks on {card}: the first "
          f"{TP_HEAD} blocks against the f64 sequential path max |diff| est {head[0]}, err "
          f"{head[1]} (limit {TP_LSB}), error signal {head[2]:.2f} dB (floor {TP_DB}); the whole "
          f"session against the same op on the CPU max |diff| / share est {cpu[0][0]} / "
          f"{cpu[0][1]:.2e}, err {cpu[1][0]} / {cpu[1][1]:.2e} (one step on under 1%; the CPU "
          f"took {cpu_s:.1f} s); drift from the sequential path: {drift}; {ms:.3f} ms = "
          f"{TP_T * 1024 / (ms * 1e-3):.4g} samples/s (first call {first_s:.2f} s), peak memory "
          f"{peak / 2 ** 30:.3f} GiB above the inputs: {ok}")
    if not ok:
        raise RuntimeError("the time-parallel BNLMS is off the sequential path or the CPU run")
    return est, err


def drive_lpc(P, dev, card, sync):
    """LPC over LPC_T frames of 512 of the bench's mixed signal: lpc_run in
    f64 (solve) and f32 (levinson) on the card against reference_lpc, and
    lpc_frames' time for both (median of REPS)."""
    import torch

    rng = np.random.default_rng(SEED + 9)
    x = make_signal(LPC_T * 256, rng)
    t0 = time.perf_counter()
    want = reference_lpc(x)
    ref_s = time.perf_counter() - t0
    scale = np.abs(want).max(1)
    got64 = P.F.lpc_run(x, dtype=torch.float64, solver="solve")
    got32 = P.F.lpc_run(x, dtype=torch.float32, solver="levinson")
    e64 = float(np.abs(got64 - want).max() / np.abs(want).max())
    e32 = np.abs(got32 - want).max(1) / scale
    lost = int((e32 > 1e-2).sum())
    ok = (got64.shape == got32.shape == want.shape and e64 <= LPC_F64_RTOL
          and np.isfinite(got32).all() and np.median(e32) <= LPC_F32_MEDIAN
          and lost <= LPC_F32_LOST)
    blocks = torch.from_numpy(x.reshape(LPC_T, 256)).to(dev)
    frames = torch.cat([torch.cat([torch.zeros_like(blocks[:1]), blocks[:-1]]), blocks], 1)
    ms = {f"{s} {str(d)[6:]}": median_ms(lambda s=s, d=d: P.F.lpc_frames(frames, d, s), sync)
          for s, d in (("levinson", torch.float32), ("solve", torch.float64))}
    print(f"[4 lpc] lpc_run {LPC_T} frames of 512 on {card}: solve f64 within {e64:.2e} of "
          f"reference_lpc's largest coefficient (limit {LPC_F64_RTOL}); levinson f32 per-frame "
          f"error median {np.median(e32):.2e} (limit {LPC_F32_MEDIAN:.3g}), {lost} of {len(e32)} "
          f"frames above 1e-2 (limit {LPC_F32_LOST}; 4x JAX's f32 op on these frames), worst "
          f"{e32.max():.2e}: {ok}; "
          f"the reference took {ref_s:.1f} s")
    for k, v in ms.items():
        print(f"[5 timing] lpc_frames {k} {LPC_T}x512 on {card}: {v:.3f} ms = "
              f"{LPC_T / (v * 1e-3):.4g} frames/s")
    if not ok:
        raise RuntimeError("lpc_run differs from reference_lpc")


def drive_geq_fast(P, geq, card, sync):
    """geq_apply_fast in f64 over GEQ_B x GEQ_T (one call; the scan's peak
    memory printed) against reference_geq_linear on two sampled streams:
    c_short of the output one step off on under GEQ_FAST_FLIPS of the
    samples; its time (median of 3).  Returns the output."""
    import torch

    b, a = P.G.geq_coefficients()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = P.G.geq_apply_fast(geq, b, a, dtype=torch.float64)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    worst, share = 0, 0.0
    for s in (0, GEQ_B - 1):
        want = reference_geq_linear(geq[s].cpu().numpy(), b, a)
        d = np.abs(P.cnum.c_short(y[s]).cpu().numpy().astype(np.int64) - want.astype(np.int64))
        worst, share = max(worst, int(d.max())), max(share, float((d != 0).mean()))
    ref_s = time.perf_counter() - t0
    ms = median_ms(lambda: P.G.geq_apply_fast(geq, b, a, dtype=torch.float64), sync, reps=3)
    ok = worst <= 1 and share <= GEQ_FAST_FLIPS and bool(torch.isfinite(y).all())
    print(f"[4 geq-fast] geq_apply_fast f64 {GEQ_B}x{GEQ_T} in one call on {card}: streams 0 and "
          f"{GEQ_B - 1} against reference_geq_linear max |diff| {worst}, differing share "
          f"{share:.2e} (limit one step on {GEQ_FAST_FLIPS}); {ms:.3f} ms = "
          f"{GEQ_B * GEQ_T / (ms * 1e-3):.4g} samples/s; peak memory {peak / 2 ** 30:.2f} GiB "
          f"above the input (the reference took {ref_s:.1f} s): {ok}")
    if not ok:
        raise RuntimeError("geq_apply_fast differs from reference_geq_linear")
    return y


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _lsb_share(got, want):
    """(max |difference|, share of samples that differ) of two int tensors."""
    import torch

    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return (int(d.max()), float((d != 0).double().mean())) if d.numel() else (0, 0.0)


SPEECH_SHARDED_BLOCKS = 256  # blocks a class: 512 frames, the JAX benchmark's frames a class
TRAIN_RTOL, TRAIN_ATOL, TRAIN_DOT_TOL = 1e-9, 1e-11, 1e-8  # tests/test_speech_sharded.py
DECODE_RTOL = 1e-10


def _same_trained(got, want):
    """tests/test_speech_sharded.py's training contract on two PCA exports
    (torch): alpha, mean and cov at TRAIN_RTOL / TRAIN_ATOL, eigenvectors by
    |cosine| within TRAIN_DOT_TOL, NaN equal.  Returns (ok, the largest
    |difference| of alpha, mean and cov, the largest 1 - |cosine|)."""
    import torch

    ok = all(torch.allclose(g, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL, equal_nan=True)
             for g, w in zip(got[:3], want[:3]))
    diff = max(float((g - w).abs().nan_to_num(0.0).max()) for g, w in zip(got[:3], want[:3]))
    e, f = got[3], want[3]
    cos = ((e * f).sum(-2) / (e.norm(dim=-2) * f.norm(dim=-2) + 1e-300)).abs()
    ok &= torch.equal(cos.isnan(), f.isnan().any(-2))
    worst = float((1 - cos).abs().nan_to_num(0.0).max())
    return ok and worst <= TRAIN_DOT_TOL, diff, worst


def _event_ms(fn, sync):
    """One call of fn between two CUDA events: (its result, ms)."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    sync()
    return out, a.elapsed_time(b)


def drive_speech_sharded(P, SS, mesh, dev, card, sync, n_blocks=SPEECH_SHARDED_BLOCKS,
                         n_utt=VIT_U, utt_blocks=VIT_T // 2):
    """parallel/speech_sharded.py's three paths on an (expert, data) mesh of
    shape (1, 1), at full width (CLASSES classes of 12-dim features, 4
    mixtures), against the unsharded ops on the same inputs:

    - speech_train_sharded over CLASSES x n_blocks blocks of class_signal:
      f64 xla against speech_train at tests/test_speech_sharded.py's
      contract (eigenvectors by |cosine|, NaN equal), f32 mxu3 (its MFCC by
      the matmul DFT, as JAX's sharded training) with its largest difference
      from speech_train(mxu3) (through K10) printed;
    - speech_classify_sharded f32 mxu3 of an utterance a class against the
      f64 models: K10 counted around this call alone, every decision (the
      reference's argmax) and score that of speech_classify(mxu3) one
      utterance at a time, scores within SCORE_RTOL, NaN equal;
    - speech_decode_sharded over n_utt utterances of utt_blocks blocks
      against mfcc_blocks + viterbi_batched, with an HMM whose 6 states are
      finite class models: f64 paths equal and scores within DECODE_RTOL,
      f32 paths equal.

    Each call's ms (CUDA events) printed beside the card.  Returns (ok, the
    K10 launches of the sharded classification)."""
    import torch

    f64, f32 = torch.float64, torch.float32
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    audio = torch.from_numpy(np.stack([class_signal(c, n_blocks * 1024, rng).reshape(-1, 1024)
                                       for c in range(CLASSES)])).to(dev)
    utts = torch.from_numpy(np.stack([class_signal(c, UTT_BLOCKS * 1024, rng).reshape(-1, 1024)
                                      for c in range(CLASSES)])).to(dev)
    results = []
    tag = f"[4 parallel] speech_sharded {CLASSES}x{n_blocks} blocks"
    got, ms = _event_ms(lambda: SS.speech_train_sharded(audio, mesh, dtype=f64), sync)
    want = P.S.speech_train(audio, dtype=f64)
    ok, diff, dots = _same_trained(got, want)
    finite = torch.isfinite(want[0]).all(-1) & torch.isfinite(want[3]).all(-1).all(-1).all(-1)
    print(f"{tag}: speech_train_sharded f64 xla {ms:.1f} ms (one call, CUDA events; {card}); "
          f"against speech_train: max |alpha, mean, cov difference| {diff:g} (rtol {TRAIN_RTOL}"
          f" / atol {TRAIN_ATOL}), max 1 - |cosine| of the eigenvectors {dots:.2e} (limit "
          f"{TRAIN_DOT_TOL}), NaN equal; {int(finite.sum())} of {CLASSES} models finite: {ok}")
    results.append(ok)
    got32, ms = _event_ms(lambda: SS.speech_train_sharded(audio, mesh, dtype=f32,
                                                          fft_engine="mxu3"), sync)
    want32 = P.S.speech_train(audio, dtype=f32, fft_engine="mxu3")
    same_nan = all(torch.equal(g.isnan(), w.isnan()) for g, w in zip(got32[:3], want32[:3]))
    d32 = max(float((g - w).abs().nan_to_num(0.0).max()) for g, w in zip(got32[:3], want32[:3]))
    print(f"{tag}: speech_train_sharded f32 mxu3 (the matmul DFT) {ms:.1f} ms (one call; "
          f"{card}); against speech_train(mxu3) (K10): max |alpha, mean, cov difference| "
          f"{d32:g}, NaN in the same places {same_nan} (printed, not held: two MFCC routes)")
    models = (got[0], got[1], got[2], got[3][..., :4])
    P.K10.mfcc_fused.launches = 0
    scores, ms = _event_ms(lambda: SS.speech_classify_sharded(utts, *models, mesh, dtype=f32,
                                                              fft_engine="mxu3"), sync)
    k10 = P.K10.mfcc_fused.launches
    want_s = torch.stack([P.S.speech_classify(u, *models, dtype=f32, fft_engine="mxu3")
                          for u in utts]).cpu().numpy()
    got_s = scores.cpu().numpy()
    fin = np.isfinite(want_s)
    worst = float(np.max(np.abs(got_s[fin] - want_s[fin]) / np.abs(want_s[fin]), initial=0.0))
    dec = [_c_argmax(g.tolist()) for g in got_s]
    ok = (dec == [_c_argmax(w.tolist()) for w in want_s]
          and np.array_equal(np.isnan(got_s), np.isnan(want_s)) and worst <= SCORE_RTOL)
    print(f"{tag}: speech_classify_sharded f32 mxu3 of {CLASSES} utterances x {UTT_BLOCKS} "
          f"blocks {ms:.2f} ms (one call; {card}), K10 launches {k10}; every decision that of "
          f"speech_classify(mxu3), NaN equal, largest relative score difference {worst:.2e} "
          f"(limit {SCORE_RTOL}); {sum(d == c for c, d in enumerate(dec))} decisions the class: "
          f"{ok}")
    results.append(ok and k10 > 0)
    # the decoding HMM: 6 finite class models as its states, a random row-stochastic trans
    states = torch.nonzero(finite)[:6, 0].tolist()
    if len(states) < 6:
        raise RuntimeError(f"only {len(states)} finite class models for the decoding HMM")
    trans = rng.uniform(0.05, 1.0, (6, 6))
    hmm64 = (*(v[states] for v in models), torch.from_numpy(trans / trans.sum(1, keepdims=True))
             .to(dev))
    hmm32 = tuple(v.float() for v in hmm64)
    cls = np.array(states)[np.arange(n_utt) % 6]
    dec_utts = torch.from_numpy(np.stack([class_signal(c, utt_blocks * 1024, rng).reshape(-1, 1024)
                                          for c in cls])).to(dev)
    for dt, hmm in ((f64, hmm64), (f32, hmm32)):
        (paths, sc), ms = _event_ms(lambda: SS.speech_decode_sharded(dec_utts, *hmm, mesh,
                                                                      dtype=dt), sync)
        feats = P.F.mfcc_blocks(dec_utts, *P.F.mel_dct(dt, dev), dtype=dt)
        lengths = torch.full((n_utt,), feats.shape[1], dtype=torch.int64, device=dev)
        wp, ws = P.H.viterbi_batched(feats, lengths, *hmm, compat=False)
        ok = torch.equal(paths, wp) and bool(torch.isfinite(ws).all())
        ok &= torch.allclose(sc, ws, rtol=DECODE_RTOL, atol=0.0) if dt == f64 else True
        rel = float(((sc - ws).abs() / ws.abs()).max())
        print(f"{tag}: speech_decode_sharded {str(dt)[6:]} {n_utt} utterances x {utt_blocks} "
              f"blocks ({2 * utt_blocks} frames) {ms:.1f} ms (one call; {card}); against "
              f"mfcc_blocks + viterbi_batched: paths equal, finite scores within "
              f"{DECODE_RTOL if dt == f64 else 'f32'} relative (largest {rel:.2e}): {ok}")
        results.append(ok)
    print(f"{tag}: {len(results)} checks, all within their contracts {all(results)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return all(results), k10


def drive_parallel(P, dev, x_full, aec, tp, geq, geq_fast, card, sync):
    """Every parallel/sharded.py path in a world of one NCCL rank on this
    card, at the unsharded op's smoke size, against that op on the same
    inputs: each path's max |difference| printed and held to
    tests/test_sharded.py's contract (equal, or one int16 step on under 1%,
    em_step at rtol 1e-10, the GEQ at rtol 1e-7 / atol 1e-5).  K14 is counted
    over the f32 enhancement paths.  One card cannot show what several do:
    the halo exchanges and gathers are between a rank and itself here; the
    multi-rank logic is held by tests/test_torch_parallel.py's gloo worlds.
    Then parallel/speech_sharded.py's three paths on an (expert, data) mesh
    of shape (1, 1) (:func:`drive_speech_sharded`; the multi-rank logic held
    by tests/test_torch_speech_sharded.py).  Returns the K14 launches and
    K10's under speech_classify_sharded."""
    import torch
    import torch.distributed as dist

    from jeicyboodsp_tpu_torch.parallel import mesh as M
    from jeicyboodsp_tpu_torch.parallel import sharded as S
    from jeicyboodsp_tpu_torch.parallel import speech_sharded as SS

    f64, f32 = torch.float64, torch.float32
    t0 = time.perf_counter()
    M.init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, device=dev.type)
    nccl = ".".join(map(str, torch.cuda.nccl.version())) if dev.type == "cuda" else "none"
    print(f"[4 parallel] a world of one NCCL rank on {card}: NCCL {nccl}, torch "
          f"{torch.__version__}; one card "
          f"cannot show multi-GPU behaviour (halos and gathers stay on this card, no NVLink); "
          f"the multi-rank logic is held by the gloo worlds of tests/test_torch_parallel.py")
    results = []

    def report(name, got, want, contract):
        diff = max((float((g.double() - w.double()).abs().max()) if g.numel() else 0.0)
                   for g, w in zip(got, want))
        if contract == "equal":
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
        elif contract == "lsb":
            ok = all(_lsb_share(g, w)[0] <= 1 and _lsb_share(g, w)[1] < 0.01
                     for g, w in zip(got, want) if g.dtype == torch.int16)
            ok &= all(torch.equal(g, w) for g, w in zip(got, want) if g.dtype == torch.bool)
        else:
            rtol, atol = contract
            ok = all(torch.allclose(g, w, rtol=rtol, atol=atol) for g, w in zip(got, want))
        results.append(ok)
        print(f"[4 parallel] {name}: max |sharded - unsharded| {diff:g} ({contract}): {ok}")

    mt, md = M.make_mesh((1,), ("time",)), M.make_mesh((1,), ("data",))
    m2, mm = M.make_mesh((1, 1), ("data", "time")), M.make_mesh((1,), ("model",))
    blocks = torch.from_numpy(x_full.reshape(T_FULL, 512)).to(dev)

    def k14_counted(run):
        """Run a sharded call with K14's count set to 0 just before it and read
        just after, so the unsharded reference run later adds nothing."""
        P.K14.vad_flags.launches = 0
        got = run()
        sync()
        return got, P.K14.vad_flags.launches

    k14 = {}
    for dt in (f64, f32):
        got, n = k14_counted(lambda: S.enhance_sharded(blocks, mt, dtype=dt))
        if dt == f32:
            k14["enhance_sharded f32"] = n
        report(f"enhance_sharded wiener {str(dt)[6:]} T={T_FULL}", got,
               P.E.enhance_blocks(blocks, dtype=dt), "lsb")
    b2 = blocks.reshape(2, T_FULL // 2, 512)
    got, k14["enhance_sharded2d f32"] = k14_counted(lambda: S.enhance_sharded2d(b2, m2, dtype=f32))
    want = [P.E.enhance_blocks(b2[i], dtype=f32) for i in range(2)]
    report(f"enhance_sharded2d f32 2x{T_FULL // 2}", got,
           (torch.stack([w[0] for w in want]), torch.stack([w[1] for w in want])), "lsb")
    fc = torch.from_numpy(x_full[:FC_T * 1024].reshape(FC_T, 1024)).to(dev)
    Hr, Hi = P.FC.filter_spectrum()
    out, mask = S.fastconv_sharded(fc, Hr, Hi, mt)
    report(f"fastconv_sharded f64 T={FC_T}", (out[mask],), (P.FC.fastconv_blocks(fc, Hr, Hi),),
           "lsb")
    x, r = aec
    xb, rb = x.reshape(AEC_B, -1, 1024), r.reshape(AEC_B, -1, 1024)
    for dt in (f64, f32):
        nz = {k: v.expand(AEC_B, *v.shape).contiguous() for k, v in P.N.nlms_init_state(dt).items()}
        bz = {k: v.expand(AEC_B, *v.shape).contiguous()
              for k, v in P.N.bnlms_init_state(dt).items()}
        report(f"nlms_sharded {str(dt)[6:]} {AEC_B}x{AEC_T}", S.nlms_sharded(x, r, md, dtype=dt),
               P.N.nlms_apply(x, r, nz, dtype=dt)[:2], "equal")
        report(f"bnlms_sharded {str(dt)[6:]} {AEC_B}x{AEC_T}",
               S.bnlms_sharded(xb, rb, md, dtype=dt), P.N.bnlms_apply(xb, rb, bz, dtype=dt)[:2],
               "equal")
    report(f"bnlms_sharded_time f32 T={TP_T}", S.bnlms_sharded_time(*tp, mt),
           P.N.bnlms_apply_timeparallel(*tp), "lsb")
    rng = np.random.default_rng(SEED + 12)
    ml, mr = make_stereo(T_FULL * 512, rng)
    bl = torch.from_numpy(ml.reshape(-1, 512)).to(dev)
    br = torch.from_numpy(mr.reshape(-1, 512)).to(dev)
    report(f"mvdr_sharded f64 T={T_FULL}", S.mvdr_sharded(bl, br, mt),
           P.MV.mvdr_blocks(bl, br), "lsb")
    report(f"mvdr_sharded_bins f32 T={T_FULL}", S.mvdr_sharded_bins(bl, br, mm),
           P.MV.mvdr_blocks(bl, br, dtype=f32, fft_engine="mxu3"), "lsb")
    fr = torch.from_numpy(np.stack([synth_class(1000, GMM_F)])[0]).to(dev)
    mk = torch.ones(GMM_F, dtype=torch.bool, device=dev)
    alpha = torch.full((4,), 0.25, dtype=f64, device=dev)
    mean, cov = fr[0:16:4], torch.eye(12, dtype=f64, device=dev).expand(4, 12, 12) * 4.0
    report(f"em_step_sharded f64 {GMM_F} frames", S.em_step_sharded(fr, mk, alpha, mean, cov, md),
           P.GM.em_step(fr, mk, alpha, mean, cov), (1e-10, 1e-12))
    b, a = P.G.geq_coefficients()
    report(f"geq_sharded f64 T={GEQ_T}", (S.geq_sharded(geq[0], b, a, mt),), (geq_fast[0],),
           (1e-7, 1e-5))
    dp = S.data_parallel_sharding(md)
    g32 = geq[:8].float()
    report("data_parallel_sharding geq_apply_fast f32 8 streams",
           (dp.gather(P.G.geq_apply_fast(dp.local(g32), b, a)),), (P.G.geq_apply_fast(g32, b, a),),
           "equal")
    speech_ok, k10 = drive_speech_sharded(P, SS, M.make_mesh((1, 1), ("expert", "data")), dev,
                                          card, sync)
    sync()
    dist.destroy_process_group()
    print(f"[4 parallel] {len(results)} paths, all within their contracts {all(results)}; K14 "
          f"launches on the f32 sharded enhancement paths {k14}; the sharded speech paths "
          f"{speech_ok}, K10 launches under speech_classify_sharded {k10}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not (all(results) and speech_ok) or min(k14.values()) == 0 or k10 == 0:
        raise RuntimeError("a sharded path differs from its unsharded op, or K14 or K10 did not "
                           "launch on a sharded path")
    return sum(k14.values()), k10


def drive_checks(card):
    """The reference contracts on the card: ``utils.gpu_checks.run_checks``
    (JAX's ``tpu_checks`` probes through the port's entry points against the
    oracles), its dict printed as one JSON object on a line of its own and
    the launches it made per kernel; fails unless ``all_ok``."""
    from jeicyboodsp_tpu_torch.utils import gpu_checks

    launched = {}
    t0 = time.perf_counter()
    res = gpu_checks.run_checks("cuda", launched)
    secs = time.perf_counter() - t0
    print(f"[3 checks] run_checks('cuda') on {card}: {json.dumps(res)}")
    print(f"[3 checks] {secs:.1f} s; launches per kernel {launched}")
    if not res["all_ok"]:
        raise RuntimeError(f"run_checks: a contract failed: {res}")


SOURCES = {  # kernel: wrapper name, CUDA source, the TPU wrapper it replaces (file:line)
    "K1": ("enhance_full8", "enhance_full8.cu", "enhance_pallas.py:737"),
    "K2": ("enhance_fwd_int8", "enhance_mxu8.cu", "enhance_pallas.py:217"),
    "K3": ("enhance_back_ola8", "enhance_mxu8.cu", "enhance_pallas.py:491"),
    "K4": ("enhance_fwd", "enhance_mxu3.cu", "enhance_pallas.py:87"),
    "K5": ("enhance_back_ola3", "enhance_mxu3.cu", "enhance_pallas.py:337"),
    "K6": ("geq_cascade_quant", "biquad.cu", "biquad_pallas.py:336"),
    "K7": ("geq_cascade", "biquad.cu", "biquad_pallas.py:102"),
    "K8": ("nlms", "nlms.cu", "nlms_pallas.py:317"),
    "K8f32": ("nlms_f32", "nlms.cu", "nlms_pallas.py:317"),  # the f32 instance (nlms --fast)
    "K9": ("bnlms", "nlms.cu", "nlms_pallas.py:261"),
    "K9f32": ("bnlms_f32", "nlms.cu", "nlms_pallas.py:261"),  # the f32 instance (bnlms --fast)
    "K10": ("mfcc_fused", "mfcc.cu", "mfcc_pallas.py:89"),
    "K11": ("amdf", "amdf.cu", "amdf_pallas.py:85"),
    "K12": ("fft_pallas", "fft4.cu", "fft_pallas.py:121"),
    "K13": ("enhance_back", "enhance_mxu3.cu", "enhance_pallas.py:837"),
    "K14": ("vad_flags", "vad.cu", "enhance_pallas.py:540"),
    "K15": ("enhance_chunk64", "enhance_chunk64.cu", None),  # replaces none: XLA ops in JAX
}
# the shared device code a kernel's source includes for its main pass
HEADERS = {"K4": "rfft1024.cuh", "K10": "rfft1024.cuh", "K12": "rfft1024.cuh",
           "K5": "tf32x3.cuh", "K13": "tf32x3.cuh"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    P = _port()

    # 1. device
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: true f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {card}")
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")

    # 2. build
    nvcc = subprocess.run([P._build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    P._build.load_library()
    secs = P._build.build_seconds
    print(f"[2 build] {'nvcc %.1f s' % secs if secs is not None else 'cached'} "
          f"-> {os.path.relpath(P._build.library_path(), ROOT)} ({nvcc})")

    sync = torch.cuda.synchronize
    rng = np.random.default_rng(SEED)  # drawn in bench.py's order: probe, then batch
    probe = make_signal(T_PROBE * 512, rng)
    x_full = make_signal(T_FULL * 512, rng)
    blocks = torch.from_numpy(x_full.reshape(T_FULL, 512)).to(dev)
    C = P.E.enhance_constants(dev)
    speech = P.E.vad_flags(blocks, torch.float32)
    rowpack = P.E._latch_rowpack(speech)

    # 3. kernels against plain versions; 4. main path; 5. timing
    geq, aec = make_geq_streams(GEQ_B, GEQ_T, dev), make_aec_streams(AEC_B, AEC_T, dev)
    err, back_ins = check_kernels(P, blocks, C, rowpack, speech, sync)
    err.update(check_recursions(P, geq, aec, sync))
    err.update(check_aec_f32(P, aec, sync))
    feat = feature_inputs(dev)
    err.update(check_features(P, feat, sync))
    xc, xf = transform_inputs()
    err.update(check_transforms(P, xc, xf, blocks, C, back_ins, sync))
    err["K15"] = check_k15(P, x_full, sync)
    drive_checks(card)
    cases = {"probe": probe, "full": x_full, "partial": probe[: T_PROBE * 512 - 100],
             "empty": probe[:0]}
    refs = {(c, m): reference_enhance(x, m) for c, x in cases.items() for m in MODES}
    launches = drive_main_path(P, dev, cases, refs, sync)
    drive_compat(P, dev, cases, refs, sync)
    launches.update(drive_recursions(P, geq, aec, sync))
    feat_launches, classify = drive_features(P, feat, dev, sync)
    launches.update(feat_launches)
    launches.update(drive_transforms(P, xc, xf, x_full, blocks, dev, sync))
    for k, n in drive_stream(P, dev, x_full, refs, geq, aec, sync).items():
        launches[k] = launches.get(k, 0) + n  # added to the earlier phases'
    drive_mvdr(P, dev, card, sync)
    t_new = time.perf_counter()
    launches.update(drive_aec_fast(P, dev, aec, sync))
    tp = tp_inputs(dev)
    drive_timeparallel(P, tp, card, sync)
    drive_lpc(P, dev, card, sync)
    geq_fast = drive_geq_fast(P, geq, card, sync)
    print(f"[4 slice] the f32 AEC, time-parallel BNLMS, LPC and linear GEQ scan phases: "
          f"{time.perf_counter() - t_new:.1f} s")
    speech_launches, speech_inputs = drive_speech(P, dev, sync)
    for k, n in speech_launches.items():
        launches[k] += n  # the speech phase's launches (K10), added to the earlier phases'
    time_chains(P, blocks, C, card, sync)
    times = time_kernels(P, blocks, C, rowpack, back_ins, card, sync)
    times.update(time_recursions(P, geq, aec, card, sync))
    times.update(time_aec_fast(P, aec, card, sync))
    times.update(time_features(P, feat, classify, card, sync))
    times.update(time_transforms(P, xc, xf, blocks, C, back_ins, card, sync))
    time_stream(P, dev, x_full, card, sync)
    times["K15"] = time_k15(P, x_full, card, sync)
    time_speech(P, dev, card, sync, speech_inputs)
    # last: the NCCL world's threads would share the host with the timed phases above
    k14, k10 = drive_parallel(P, dev, x_full, aec, tp, geq, geq_fast, card, sync)
    launches["K14"] += k14
    launches["K10"] += k10  # speech_classify_sharded(mxu3, f32)

    print(card)
    print(json.dumps({"kernels": [{
        "name": fn,
        "route": "cuda",
        "source": f"jeicyboodsp_tpu_torch/csrc/{src}",
        **({"header": f"jeicyboodsp_tpu_torch/csrc/{HEADERS[name]}"} if name in HEADERS else {}),
        "replaces": f"jeicyboodsp_tpu/kernels/{tpu}" if tpu else None,
        "launches": launches[name],
        "max_abs_err": err[name],
        **times[name],
    } for name, (fn, src, tpu) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
