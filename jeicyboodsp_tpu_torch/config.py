"""Pipeline configurations with the reference programs' values as defaults
(counterpart of ``jeicyboodsp_tpu/config.py``, a copy: the port imports
nothing of the JAX package).

Every knob is a compile-time ``#define`` in the reference; the originating
constant is cited so compat stays auditable.  ``compat="reference"``
reproduces the reference output (f64, quirks on); ``compat="fast"`` runs
the f32 path through the port's kernels (same math, relaxed bit-level
quirks).

``ENGINE_FIDELITY`` holds each engine's SNR floor in dB against the f64
reference on the standard speech+noise probe, the floors the JAX package's
tests assert, which the port's CPU and card tests hold it to, and
``typ``, the JAX package's value on that probe.  ``("enhance", "mxu1")``
has no floor: that engine sits below the 60 dB bar and no CLI reaches it;
``utils.gpu_checks.run_checks`` flags it should it ever reach the bar.
"""

from __future__ import annotations

import dataclasses

ENGINE_FIDELITY = {
    # enhance chain (wiener/specsub)
    ("enhance", "xla"): dict(floor=95.0, typ=104.0, note="f32 torch.fft FFT"),
    ("enhance", "mxu"): dict(floor=90.0, typ=100.0, note="f32 matmul DFT"),
    ("enhance", "mxu3"): dict(
        floor=85.0, typ=90.0,
        note="K4 (shared-memory real FFT, in-kernel VAD) then K5 (3xTF32 tensor-core "
             "inverse, OLA)",
    ),
    ("enhance", "mxu8"): dict(
        floor=78.0, typ=83.8,
        note="K2 (int8-split forward rDFT on the tensor cores) then K3 (per-row-"
             "quantized int8 inverse, 2-level row quantization, lo-cross dots included)",
    ),
    ("enhance", "mxu8f"): dict(
        floor=78.0, typ=83.8,
        note="K14's VAD then the whole chain in one kernel, K1 (the noise latch from "
             "the row pack); the same int8 arithmetic as mxu8",
    ),
    ("enhance", "mxu8t"): dict(
        floor=65.0, typ=69.7,
        note="K1's turbo inverse (4 dots, 1-level row quantization): fidelity "
             "traded for fewer tensor-core dots",
    ),
    ("enhance", "mxu1"): dict(
        floor=None, typ=52.0,
        note="one-pass bfloat16 matmul DFT: below the 60 dB bar, no CLI reaches it "
             "(run_checks' mxu1_below_bar)",
    ),
    # fastconv (--fast default engine: gemm8hq)
    ("fastconv", "xla"): dict(floor=88.0, typ=96.6, note="torch.fft real FFT"),
    ("fastconv", "gemm"): dict(floor=95.0, typ=107.0, note="f32 Toeplitz GEMM"),
    ("fastconv", "gemm8"): dict(
        floor=70.0, typ=78.0,
        note="int8 Toeplitz GEMM (4 dots, torch._int_mm): bounded by the "
             "operator-split residual, which the sparse RIR concentrates",
    ),
    ("fastconv", "gemm8hq"): dict(
        floor=85.0, typ=90.3,
        note="3-term int8 Toeplitz GEMM (a 5th dot recaptures the operator "
             "residual), the --fast default",
    ),
    # mvdr / mfcc (engine changes only the DFT passes)
    ("mvdr", "mxu3"): dict(floor=80.0, typ=90.0, note="theta=0 collapse is exact"),
    ("mfcc", "mxu3"): dict(floor=100.0, typ=111.0, note="the fused MFCC kernel K10"),
}


@dataclasses.dataclass
class GEQConfig:
    """7Band_GEQ.cpp:33-57."""

    sample_rate: float = 48000.0  # :33
    block_len: int = 512  # :43
    q: float = 4.318  # :45
    center_freqs: tuple = (44.0, 125.0, 250.0, 500.0, 2000.0, 6000.0, 11313.0)  # :47
    gains_db: tuple = (12.0, 12.0, 0.0, 0.0, 3.0, 0.0, -12.0)  # :51-57
    compat: str = "reference"


@dataclasses.dataclass
class FastConvConfig:
    """Fast_Convolution_Based_3DAudio_Impl.cpp:47-49 + FilterCoefficient.h."""

    block_size: int = 1024  # :47
    fft_size: int = 8192  # :48
    filter_length: int = 7169  # FilterCoefficient.h:1
    compat: str = "reference"


@dataclasses.dataclass
class EnhanceConfig:
    """WienerFilter_final.cpp:32-45 / SpectralSubtraction_final.cpp:48-56."""

    mode: str = "wiener"  # or "specsub"
    block_len: int = 512  # :43
    fft_size: int = 1024  # :44
    noise_frames: int = 10  # :45
    energy_threshold: float = 700.0  # :32
    zcr_threshold: float = 200.0  # :33
    compat: str = "reference"


@dataclasses.dataclass
class AECConfig:
    """NormalLMS.cpp:29-33 / BNLMS.cpp:33-37."""

    variant: str = "nlms"  # or "bnlms"
    block_len: int = 1024
    taps: int = 256  # nlms; bnlms: 128
    mu: float = 0.0001  # nlms; bnlms: 0.01
    eps: float = 0.0001  # nlms; bnlms: 1e-5
    compat: str = "reference"


@dataclasses.dataclass
class MVDRConfig:
    """BeamForming_MVDR_ver1.cpp:34-41."""

    block_len: int = 512
    fft_len: int = 1024
    keep_len: int = 511  # :37 (quirk: 511, not 512)
    mic_distance_cm: float = 800.0  # :41
    speed_of_sound_cm_s: float = 34000.0  # :40
    steer_angle_rad: float = 0.0  # :57 -> dTime = 0
    compat: str = "reference"


@dataclasses.dataclass
class SpeechConfig:
    """MFCC -> GMM -> Viterbi chain constants.

    MFCCFeatureExtraction_auto_version1.cpp:23-33,
    GMMAlgorithm_Train_Auto_ver2.cpp:20-25, Viterbi_version1.cpp:22-28.
    """

    mfcc_len: int = 12
    mel_channels: int = 38
    lifter_len: int = 22
    num_classes: int = 25
    num_mixtures: int = 4
    em_iterations: int = 3
    pca_train: int = 8
    pca_test: int = 4  # the train/test layout mismatch is emulated in
    num_states: int = 6  # serialization.read_as_test_layout
    compat: str = "reference"
