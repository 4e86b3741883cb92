"""Command-line entry point of the port.

Usage::

    python -m jeicyboodsp_tpu_torch.cli wiener IN OUT
                                        [--fast [--engine xla|mxu|mxu3|mxu8|mxu8f|mxu8t]]
                                        [--device cuda]
    python -m jeicyboodsp_tpu_torch.cli specsub IN OUT [--fast [--engine ...]] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli geq IN OUT [--fast] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli nlms IN REF EST ERR [--fast] [--verbose] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli bnlms IN REF EST ERR [--fast] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli pitch2 IN [--fast [--engine xla|mxu|mxu3]] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli mfcc LISTFILE [--fast [--engine xla|mxu|mxu3|mxu8]]
    python -m jeicyboodsp_tpu_torch.cli fastconv IN OUT
                                        [--fast [--engine xla|gemm|gemm8|gemm8hq|mxu|mxu3]]
    python -m jeicyboodsp_tpu_torch.cli fft IN OUT [--verbose] [--fast]
    python -m jeicyboodsp_tpu_torch.cli mvdr LEFT RIGHT OUT [--fast [--engine xla|mxu|mxu3]]
    python -m jeicyboodsp_tpu_torch.cli stream IN OUT [wiener|specsub] [--fast]
                                        [--ckpt FILE] [--ckpt-every N] [--chunk-blocks N]
                                        [--crash-after N]
    python -m jeicyboodsp_tpu_torch.cli awgn IN OUT [--fast]
    python -m jeicyboodsp_tpu_torch.cli gmm-train LIST MODEL [--verbose] [--fast]
    python -m jeicyboodsp_tpu_torch.cli gmm-test LIST MODEL
    python -m jeicyboodsp_tpu_torch.cli viterbi LIST MODEL [--verbose]

    wiener IN OUT           Wiener noise suppression   (WienerFilter_final)
    specsub IN OUT          spectral subtraction       (SpectralSubtraction_final)
    geq IN OUT              7-band graphic EQ          (7Band_GEQ)
    nlms IN REF EST ERR     per-sample NLMS AEC        (NormalLMS)
    bnlms IN REF EST ERR    block NLMS AEC             (BNLMS)
    pitch1|pitch2|pitch3 IN pitch estimation, printed  (PitchEstimation_*)
    mfcc LISTFILE           corpus MFCC extraction     (MFCCFeatureExtraction...)
    fastconv IN OUT         RIR fast convolution       (Fast_Convolution...)
    fft IN OUT              radix-2 FFT roundtrip      (FFTAlgorithm_ver2)
    mvdr LEFT RIGHT OUT     2-mic MVDR beamformer      (BeamForming_MVDR_ver1)
    stream IN OUT [MODE]    resumable streaming enhancement with
                            checkpoint and fault-injection flags
    awgn IN OUT             AWGN harness               (AnalysisAdditive...)
    gmm-train LIST MODEL    GMM training               (GMMAlgorithm_Train...)
    gmm-test LIST MODEL     GMM classification         (GMMAlgorithm_Test...)
    viterbi LIST MODEL      HMM/Viterbi decoding       (Viterbi_version1)

wiener, specsub, geq, pitch, mfcc, fastconv and fft run in float64 with the
reference's numbers (wiener, specsub, pitch, mfcc and fastconv through
``torch.fft``, geq through the cascade kernel K6, fft through the
reference's radix-2 algorithm) unless
``--fast`` asks for float32 and an ``--engine``: wiener/specsub default to
``xla`` (``torch.fft``) and take ``mxu`` (matmul DFT), ``mxu3`` (the f32
kernels K4/K5), ``mxu8`` (the int8 kernels K2/K3), ``mxu8f`` (the int8
chain in one kernel, K1) and ``mxu8t`` (its turbo inverse); ``mxu`` runs pitch method 2 through the AMDF kernel and the other methods
as matmul DFTs; ``mxu3``/``mxu8`` run the MFCC DFT as f32 matmuls; fastconv
defaults to ``gemm8hq`` (the int8 Toeplitz GEMM), and its ``mxu``/``mxu3``
run both 8192-point transforms through the four-step FFT kernel.  fft and
geq take no ``--engine``: with ``--fast`` fft runs the radix-2 algorithm
and geq its cascade in float32 (as the JAX CLI's ``geq --fast``, not the
reference's output), and ``--verbose`` prints fft's operation counts.
mvdr runs float64 ``xla`` (``torch.fft``) unless ``--fast``: float32 with
``xla``, ``mxu`` or ``mxu3`` (matmul DFTs; at the reference's steering
angle 0 both take the structural collapse, no transforms).  stream (mode
``wiener`` by default) runs the chain in chunks of ``--chunk-blocks``
blocks from a carried state, float64 unless ``--fast`` (float32, the VAD
through K14), and takes no ``--engine``; with ``--ckpt`` it writes a
checkpoint every ``--ckpt-every`` chunks and resumes from it, and
``--crash-after N`` exits with 137 after N chunks (fault injection).
nlms and bnlms run float64 (K8 and K9, the reference's numbers) unless
``--fast`` asks for float32 (the kernels' f32 instances, the JAX ops' f32
arithmetic); nlms ``--verbose`` prints the reference's per-block
coefficient line on the float64 path, as the JAX CLI does.
awgn adds sigma-10 noise drawn from a generator seeded with 0 (the
reference seeds from the clock), float64 unless ``--fast`` (float32).
gmm-train trains one class per line of LIST (each a list of feature files)
in float64 unless ``--fast`` (float32) and writes the reference's PCA-8
model file; ``--verbose`` prints its EM likelihood lines.  gmm-test reads
MODEL with the reference's misaligned PCA-4 layout and prints a decision
per feature file.  viterbi decodes with the reference's compat recursion;
``--verbose`` prints its per-time lines.  None of the three takes an
``--engine``; gmm-test and viterbi take no ``--fast`` (JAX's does nothing
there).

The device defaults to the current CUDA card, and the command fails when
there is none; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

import torch

from jeicyboodsp_tpu_torch.ops import fastconv as FC
from jeicyboodsp_tpu_torch.ops.enhance import ALL_ENGINES

FILES = {"wiener": 2, "specsub": 2, "geq": 2, "nlms": 4, "bnlms": 4,
         "pitch1": 1, "pitch2": 1, "pitch3": 1, "mfcc": 1,
         "fastconv": 2, "fft": 2, "mvdr": 3, "stream": (2, 3),  # file arguments (stream: a mode)
         "awgn": 2, "gmm-train": 2, "gmm-test": 2, "viterbi": 2}
FAST = {  # pipeline: the engines of --fast, its default engine, the compat engine
    **{p: (ALL_ENGINES, "xla", "xla") for p in ("wiener", "specsub")},
    **{f"pitch{m}": (("xla", "mxu", "mxu3"), "xla", "xla") for m in (1, 2, 3)},
    "mfcc": (("xla", "mxu", "mxu3", "mxu8"), "xla", "xla"),
    "fastconv": (FC.ENGINES, "auto", "xla"),
    "fft": ((), None, None),  # --fast is float32 only: no engine choice
    "geq": ((), None, None),
    "mvdr": (("xla", "mxu", "mxu3"), "xla", "xla"),
    "stream": ((), None, None),  # --fast is float32 only, as for geq
    "awgn": ((), None, None),
    "gmm-train": ((), None, None),
    "nlms": ((), None, None),  # --fast: the f32 instance of K8
    "bnlms": ((), None, None),  # --fast: the f32 instance of K9
}
VERBOSE = ("fft", "gmm-train", "viterbi", "nlms")
STREAM_ARGS = ("ckpt", "ckpt_every", "chunk_blocks", "crash_after")
STREAM_MODES = ("wiener", "specsub")


def main(argv=None):
    from jeicyboodsp_tpu_torch.pipelines import PIPELINES

    parser = argparse.ArgumentParser(
        prog="jeicyboodsp_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("pipeline", choices=sorted(PIPELINES))
    parser.add_argument("files", nargs="+")
    parser.add_argument(
        "--engine", default=None,
        choices=sorted({e for engines, _, _ in FAST.values() for e in engines}),
        help="with --fast only.  wiener/specsub: xla (torch.fft; the default), mxu "
        "(f32 matmul DFT), mxu8f = int8 chain in one kernel, hq (~84 dB vs the "
        "reference); mxu8t = the same with a turbo inverse (~73 dB); mxu8 = int8 "
        "forward and back kernels around the latch (~84 dB); mxu3 = the same in "
        "f32 kernels.  pitch*/mfcc "
        "xla (torch.fft; the default), mxu (matmul DFT; AMDF kernel for pitch2), "
        "mxu3 and, for mfcc, mxu8 (both f32 matmul DFTs); fastconv xla (torch.fft), "
        "gemm (f32 Toeplitz GEMM), gemm8 (int8 Toeplitz GEMM, ~77 dB), gemm8hq "
        "(its 3-term form, the default), mxu/mxu3 (four-step FFT kernel); mvdr xla "
        "(torch.fft; the default), mxu/mxu3 (f32 matmul DFTs, the collapse at angle 0)",
    )
    parser.add_argument("--fast", action="store_true",
                        help=f"{'/'.join(sorted(FAST))} only: float32 (and --engine where the "
                        "pipeline has engines), instead of the float64 compat mode")
    parser.add_argument("--verbose", action="store_true",
                        help="the reference's print surface: fft its operation-count lines "
                        "(FFTAlgorithm_ver2.cpp:148), twice per block, and its closing lines; "
                        "gmm-train the EM likelihood before/after lines "
                        "(GMMAlgorithm_Train_Auto_ver2.cpp:332); viterbi the per-time max "
                        "accumulated values (Viterbi_version1.cpp:222); nlms the per-block "
                        "coefficients (NormalLMS.cpp:128), float64 only")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    parser.add_argument("--ckpt", default=None, help="stream: checkpoint file (resumed if present)")
    parser.add_argument("--ckpt-every", type=int, default=None,
                        help="stream: chunks between checkpoints (4)")
    parser.add_argument("--chunk-blocks", type=int, default=None,
                        help="stream: blocks per chunk (4)")
    parser.add_argument("--crash-after", type=int, default=None,
                        help="stream: fault injector, exit with 137 after N chunks")
    ns = parser.parse_args(argv)
    counts = FILES[ns.pipeline] if isinstance(FILES[ns.pipeline], tuple) else (FILES[ns.pipeline],)
    if len(ns.files) not in counts:
        parser.error(f"{ns.pipeline} takes {' or '.join(map(str, counts))} file arguments, "
                     f"got {len(ns.files)}")
    kw = {"device": ns.device}
    stream_kw = {k: getattr(ns, k) for k in STREAM_ARGS if getattr(ns, k) is not None}
    if ns.pipeline == "stream":
        if len(ns.files) == 3 and ns.files[2] not in STREAM_MODES:
            parser.error(f"stream MODE must be one of {'/'.join(STREAM_MODES)}, got {ns.files[2]!r}")
        kw.update({"crash_after_chunks" if k == "crash_after" else k: v
                   for k, v in stream_kw.items()})
    elif stream_kw:
        parser.error("--ckpt, --ckpt-every, --chunk-blocks and --crash-after apply to stream only")
    if ns.fast and ns.pipeline not in FAST:
        parser.error(f"--fast applies to {'/'.join(sorted(FAST))} only")
    if ns.verbose:
        if ns.pipeline not in VERBOSE:
            parser.error(f"--verbose applies to {'/'.join(VERBOSE)} only")
        kw["verbose"] = True
    if ns.pipeline in FAST:
        engines, default, compat = FAST[ns.pipeline]
        if ns.engine is not None and not engines:
            parser.error(f"{ns.pipeline} takes no --engine")
        if ns.fast:
            if ns.engine is not None and ns.engine not in engines:
                parser.error(f"{ns.pipeline} takes --engine {'/'.join(engines)}")
            kw["dtype"] = torch.float32
            engine = ns.engine or default
        elif ns.engine is not None:
            parser.error(f"{ns.pipeline} takes --engine with --fast only (compat mode is "
                         f"float64 {compat})")
        else:
            kw["dtype"] = torch.float64
            engine = compat
        if engines:
            kw["fft_engine"] = engine
    elif ns.engine is not None:
        parser.error(f"--engine applies with --fast to "
                     f"{'/'.join(sorted(p for p, (e, _, _) in FAST.items() if e))} only")
    PIPELINES[ns.pipeline](*ns.files, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
