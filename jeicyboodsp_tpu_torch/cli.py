"""Command-line entry point of the port.

Usage::

    python -m jeicyboodsp_tpu_torch.cli wiener IN OUT
                                        [--fast [--engine xla|mxu|mxu3|mxu8|mxu8f|mxu8t]]
                                        [--device cuda]
    python -m jeicyboodsp_tpu_torch.cli specsub IN OUT [--fast [--engine ...]] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli geq IN OUT [--fast] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli nlms IN REF EST ERR [--device ...]
    python -m jeicyboodsp_tpu_torch.cli bnlms IN REF EST ERR [--device ...]
    python -m jeicyboodsp_tpu_torch.cli pitch2 IN [--fast [--engine xla|mxu|mxu3]] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli mfcc LISTFILE [--fast [--engine xla|mxu|mxu3|mxu8]]
    python -m jeicyboodsp_tpu_torch.cli fastconv IN OUT
                                        [--fast [--engine xla|gemm|gemm8|gemm8hq|mxu|mxu3]]
    python -m jeicyboodsp_tpu_torch.cli fft IN OUT [--verbose] [--fast]

    wiener IN OUT           Wiener noise suppression   (WienerFilter_final)
    specsub IN OUT          spectral subtraction       (SpectralSubtraction_final)
    geq IN OUT              7-band graphic EQ          (7Band_GEQ)
    nlms IN REF EST ERR     per-sample NLMS AEC        (NormalLMS)
    bnlms IN REF EST ERR    block NLMS AEC             (BNLMS)
    pitch1|pitch2|pitch3 IN pitch estimation, printed  (PitchEstimation_*)
    mfcc LISTFILE           corpus MFCC extraction     (MFCCFeatureExtraction...)
    fastconv IN OUT         RIR fast convolution       (Fast_Convolution...)
    fft IN OUT              radix-2 FFT roundtrip      (FFTAlgorithm_ver2)

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
         "fastconv": 2, "fft": 2}  # file arguments
FAST = {  # pipeline: the engines of --fast, its default engine, the compat engine
    **{p: (ALL_ENGINES, "xla", "xla") for p in ("wiener", "specsub")},
    **{f"pitch{m}": (("xla", "mxu", "mxu3"), "xla", "xla") for m in (1, 2, 3)},
    "mfcc": (("xla", "mxu", "mxu3", "mxu8"), "xla", "xla"),
    "fastconv": (FC.ENGINES, "auto", "xla"),
    "fft": ((), None, None),  # --fast is float32 only: no engine choice
    "geq": ((), None, None),
}


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
        "(its 3-term form, the default), mxu/mxu3 (four-step FFT kernel)",
    )
    parser.add_argument("--fast", action="store_true",
                        help=f"{'/'.join(sorted(FAST))} only: float32 (and --engine, but "
                        "for fft), instead of the float64 compat mode")
    parser.add_argument("--verbose", action="store_true",
                        help="fft only: the reference's operation-count lines "
                        "(FFTAlgorithm_ver2.cpp:148), twice per block, and its closing lines")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ns = parser.parse_args(argv)
    if len(ns.files) != FILES[ns.pipeline]:
        parser.error(f"{ns.pipeline} takes {FILES[ns.pipeline]} file arguments, "
                     f"got {len(ns.files)}")
    kw = {"device": ns.device}
    if ns.fast and ns.pipeline not in FAST:
        parser.error(f"--fast applies to {'/'.join(sorted(FAST))} only")
    if ns.verbose:
        if ns.pipeline != "fft":
            parser.error("--verbose applies to fft only")
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
