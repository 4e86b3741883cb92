"""Command-line entry point of the port.

Usage::

    python -m jeicyboodsp_tpu_torch.cli wiener IN OUT [--engine mxu8f|mxu8t|mxu8|mxu3]
                                                [--device cuda]
    python -m jeicyboodsp_tpu_torch.cli specsub IN OUT [--engine ...] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli geq IN OUT [--device ...]
    python -m jeicyboodsp_tpu_torch.cli nlms IN REF EST ERR [--device ...]
    python -m jeicyboodsp_tpu_torch.cli bnlms IN REF EST ERR [--device ...]
    python -m jeicyboodsp_tpu_torch.cli pitch2 IN [--fast [--engine xla|mxu|mxu3]] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli mfcc LISTFILE [--fast [--engine xla|mxu|mxu3|mxu8]]

    wiener IN OUT           Wiener noise suppression   (WienerFilter_final)
    specsub IN OUT          spectral subtraction       (SpectralSubtraction_final)
    geq IN OUT              7-band graphic EQ          (7Band_GEQ)
    nlms IN REF EST ERR     per-sample NLMS AEC        (NormalLMS)
    bnlms IN REF EST ERR    block NLMS AEC             (BNLMS)
    pitch1|pitch2|pitch3 IN pitch estimation, printed  (PitchEstimation_*)
    mfcc LISTFILE           corpus MFCC extraction     (MFCCFeatureExtraction...)

pitch and mfcc run in float64 with the ``xla`` engine (torch.fft), the
reference's numbers, unless ``--fast`` asks for float32 and an ``--engine``:
``mxu`` runs pitch method 2 through the AMDF kernel and the other methods as
matmul DFTs; ``mxu3``/``mxu8`` run the MFCC DFT as f32 matmuls.

The device defaults to the current CUDA card, and the command fails when
there is none; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

import torch

FILES = {"wiener": 2, "specsub": 2, "geq": 2, "nlms": 4, "bnlms": 4,
         "pitch1": 1, "pitch2": 1, "pitch3": 1, "mfcc": 1}  # file arguments
ENHANCE = ("wiener", "specsub")
FEATURE_ENGINES = {**{f"pitch{m}": ("xla", "mxu", "mxu3") for m in (1, 2, 3)},
                   "mfcc": ("xla", "mxu", "mxu3", "mxu8")}  # the engines of --fast


def main(argv=None):
    from jeicyboodsp_tpu_torch.ops.enhance import ENGINES
    from jeicyboodsp_tpu_torch.pipelines import PIPELINES

    parser = argparse.ArgumentParser(
        prog="jeicyboodsp_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("pipeline", choices=sorted(PIPELINES))
    parser.add_argument("files", nargs="+")
    parser.add_argument(
        "--engine", default=None, choices=sorted({*ENGINES, *FEATURE_ENGINES["mfcc"]}),
        help="wiener/specsub: mxu8f = int8 chain in one kernel, hq (~84 dB vs the "
        "reference; the default); mxu8t = the same with a turbo inverse (~70 dB); "
        "mxu8 = int8 forward and back kernels around the latch (~84 dB); "
        "mxu3 = the same in f32 (the highest fidelity).  pitch*/mfcc with --fast: "
        "xla (torch.fft; the default), mxu (matmul DFT; AMDF kernel for pitch2), "
        "mxu3 and, for mfcc, mxu8 (both f32 matmul DFTs)",
    )
    parser.add_argument("--fast", action="store_true",
                        help="pitch*/mfcc only: float32 and --engine, instead of the "
                        "float64 xla compat mode")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ns = parser.parse_args(argv)
    if len(ns.files) != FILES[ns.pipeline]:
        parser.error(f"{ns.pipeline} takes {FILES[ns.pipeline]} file arguments, "
                     f"got {len(ns.files)}")
    kw = {"device": ns.device}
    if ns.fast and ns.pipeline not in FEATURE_ENGINES:
        parser.error(f"--fast applies to {'/'.join(sorted(FEATURE_ENGINES))} only")
    if ns.pipeline in ENHANCE:
        if ns.engine is not None and ns.engine not in ENGINES:
            parser.error(f"{ns.pipeline} takes --engine {'/'.join(ENGINES)}")
        kw["fft_engine"] = ns.engine or "mxu8f"
    elif ns.pipeline in FEATURE_ENGINES:
        if ns.fast:
            if ns.engine is not None and ns.engine not in FEATURE_ENGINES[ns.pipeline]:
                parser.error(f"{ns.pipeline} takes --engine "
                             f"{'/'.join(FEATURE_ENGINES[ns.pipeline])}")
            kw.update(dtype=torch.float32, fft_engine=ns.engine or "xla")
        elif ns.engine is not None:
            parser.error(f"{ns.pipeline} takes --engine with --fast only (compat mode is "
                         "float64 xla)")
        else:
            kw["dtype"] = torch.float64
    elif ns.engine is not None:
        parser.error(f"--engine applies to {'/'.join(ENHANCE)} and, with --fast, "
                     f"{'/'.join(sorted(FEATURE_ENGINES))} only")
    PIPELINES[ns.pipeline](*ns.files, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
