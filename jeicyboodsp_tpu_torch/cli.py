"""Command-line entry point of the port.

Usage::

    python -m jeicyboodsp_tpu_torch.cli wiener IN OUT [--engine mxu8f|mxu8t|mxu8|mxu3]
                                                [--device cuda]
    python -m jeicyboodsp_tpu_torch.cli specsub IN OUT [--engine ...] [--device ...]
    python -m jeicyboodsp_tpu_torch.cli geq IN OUT [--device ...]
    python -m jeicyboodsp_tpu_torch.cli nlms IN REF EST ERR [--device ...]
    python -m jeicyboodsp_tpu_torch.cli bnlms IN REF EST ERR [--device ...]

    wiener IN OUT           Wiener noise suppression   (WienerFilter_final)
    specsub IN OUT          spectral subtraction       (SpectralSubtraction_final)
    geq IN OUT              7-band graphic EQ          (7Band_GEQ)
    nlms IN REF EST ERR     per-sample NLMS AEC        (NormalLMS)
    bnlms IN REF EST ERR    block NLMS AEC             (BNLMS)

The device defaults to the current CUDA card, and the command fails when
there is none; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

FILES = {"wiener": 2, "specsub": 2, "geq": 2, "nlms": 4, "bnlms": 4}  # file arguments
ENHANCE = ("wiener", "specsub")


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
        "--engine", default=None, choices=ENGINES,
        help="wiener/specsub only: mxu8f = int8 chain in one kernel, hq (~84 dB vs the "
        "reference; the default); mxu8t = the same with a turbo inverse (~70 dB); "
        "mxu8 = int8 forward and back kernels around the latch (~84 dB); "
        "mxu3 = the same in f32 (the highest fidelity)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ns = parser.parse_args(argv)
    if len(ns.files) != FILES[ns.pipeline]:
        parser.error(f"{ns.pipeline} takes {FILES[ns.pipeline]} file arguments, "
                     f"got {len(ns.files)}")
    kw = {"device": ns.device}
    if ns.pipeline in ENHANCE:
        kw["fft_engine"] = ns.engine or "mxu8f"
    elif ns.engine is not None:
        parser.error(f"--engine applies to {'/'.join(ENHANCE)} only")
    PIPELINES[ns.pipeline](*ns.files, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
