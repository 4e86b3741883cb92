"""Command-line entry point of the port.

Usage::

    python -m jeicyboodsp_tpu_torch.cli wiener IN OUT [--engine mxu8f|mxu8t|mxu8|mxu3] [--device cuda]
    python -m jeicyboodsp_tpu_torch.cli specsub IN OUT [--engine ...] [--device ...]

    wiener IN OUT     Wiener noise suppression   (WienerFilter_final)
    specsub IN OUT    spectral subtraction       (SpectralSubtraction_final)

The device defaults to the current CUDA card, and the command fails when
there is none; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from jeicyboodsp_tpu_torch.ops.enhance import ENGINES
    from jeicyboodsp_tpu_torch.pipelines import PIPELINES

    parser = argparse.ArgumentParser(
        prog="jeicyboodsp_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("pipeline", choices=sorted(PIPELINES))
    parser.add_argument("inp")
    parser.add_argument("out")
    parser.add_argument(
        "--engine", default="mxu8f", choices=ENGINES,
        help="mxu8f = int8 chain in one kernel, hq (~84 dB vs the reference); "
        "mxu8t = the same with a turbo inverse (~70 dB); "
        "mxu8 = int8 forward and back kernels around the latch (~84 dB); "
        "mxu3 = the same in f32 (the highest fidelity)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ns = parser.parse_args(argv)
    PIPELINES[ns.pipeline](ns.inp, ns.out, fft_engine=ns.engine, device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
