"""Run one cell of the port's benchmark on this machine's card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, then ``driver`` and ``checks``); the last lines
of standard error give each number compared beside its limit.
"""

from __future__ import annotations

import time

T_PROC0 = time.perf_counter()  # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {"PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def cache_env(root=ROOT):
    """Every kernel cache at a fixed path inside the checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(root, ".portbench_cache", sub)
        os.makedirs(os.environ[var], exist_ok=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache_env()
    from portbench import harness

    return harness.main(args, T_PROC0)


if __name__ == "__main__":
    sys.exit(main())
