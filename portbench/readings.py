"""The readings that set the limits of ``correct``, on the card, in one
process: for each seed, a run of the cell at its own load (``--seconds``
long) and its compared numbers, and the control's numbers on the same
inputs (the reference in the precision below the path's, in the program's
place).  One JSON line a seed.

    python3 -m portbench.readings --workload <cell> --seconds <s> --seeds <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    from portbench import run

    run.cache_env()
    from portbench import harness

    cell = harness.Cell(args.workload)
    control = () if args.no_control else (cell.config["paths"][cell.path]["control"],)
    for seed in args.seeds:
        t = time.perf_counter()
        res, checks, extra = harness.run_cell(cell, seed, args.seconds, controls=control)
        line = {"seed": seed, "correct": res["correct"], "failed": res["failed"],
                "attempted": res["attempted"],
                "numbers": extra.pop("numbers"),
                "control": {p_: {k: v["value"] for k, v in c.items()}
                            for p_, c in extra.pop("controls", {}).items()},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "driver": extra, "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
