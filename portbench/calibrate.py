"""Readings that a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds <n> \
        --first <seed> --seconds <s> [--control] [--out <file.jsonl>]

For each of ``--seeds`` seeds from ``--first`` on, one run of the cell
as run.py makes it (set-up, a window of ``--seconds`` at the cell's own
load, the check against the float64 reference), printing and appending
its numbers and each drawn row's gaps.  ``--control`` puts the
control in the program's place: the reference in float32 with TF32
matmuls, the nearest precision below the configuration's float32 with
TF32 off (harness.control_results); its readings must fail a limit.
The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 1
    cell = harness.resolve(harness.load_benchmark(), a.workload)
    arm = "control" if a.control else "program"
    for k in range(a.seeds):
        seed = a.first + k
        t0 = time.perf_counter()
        gaps = {}
        out = harness.run(cell, seed, a.seconds, False, control=a.control,
                          log=lambda *x: None, gaps=gaps)
        row = {"workload": a.workload, "arm": arm, "seed": seed,
               "correct": out["correct"], "attempted": out["attempted"],
               **out["readings"],
               "seconds": time.perf_counter() - t0, "gaps": gaps}
        print(json.dumps({k: v for k, v in row.items() if k != "gaps"}),
              flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
