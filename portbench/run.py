"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  It builds the cell's world on the
card (or cards) from its configuration, warms the cell's one shape up
(set-up), runs the cell's traffic in a closed loop for ``--seconds``
(the window), checks what the window produced against the plain float64
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones, read from the window's host
spans and from a profile of one more unit after the window),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each
compared number beside its limit), which also end standard error.  It
exits non-zero with no result without enough CUDA cards, or where the
program or JAX would be missing or loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    # the host's numeric libraries on one thread each: the load comes from
    # one process with few threads, which keeps runs steady on a host
    # whose cores other machines share
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(k, "1")
    sys.path.insert(0, str(CHECKOUT))
    from portbench import harness

    bench = harness.load_benchmark()
    cell = harness.resolve(bench, a.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"run.py: {a.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 1
    try:
        import or_cdchomp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program is missing: {e}", file=sys.stderr)
        return 2
    out = harness.run(cell, a.seed, a.seconds, bool(a.trace),
                      t_start=T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
