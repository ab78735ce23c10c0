"""What the program's recorder costs: a cell's untraced units timed with
the program's ``profiling.recording()`` on and off, in turns, in one
process on the card.

    python3 portbench/recording_cost.py --workload table_mug.batch256 \
        --seed 2149500001 --pairs 12

Prints one JSON line: each arm's unit seconds, their medians and the
relative difference of the medians (on − off) / off, beside the card's
name and power limit; and, from the recorded units, each span's mean
host ms (mean and median over the units) and count a unit (the
untraced counterparts of the traced run's span readings).  The benchmark's own runs record nothing: recording
is on only while a profile records or inside ``recording()``.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2149500001)
    p.add_argument("--pairs", type=int, default=12)
    a = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from or_cdchomp_tpu_torch.utils import profiling
    from portbench import harness, tracing, traffic, world

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.resolve(harness.load_benchmark(), a.workload)
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    w = world.build(cell.config, devices[0])
    tr = traffic.make(w, cell.mix, a.seed, tracing.Spans(), devices)
    tr.warm()
    times = {"on": [], "off": []}
    spans, span_ms = [], {}
    i = 0
    for k in range(a.pairs):
        for arm in (("off", "on") if k % 2 == 0 else ("on", "off")):
            t0 = time.perf_counter()
            if arm == "on":
                with profiling.recording() as rec:
                    tr.unit(i)
                spans.append(len(rec.spans))
                for sp in rec.spans:
                    span_ms.setdefault(sp.name, []).append(sp.seconds * 1e3)
            else:
                tr.unit(i)
            times[arm].append(time.perf_counter() - t0)
            i += 1
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({
        "workload": a.workload, "card": torch.cuda.get_device_name(0),
        "power_limit_w": harness.power_limits_w(), "unit_s": times,
        "median_s": med, "spans_a_unit": statistics.median(spans),
        "on_vs_off": (med["on"] - med["off"]) / med["off"],
        "span_ms_mean": {k: statistics.fmean(v) for k, v in span_ms.items()},
        "span_ms_median": {k: statistics.median(v)
                           for k, v in span_ms.items()},
        "span_count": {k: len(v) / a.pairs for k, v in span_ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
