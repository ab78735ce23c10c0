"""One run of one cell: set-up, the measured window, the reading of the
trace, and the check.

Everything a cell needs is found by name from BENCHMARK.json: its
configuration's file, its mix (mixes/<traffic>.json), its limits
(limits/<workload>.json) and a reader per per-layer metric
(metrics/<metric>.py, a function ``read(trace)`` returning a number or
None).  A new cell, mix or metric is new files and entries only.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
TRACED_UNITS = 1         # units a --trace 1 run profiles after the window
TRACE_TRIES = 8          # profiles taken before a run gives up on markers
SETTLE_KERNELS = 8       # kernels a profile runs before and after its units
FORBIDDEN = ("jax", "jaxlib", "flax", "or_cdchomp_tpu", "benchmarks")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    row_gap: float        # the gap over which traj_rows_over counts a row
    end_to_end: list      # BENCHMARK.json entries that the cell reports
    per_layer: list


def load_benchmark(path=None):
    return json.loads(Path(path or CHECKOUT / "BENCHMARK.json").read_text())


def _reports(metric, name):
    return "workloads" not in metric or name in metric["workloads"]


def resolve(bench, workload):
    """The Cell of ``workload`` in the BENCHMARK.json dict ``bench``."""
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = json.loads((CHECKOUT / c["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, int(w["chips"]), cfg, mix, limits["limits"],
                float(limits["row_gap"]), e2e, per)


def reader(metric_name):
    """The ``read`` function of metrics/<metric_name>.py."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole)."""
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def percentile(xs, p):
    """The p-th percentile (0 < p < 100) of xs, by the inclusive
    method."""
    if len(xs) < 2:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[p - 1]


def shape(world, traffic):
    """The sizes the per-layer readers need: m moving points, S active
    and SI inactive spheres, P pairs, the field stack (F, mx, my, mz),
    the rows a card steps (B), the iterations and the float size."""
    eng = world.run.engine
    B = (traffic.parts[0][1] - traffic.parts[0][0]
         if hasattr(traffic, "parts") else 1)
    return dict(m=eng.spec.m, S=eng.n_spheres_active,
                SI=int(world.run.problem.inactive_pos.shape[0]),
                P=int(eng.pairs[0].shape[0]),
                fields=tuple(eng.fields.data.shape), B=B, n=eng.spec.n,
                n_iter=int(world.cfg["n_iter"]),
                itemsize=eng.fields.data.element_size())


def power_limits_w():
    """Each card's power limit in W as nvidia-smi reads it (roofline
    shares are against the peaks at 700 W); empty without nvidia-smi."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [float(x) for x in p.stdout.split()
            if x.replace(".", "", 1).isdigit()]


def _apply(cfg, overrides):
    """``cfg`` with ``overrides`` ({key: value}, "create.key" for
    create's) applied (the CPU tests shrink a cell so)."""
    cfg = copy.deepcopy(cfg)
    for k, v in (overrides or {}).items():
        if k.startswith("create."):
            cfg["create"][k[7:]] = v
        else:
            cfg[k] = v
    return cfg


def run(cell, seed, seconds, trace=False, *, t_start=None, device="cuda",
        control=False, config=None, mix=None, fault=None, log=None,
        gaps=None):
    """One run of ``cell``.  Returns the result dict (its last key
    ``checks``).  ``device`` "cpu", ``config`` and ``mix`` overrides and
    ``fault`` (a function returning a context manager entered around the
    window) serve the CPU tests; ``control`` judges the control in the
    program's place (``control_results``); ``gaps``, a dict if given,
    receives the drawn rows' gaps (correct.numbers)."""
    import contextlib

    import torch

    from portbench import correct, tracing, traffic as traffic_mod, world
    from portbench.reference import chomp as reference

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    # the configuration's float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _apply(cell.config, config)
    # off the card (the CPU tests) a replica of the device stands for each
    # of the cell's cards
    devices = ([torch.device("cuda", i) for i in range(cell.chips)]
               if device == "cuda" else [torch.device(device)] * cell.chips)
    spans = tracing.Spans()
    w = world.build(cfg, devices[0])
    tr = traffic_mod.make(w, dict(cell.mix, **(mix or {})), seed, spans,
                          devices)
    tr.warm()
    spans.items.clear()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    prof = None
    with fault() if fault is not None else contextlib.nullcontext():
        i = 0
        t0 = time.perf_counter()
        while i == 0 or time.perf_counter() - t0 < seconds:
            tr.unit(i)
            i += 1
        window = time.perf_counter() - t0
        problems = tr.problems
        if trace and device == "cuda":
            # after the window, so that the profile's cost falls outside it
            for k in range(TRACE_TRIES):
                prof, traced = _traced_units(
                    tr, spans, devices, i + k * TRACED_UNITS)
                try:
                    split = tracing.split_markers(
                        tracing.device_events(prof), *traced)
                    break
                except tracing.MarkersLost as e:
                    if k + 1 == TRACE_TRIES:
                        raise
                    log(f"profile {k + 1}: {e}; profiling more units")
    unit_s = tr.times[:i]
    log(f"window {window:.3f} s, {i} units, {problems} problems, unit ms "
        f"p50 {statistics.median(unit_s) * 1e3:.1f} p95 "
        f"{percentile(unit_s, 95) * 1e3:.1f} max {max(unit_s) * 1e3:.1f}")
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if device == "cuda" else 0)

    out, metrics = {}, {}
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(devices[0])
                         if device == "cuda" else device),
                "count": len(devices), "memory_peak_bytes": int(peak)}
    if not trace:
        avail = {"setup_s": setup_s, "solves_per_s": problems / window,
                 "plan_ms_p50": statistics.median(unit_s) * 1e3,
                 "plan_ms_p95": percentile(unit_s, 95) * 1e3}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": avail[m["name"]],
                                  "unit": m["unit"]}
    elif prof is not None:
        work, ranges, device_spans, traced_window = split
        t = tracing.Trace(spans, work, ranges, traced_window,
                          TRACED_UNITS * int(cfg["n_iter"]),
                          sorted({e.card for e in work}), shape(w, tr),
                          device_spans, TRACED_UNITS, list(unit_s))
        for m in cell.per_layer:
            v = reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = (sum(tracing.busy_s(t.card_events(c), *t.window)
                                  for c in t.cards) / len(t.cards))
        dev_info["window_s"] = t.window_s
        out["breakdown"] = tracing.breakdown(t)
        out["power_limit_w"] = power_limits_w()
        log(f"card power limits {out['power_limit_w']} W; traced units "
            f"{t.window_s * 1e3:.1f} ms, busy {dev_info['busy_s'] * 1e3:.1f} "
            f"ms")

    # the check, once the window has closed and the program's state is
    # freed: the reference on the same device, in float64
    rng = np.random.default_rng([seed % 2 ** 64, 2 ** 32 + 1])
    picks = tr.picks(rng)
    results = tr.results(picks)
    attempted = tr.problems
    start_cfg = np.asarray(cfg["robot"]["start"], np.float64)
    if control:
        results = control_results(cfg, devices[0], cell.mix["driver"],
                                  results, start_cfg)
    del tr, w, prof
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = correct.numbers(cell.mix["driver"],
                             reference.Solver(cfg, devices[0]), results,
                             start_cfg, cell.row_gap, gaps)
    ok, rows = correct.judge(values, cell.limits)
    log(f"check of {len(picks)} drawn results against the float64 "
        f"reference: {time.perf_counter() - t_check:.3f} s")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark must not "
                           f"load: {found}")
    for name, v, lim in rows:
        log(f"check {name} {v!r} limit {lim!r}")
    out.update({"correct": ok, "attempted": attempted, "failed": 0,
                "metrics": metrics, "device": dev_info, "readings": values})
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rows}
    return out


def control_results(cfg, device, kind, results, start_cfg):
    """The check's control in the program's place: the drawn rows'
    endpoints solved by the reference in the precision below the
    configuration's float32 with TF32 off, float32 with TF32 matmuls
    (and, in a plan cell, its own collision verdicts)."""
    import torch

    from portbench import correct
    from portbench.reference import chomp as reference

    starts, goals = results[0], results[1]
    torch.set_float32_matmul_precision("high")
    try:
        solver = reference.Solver(cfg, device, torch.float32)
        T, F = correct.reference_solve(solver, starts, goals)
    finally:
        torch.set_float32_matmul_precision("highest")
    T = T.astype(np.float64)
    last = (F.astype(np.float64) if kind == "batch"
            else solver.collides(T, start_cfg))
    return [starts, goals, T, last]


def _traced_units(tr, spans, devices, first):
    """TRACED_UNITS units from index ``first`` on under torch.profiler
    with CUDA activity alone, each span marked on the cards; returns the
    finished profile and (the spans' marks, the spans, the host window)
    of the traced units, whose spans leave ``spans``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _settle(devices)
        n0 = len(spans.items)
        spans.devices = devices
        t0 = time.perf_counter()
        for i in range(first, first + TRACED_UNITS):
            tr.unit(i)
        for d in devices:
            torch.cuda.synchronize(d)
        t1 = time.perf_counter()
        spans.devices = []
        _settle(devices)
    traced = (spans.marks, spans.items[n0:], (t0, t1))
    spans.marks = []
    del spans.items[n0:]
    return prof, traced


def _settle(devices):
    """SETTLE_KERNELS small kernels on each card, waited for.  A profile
    runs them before and after its units, outside the traced window: on
    an H100, of ten B = 10,240 batches profiled in turn in one process,
    eight lost the first span's first marker without them and none with
    them.  Four of those ten still lost a stretch of records at the
    solve's end (its last marker among them), so a run retakes such a
    profile (TRACE_TRIES)."""
    import torch

    for d in devices:
        x = torch.zeros(SETTLE_KERNELS, device=d)
        for _ in range(SETTLE_KERNELS):
            x.add_(1)
        torch.cuda.synchronize(d)
