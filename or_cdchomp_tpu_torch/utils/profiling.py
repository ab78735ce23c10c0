"""Phase-level tracing and profiling (counterpart of
or_cdchomp_tpu/utils/profiling.py).

The reference accumulates per-phase CPU timers under DEBUG_TIMING with a
fixed taxonomy — vels / callback_pre (fk, jacobians, pre_velsaccs) /
callbacks (selfcol) / smoothgrad / smoothcost in the core (chomp.h:95-100,
orcdchomp_mod.cpp:954-958) — reported after iterate
(orcdchomp_mod.cpp:2835-2847).  Here the same taxonomy is expressed as:

 - ``phase(name)``: a ``torch.profiler.record_function`` range while a
   profiler records, and an NVTX range (``torch.cuda.nvtx``) once CUDA is
   initialised, so the phases appear in torch.profiler and Nsight traces.
   Neither syncs the device.
 - ``PhaseTimers``: host wall-clock accumulation for coarse phases (the
   SDF build, cache reads and writes) with the reference's report format.
 - ``phase_device_report``: time per phase from a finished torch.profiler
   run — device kernel time where the run recorded CUDA kernels, CPU op
   time otherwise — each kernel or op charged to the innermost phase
   around it (``phase_host_report``: the host time the same way).
   ``format_phase_report`` prints either in the reference's format.

The JAX package reads TPU compiler cycle estimates out of compiled HLO
text (``phase_cycle_report``); eager PyTorch has no such text, so that
parser has no counterpart here.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

# the reference phase taxonomy (chomp.h:95-100, orcdchomp_mod.h) plus
# the step sub-phases this build annotates (solver.step_batched,
# cost_soa.py)
PHASES = (
    "vels", "callback_pre", "fk", "jacobians", "pre_velsaccs",
    "callbacks", "obstacle", "selfcol", "jtmap", "smoothgrad",
    "constraint", "limits", "smoothcost",
)
# the ranges inside the SDF build (api.CHOMPModule._build_sdf_grid)
BUILD_PHASES = ("voxelize", "flood", "edt")


@contextlib.contextmanager
def phase(name: str):
    """Annotate a region.  A ``record_function`` costs a dispatcher call
    (~10 µs of host time) even with no profiler on, so it is entered only
    while one records; the NVTX range only once CUDA is initialised."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class PhaseTimers:
    """Host wall-clock per-phase accumulator with the reference's
    report format (orcdchomp_mod.cpp:2835-2847)."""

    def __init__(self):
        self.ticks = defaultdict(float)

    @contextlib.contextmanager
    def tic(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ticks[name] += time.perf_counter() - t0

    def report(self) -> str:
        lines = ["Time breakdown:"]
        for name in PHASES:
            if name in self.ticks:
                lines.append(f"  ticks_{name:<14s} {self.ticks[name]:.8f}")
        for name, v in self.ticks.items():
            if name not in PHASES:
                lines.append(f"  ticks_{name:<14s} {v:.8f}")
        return "\n".join(lines)


def capture_trace(dirname: str):
    """Context manager: profile the CPU and, where there is one, the card,
    and write a Chrome trace into ``dirname`` when it exits.

    Usage::

        with capture_trace('build/trace'):
            solver.iterate(probs, 100)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(dirname))


def _phase_of(evt, names=PHASES):
    """The innermost range of ``names`` around a CPU event (itself
    included), or "other"."""
    while evt is not None:
        if evt.name in names:
            return evt.name
        evt = evt.cpu_parent
    return "other"


# name prefixes of the launch calls the profiler records: the CUDA
# runtime's (cuda*) and the low-level cuLaunch* / cuMem* ones
_RUNTIME = ("cuda", "cuLaunch", "cuMem")


def _cpu_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type != cuda and not e.is_async]


def phase_host_report(prof, names=PHASES) -> dict:
    """{phase: host ms} from a finished torch.profiler run: each CPU
    event's self time (its duration less its children's) charged to the
    innermost range of ``names`` around it, so the phases add up to the
    recorded host time; time outside every phase goes under "other"."""
    out = defaultdict(float)
    for e in _cpu_events(prof):
        out[_phase_of(e, names)] += e.self_cpu_time_total / 1e3
    return dict(out)


def phase_kernels(prof, names=PHASES):
    """[(kernel name, phase, device µs)] of every device kernel (or memcpy,
    memset) a finished torch.profiler run recorded, each charged to the
    innermost range of ``names`` open on the host when the runtime call
    that launched it (``cudaLaunchKernel``, a ctypes launch's too) began;
    "other" if none was, or if the launch was not recorded.  A kernel
    shares its id with its runtime call (the CUDA correlation id).  Times
    are compared, not threads: the ranges and the launches are taken to
    come from one host thread, as the solver's do."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = _cpu_events(prof)
    # latest start first: the first range that holds a time is innermost
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in cpu if e.name in names), reverse=True)
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith(_RUNTIME)}
    out = []
    for e in prof.events():
        if e.device_type != cuda or e.name in names \
                or getattr(e, "is_user_annotation", False):
            continue
        t, ph = launch.get(e.id), "other"
        if t is not None:
            ph = next((n for s, end, n in ranges if s <= t <= end), "other")
        out.append((e.name, ph, e.device_time))
    return out


def phase_device_report(prof, names=PHASES) -> dict:
    """{phase: ms} from a finished torch.profiler run (the counterpart of
    ``phase_cycle_report``): the device time of the kernels each phase
    launched where the run recorded any (``phase_kernels``), else the CPU
    op time (``phase_host_report``).  A kernel is charged to the
    innermost phase, as the JAX package charges "the deepest
    (last-occurring) phase"; time outside every phase goes under
    "other".  ``names`` are the ranges that count (``BUILD_PHASES`` for
    the SDF build).  Sums what the profiler recorded: a lost kernel event
    reads as time not spent."""
    kern = phase_kernels(prof, names)
    if not kern:
        return phase_host_report(prof, names)
    out = defaultdict(float)
    for _, ph, us in kern:
        out[ph] += us / 1e3
    return dict(out)


def format_phase_report(ms: dict, what: str = "device ms") -> str:
    """Reference-style report (orcdchomp_mod.cpp:2835-2847) from a
    phase → ms dict; ``what`` names the time in the header."""
    total = sum(ms.values()) or 1.0
    lines = [f"Per-step phase breakdown ({what}):"]
    order = [p for p in PHASES if p in ms] + [p for p in ms
                                               if p not in PHASES]
    for name in order:
        c = ms[name]
        lines.append(f"  ticks_{name:<14s} {c:>12.6f} ({100.0 * c / total:5.1f}%)")
    return "\n".join(lines)
