"""The port's recorder of spans and counters, and its phase profiling
(counterpart of or_cdchomp_tpu/utils/profiling.py).

The reference accumulates per-phase CPU timers under DEBUG_TIMING with a
fixed taxonomy — vels / callback_pre (fk, jacobians, pre_velsaccs) /
callbacks (selfcol) / smoothgrad / smoothcost in the core (chomp.h:95-100,
orcdchomp_mod.cpp:954-958) — reported after iterate
(orcdchomp_mod.cpp:2835-2847).  Here:

 - ``phase(name)`` is the span primitive.  While something records (a
   torch.profiler profile, or a :func:`recording` context), a span keeps
   its name, its start and end on ``time.perf_counter_ns``, its parent
   span and the id of the request or batch it belongs to (a top-level
   span starts one; a child takes its parent's), and is also a
   ``torch.profiler.record_function`` range while a profiler records and
   an NVTX range once CUDA is initialised.  Neither syncs the device.
   With nothing recording a span costs one flag test and allocates
   nothing.  ``count(name)`` adds to a named integer the same way;
   ``host_sync`` counts each place where the host waits on the card
   (``to_device``, ``to_host`` and the ``.tolist()`` / ``bool(tensor)``
   sites that call it).
 - A recording gathers the spans and counters of every profile since
   the last :func:`recording` context was entered where nothing
   recorded (that context starts a new one); :func:`recorded` returns
   it, to be read once the profile has ended.  A reader picks the spans
   of the stretch it reads by their clock, and a counter by the request
   it was counted under (``Recording.by_request``).
 - ``node_map``: while a step is captured into a CUDA graph
   (chomp/solver.py ``StepGraph``), the graph's nodes are counted at each
   phase's edges, so every node that a profiler reports (kernel, memcpy,
   memset) is charged to the innermost phase open when it was captured.
   The map (:class:`NodeMap`) goes with the graph and, at each recorded
   replay, into the recording.  It adds no node to the graph.
 - ``PhaseTimers``: host walls per coarse phase (the SDF build, cache
   reads and writes), each ``tic`` a span timed whether or not anything
   records (and recorded where something does), with the reference's
   report format.
 - ``phase_device_report``: time per phase from a finished torch.profiler
   run — device kernel time where the run recorded CUDA kernels, CPU op
   time otherwise — each kernel or op charged to the innermost phase
   around it, a replayed graph's kernels by its node map
   (``phase_host_report``: the host time the same way).
   ``format_phase_report`` prints either in the reference's format.

The JAX package reads TPU compiler cycle estimates out of compiled HLO
text (``phase_cycle_report``); eager PyTorch has no such text, so that
parser has no counterpart here.  Spans and counters come from one host
thread, as the solver's do.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
import weakref
from collections import Counter, defaultdict
from typing import NamedTuple, Optional

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
# what a CUDA graph node is, for a profiler: kernel, memcpy, memset
NODE_KINDS = "kcs"

_profiler_enabled = torch.autograd._profiler_enabled
_ids = itertools.count(1)


class Recording:
    """The spans and counters of one profile or :func:`recording`.

    ``spans``: every :class:`Span` in the order they opened (a span's
    ``parent`` is its parent's index here, -1 at the top level);
    ``counters``: {name: count}; ``by_request``: {request id: Counter},
    the same counts by the request of the innermost span open when they
    were counted (None outside every span); ``node_maps``: {key:
    NodeMap} of the step graphs replayed while it recorded."""

    def __init__(self):
        self.spans = []
        self.counters = Counter()
        self.by_request = defaultdict(Counter)
        self.node_maps = {}
        self._open = []               # indices of the open spans
        self._bound = {}              # id(obj) -> (weakref, request id)

    def named(self, name):
        """The spans called ``name``, in order."""
        return [s for s in self.spans if s.name == name]

    def top_level(self):
        return [s for s in self.spans if s.parent < 0]

    def children(self, span):
        i = self.spans.index(span)
        return [s for s in self.spans if s.parent == i]

    def _push(self, span):
        parent = self._open[-1] if self._open else -1
        span.parent = parent
        if span.rid is None:
            span.rid = self.spans[parent].rid if parent >= 0 else next(_ids)
        if isinstance(span.tag, NodeMap):
            self.node_maps[span.tag.key] = span.tag
        self._open.append(len(self.spans))
        self.spans.append(span)

    def _pop(self, span):
        # the innermost open span is this one, unless a span was entered
        # and left out of order; drop back to it either way
        i = len(self._open) - 1
        while i >= 0 and self.spans[self._open[i]] is not span:
            i -= 1
        if i >= 0:
            del self._open[i:]


_rec = Recording()     # the recording in progress
_explicit = 0          # depth of recording() contexts
_builder = None        # the node map of a step being captured, or None
_forced = False        # _explicit or _builder: spans are made anyway


def _update_forced():
    global _forced
    _forced = bool(_explicit) or _builder is not None


def recording_now():
    """Whether spans and counters are being recorded (one flag test)."""
    return bool(_explicit) or _profiler_enabled()


def recorded():
    """The recording in progress: the spans and counters of the profiles
    since the last outermost :func:`recording` context began, and that
    context's own."""
    return _rec


@contextlib.contextmanager
def recording():
    """Record spans and counters while entered, whether or not a profile
    records (an operator's switch).  Entered where nothing records, it
    starts a new recording; inside a profile or another recording it adds
    to the one in progress.  Yields the recording."""
    global _explicit, _rec
    if not recording_now():
        _rec = Recording()
    _explicit += 1
    _update_forced()
    try:
        yield _rec
    finally:
        _explicit -= 1
        _update_forced()


class Span:
    """One recorded span (and the context manager that records it):
    ``name``, ``start`` and ``end`` (ns, ``time.perf_counter_ns``),
    ``parent`` (index in the recording, -1 at the top level), ``rid`` (the
    request or batch id) and ``tag`` (a replay's :class:`NodeMap`)."""

    __slots__ = ("name", "rid", "tag", "start", "end", "parent", "_rec",
                 "_rf", "_nvtx")

    def __init__(self, name, rid=None, tag=None):
        self.name, self.rid, self.tag = name, rid, tag
        self.start = self.end = None
        self.parent = -1
        self._rec = self._rf = None
        self._nvtx = False

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9

    def __repr__(self):
        ms = None if self.end is None else round(self.seconds * 1e3, 6)
        return (f"Span({self.name!r}, rid={self.rid}, parent={self.parent}, "
                f"ms={ms})")

    def __enter__(self):
        if _builder is not None:
            _builder.edge(self.name, True)
        if recording_now():
            # the span holds its own ranges' cost: a caller's clock read
            # just outside it and its start agree to a few µs
            if self.start is None:
                self.start = time.perf_counter_ns()
            self._rec = _rec
            _rec._push(self)
            if _profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
            if torch.cuda.is_initialized():
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            if self._nvtx:
                torch.cuda.nvtx.range_pop()
            if self._rf is not None:
                self._rf.__exit__(*exc)
            self._rec._pop(self)
            self._rec = self._rf = None
            self.end = time.perf_counter_ns()
        if _builder is not None:
            _builder.edge(self.name, False)
        return False


_OFF = contextlib.nullcontext()


def phase(name: str, rid=None, tag=None):
    """A span called ``name`` (``rid``: the request or batch it belongs
    to, by default its parent's or, at the top level, a new one; ``tag``:
    a replay's NodeMap).  With nothing recording and no graph being
    captured, a shared null context: one flag test, no allocation.  As a
    context manager it yields the Span (None when nothing records)."""
    if _forced or _profiler_enabled():
        return Span(name, rid, tag)
    return _OFF


def command(name: str, rid=None):
    """Decorate a function as the top-level span ``name`` of a layer's
    entry point (a module command, a batch build or solve).  Its clock
    reads are the call's first and last statements, so a caller's clock
    read around the call brackets the span within a few µs.  ``rid``, a
    function of the call's arguments, gives the request it belongs to (by
    default a new one)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not (_forced or _profiler_enabled()):
                return fn(*args, **kw)
            t = time.perf_counter_ns()
            span = Span(name, None if rid is None else rid(*args, **kw))
            span.start = t
            with span:
                return fn(*args, **kw)
        return call
    return wrap


def current_request():
    """The request id of the innermost open span, None where none is
    open or nothing records."""
    if not recording_now() or not _rec._open:
        return None
    return _rec.spans[_rec._open[-1]].rid


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while something records, and to
    the count of the request of the innermost open span."""
    if _explicit or _profiler_enabled():
        _rec.counters[name] += n
        rid = _rec.spans[_rec._open[-1]].rid if _rec._open else None
        _rec.by_request[rid][name] += n


def host_sync(n: int = 1):
    """Count ``n`` places where the host waits on the card."""
    count("host_sync", n)


def to_device(x, **kw):
    """``torch.as_tensor(x, **kw)`` onto the module's device, counting a
    host sync where it copies host data (numpy, Python numbers, a CPU
    tensor) that is not empty: on a card such a copy waits for it."""
    t = torch.as_tensor(x, **kw)
    if (not isinstance(x, torch.Tensor) or x.device.type == "cpu") \
            and t.numel():
        count("host_sync")
    return t


def to_host(t):
    """``t.cpu()`` of a tensor on the module's device, counting a host
    sync where it is not empty."""
    if t.numel():
        count("host_sync")
    return t.cpu()


def bind(obj, rid):
    """Make ``rid`` the request id of ``obj`` (an object that stands for
    the request, such as a batch's trajectory tensor), for
    :func:`request_of`.  Nothing while nothing records."""
    if rid is not None and recording_now():
        _rec._bound[id(obj)] = (weakref.ref(obj), rid)


def request_of(obj):
    """The request id :func:`bind` gave ``obj``, else None."""
    if not recording_now():
        return None
    ref, rid = _rec._bound.get(id(obj), (None, None))
    return rid if ref is not None and ref() is obj else None


# -- the replayed step's phases -------------------------------------------

class NodeMap(NamedTuple):
    """The phases of a captured step graph's nodes: ``phases`` ((phase,
    nodes), ...) runs in capture order (which is the order the nodes run
    in: the captured graph is one chain) of the nodes a profiler reports,
    each charged to the innermost ``PHASES`` phase open when it was
    captured ("other" outside them); ``kinds`` one letter a node, "k"
    kernel, "c" memcpy, "s" memset; ``device`` the card's index."""

    key: int
    device: Optional[int]
    phases: tuple
    kinds: str

    @property
    def nodes(self):
        return len(self.kinds)

    def per_node(self):
        """The phase of each node, in order."""
        return [ph for ph, n in self.phases for _ in range(n)]


class _MapBuilder:
    """Counts a capture's nodes at each phase edge.  ``count_nodes(False)``
    returns the nodes captured so far, ``count_nodes(True)`` one letter a
    node in capture order (NODE_KINDS for those a profiler reports); a
    RuntimeError from it leaves the capture without a map."""

    def __init__(self, count_nodes, device=None):
        self.count_nodes = count_nodes
        self.device = device
        self.stack = []
        self.edges = []     # (nodes so far, innermost phase from then on)
        self.failed = False

    def edge(self, name, opening):
        if name not in PHASES or self.failed:
            return
        try:
            n = self.count_nodes(False)
        except RuntimeError:
            self.failed = True
            return
        if opening:
            self.stack.append(name)
        elif self.stack and self.stack[-1] == name:
            self.stack.pop()
        self.edges.append((n, self.stack[-1] if self.stack else "other"))

    def finish(self):
        """The NodeMap of the capture so far, or None where its nodes
        could not be read."""
        if self.failed:
            return None
        try:
            kinds = self.count_nodes(True)
        except RuntimeError:
            return None
        runs, cur, j = [], "other", 0
        for i, kind in enumerate(kinds):
            while j < len(self.edges) and self.edges[j][0] <= i:
                cur = self.edges[j][1]
                j += 1
            if kind not in NODE_KINDS:
                continue
            if runs and runs[-1][0] == cur:
                runs[-1][1] += 1
            else:
                runs.append([cur, 1])
        return NodeMap(next(_ids), self.device,
                       tuple((ph, k) for ph, k in runs),
                       "".join(k for k in kinds if k in NODE_KINDS))


@contextlib.contextmanager
def node_map(count_nodes, device=None):
    """Around a graph's capture: counts its nodes (``count_nodes(False)``,
    see _MapBuilder) at each phase's edges.  Yields the builder; its
    ``finish()``, called before the capture ends, makes the
    :class:`NodeMap` (None where the nodes could not be read)."""
    global _builder
    saved, _builder = _builder, _MapBuilder(count_nodes, device)
    _update_forced()
    try:
        yield _builder
    finally:
        _builder = saved
        _update_forced()


# -- the reference's report formats ---------------------------------------

class PhaseTimers:
    """Host wall-clock per phase with the reference's report format
    (orcdchomp_mod.cpp:2835-2847).  Each ``tic`` is a span, timed
    whether or not anything records and added to the recording where
    something does; ``ticks`` sums the seconds of the spans it timed,
    and ``spans`` keeps them."""

    def __init__(self):
        self.ticks = defaultdict(float)
        self.spans = []

    @contextlib.contextmanager
    def tic(self, name: str):
        span = Span(name)
        span.start = time.perf_counter_ns()
        try:
            with span:
                yield
        finally:
            if span.end is None:
                span.end = time.perf_counter_ns()
            self.spans.append(span)
            self.ticks[name] += span.seconds

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
_GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


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


def replay_phases(n_events, maps):
    """The phase of each of a replay's ``n_events`` events (in the order
    they ran) by the node map that has that many nodes; None where no map
    does, or where maps of that size disagree: a replay that lost an
    event reads nothing rather than a guess."""
    found = {m.phases for m in maps if m.nodes == n_events}
    if len(found) != 1:
        return None
    return [ph for ph, n in found.pop() for _ in range(n)]


def phase_kernels(prof, names=PHASES, maps=None):
    """[(kernel name, phase, device µs)] of every device kernel (or memcpy,
    memset) a finished torch.profiler run recorded, each charged to the
    innermost range of ``names`` open on the host when the runtime call
    that launched it (``cudaLaunchKernel``, a ctypes launch's too) began;
    "other" if none was, or if the launch was not recorded.  A kernel
    shares its id with its runtime call (the CUDA correlation id).  Times
    are compared, not threads: the ranges and the launches are taken to
    come from one host thread, as the solver's do.

    The kernels of a replayed CUDA graph share the id of its
    ``cudaGraphLaunch``: they take their phases, in the order they ran,
    from the node map of that many nodes (``maps``, by default those of
    the recording in progress), and phase None where no map fits."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = _cpu_events(prof)
    # latest start first: the first range that holds a time is innermost
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in cpu if e.name in names), reverse=True)
    launch = {e.id: e.time_range.start for e in cpu
              if e.name.startswith(_RUNTIME)}
    graph = {e.id for e in cpu if e.name.startswith(_GRAPH_LAUNCH)}
    maps = list(recorded().node_maps.values() if maps is None else maps)
    out, replays = [], defaultdict(list)
    for e in prof.events():
        if e.device_type != cuda or e.name in names \
                or getattr(e, "is_user_annotation", False):
            continue
        if e.id in graph:
            replays[e.id].append(e)
            continue
        t, ph = launch.get(e.id), "other"
        if t is not None:
            ph = next((n for s, end, n in ranges if s <= t <= end), "other")
        out.append((e.name, ph, e.device_time))
    for evs in replays.values():
        evs.sort(key=lambda e: e.time_range.start)
        phs = replay_phases(len(evs), maps) or [None] * len(evs)
        out += [(e.name, ph if ph is None or ph in names else "other",
                 e.device_time) for e, ph in zip(evs, phs)]
    return out


def phase_device_report(prof, names=PHASES, maps=None):
    """{phase: ms} from a finished torch.profiler run (the counterpart of
    ``phase_cycle_report``): the device time of the kernels each phase
    launched where the run recorded any (``phase_kernels``, a replayed
    graph's by its node map), else the CPU op time
    (``phase_host_report``).  A kernel is charged to the innermost phase,
    as the JAX package charges "the deepest (last-occurring) phase"; time
    outside every phase goes under "other".  ``names`` are the ranges
    that count (``BUILD_PHASES`` for the SDF build).  Sums what the
    profiler recorded: a lost kernel event reads as time not spent, but a
    replay that lost one matches no node map and makes the report None."""
    kern = phase_kernels(prof, names, maps)
    if not kern:
        return phase_host_report(prof, names)
    if any(ph is None for _, ph, _ in kern):
        return None
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
