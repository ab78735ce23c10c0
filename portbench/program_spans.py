"""The program's own spans and counters, read beside the harness's trace.

The port records spans and counters while a torch.profiler profile
records (or_cdchomp_tpu_torch/utils/profiling.py): after a ``--trace 1``
run its recording holds those of every profile the run took, the traced
unit's last, and the node maps of the step graphs they replayed.  A
program without that recorder gives nothing: every function here then
returns None, and so does every reader built on them.

- :func:`align`: the program's spans on the profiler's clock.  Both the
  program's spans and the harness's (``tracing.Spans``) are taken on
  ``time.perf_counter``, and the harness's traced ranges are those spans
  moved onto the profiler's clock by one offset.  The newest top-level
  program spans are paired with the harness ranges of their calls
  (``HARNESS_OF``), each of which encloses its span; every pair bounds
  the offset from both ends, and the offset is the middle of what all
  the pairs allow.  The residual is the width of that interval: how far
  the two ends of the tightest pair leave the offset open.  Where no
  offset puts every span inside its range the pairing is wrong, and
  the alignment fails.
- :func:`recording`: the program's spans of the traced units (those
  under the paired top-level spans) and the counters counted under
  their requests, or None.  Durations and counts need no clock, so
  the residual does not limit them.
- :func:`idle_share`: each card's idle gaps inside a program span,
  charged to the innermost program span open at the gap's middle; None
  where the residual passes ``RESIDUAL_MAX_S``.  No metric reads it:
  the profile slows the host's launches (CUPTI's cost a graph node), so
  idle time charged to the host's spans in a traced run is the
  profile's own.
- :func:`replay_phase_ms`: a replayed step's device time per phase: the
  events of each complete replay of a node map found among a card's
  events in the traced solve, each charged to its node's phase.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import NamedTuple

from portbench import tracing

# the harness range (portbench/traffic.py) that encloses each top-level
# program span
HARNESS_OF = {"batch.build": "build", "batch.solve": "solve",
              "module.create": "create", "module.iterate": "iterate",
              "module.gettraj": "gettraj", "module.destroy": "destroy"}
RESIDUAL_MAX_S = 20e-6


class Traced(NamedTuple):
    """The program's record of the traced units: ``spans`` in the order
    they opened, ``counters`` {name: count} counted under their requests,
    ``offset`` (s) from perf_counter to the profiler's clock and the
    alignment's ``residual`` (s)."""

    spans: list
    counters: Counter
    offset: float
    residual: float


def _recorded():
    """The program's recording, or None where the program has no
    recorder or recorded no span."""
    try:
        from or_cdchomp_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "recorded", None)
    rec = get() if get is not None else None
    return rec if rec is not None and rec.spans else None


def align(trace, rec):
    """(offset, residual, {index of a paired top-level span: its harness
    range}) of a recording ``rec`` against the trace's harness ranges (see
    the module's docstring), or None where a harness range has no program
    span to pair or no offset fits every pair.  The traced unit ran last,
    so its top-level spans are the newest of their names."""
    if rec is None or not trace.ranges:
        return None
    ranges = defaultdict(list)
    for name, a, b in trace.ranges:
        ranges[name].append((a, b))
    tops = defaultdict(list)
    for i, s in enumerate(rec.spans):
        if s.parent < 0 and s.name in HARNESS_OF and s.end is not None:
            tops[s.name].append(i)
    lo, hi, paired = float("-inf"), float("inf"), {}
    for name, idx in tops.items():
        rs = ranges.get(HARNESS_OF[name], [])
        if len(rs) > len(idx):
            return None
        for i, (a, b) in zip(idx[len(idx) - len(rs):], rs):
            s = rec.spans[i]
            lo, hi = max(lo, a - s.start / 1e9), min(hi, b - s.end / 1e9)
            paired[i] = (a, b)
    if not paired or hi < lo:
        return None
    return 0.5 * (lo + hi), hi - lo, paired


def recording(trace):
    """The program's :class:`Traced` record of the trace's units, or None
    where the program recorded nothing, its spans do not align with the
    harness's ranges (align) or one of them falls outside the range of
    its top-level span."""
    rec = _recorded()
    al = align(trace, rec)
    if al is None:
        return None
    offset, residual, paired = al
    top, spans = {}, []
    for i, s in enumerate(rec.spans):
        top[i] = i if s.parent < 0 else top[s.parent]
        if top[i] not in paired or s.end is None:
            continue
        a, b = paired[top[i]]
        # 1 ns for the rounding of seconds on both clocks
        if not a - 1e-9 <= s.start / 1e9 + offset <= s.end / 1e9 + offset \
                <= b + 1e-9:
            return None
        spans.append(s)
    counters = Counter()
    for rid in {rec.spans[i].rid for i in paired}:
        counters.update(rec.by_request.get(rid, {}))
    return Traced(spans, counters, offset, residual)


def spans_named(rec, name):
    return [s for s in rec.spans if s.name == name and s.end is not None]


def seconds(rec, name):
    return [(s.end - s.start) / 1e9 for s in spans_named(rec, name)]


def per_unit_ms(rec, name, unit):
    """Host ms of the spans ``name`` over the number of ``unit`` spans
    (a batch's ``batch.build``, a request's ``module.create``), None
    without any ``unit``."""
    if rec is None:
        return None
    units = len(spans_named(rec, unit))
    return 1e3 * sum(seconds(rec, name)) / units if units else None


def per_unit_count(rec, names, unit):
    """The counters ``names`` summed, over the number of ``unit`` spans."""
    if rec is None:
        return None
    units = len(spans_named(rec, unit))
    return sum(rec.counters.get(n, 0) for n in names) / units if units \
        else None


def _intervals(events, lo, hi):
    """tracing.intervals of ``events`` clipped to (lo, hi)."""
    return [[max(s, lo), min(e, hi)] for s, e in tracing.intervals(events)
            if min(e, hi) > max(s, lo)]


def idle_share(trace, rec, outer, inner):
    """Percent of the cards' idle time inside the program spans ``outer``
    of a :class:`Traced` record ``rec`` during which the innermost
    program span open at the gap's middle is ``inner``; None without a
    record, with a residual over RESIDUAL_MAX_S or without idle time
    there."""
    if rec is None or rec.residual > RESIDUAL_MAX_S:
        return None
    spans = [(s.name, s.start / 1e9 + rec.offset, s.end / 1e9 + rec.offset)
             for s in rec.spans]
    total = charged = 0.0
    for card in trace.cards:
        events = trace.card_events(card)
        for name, lo, hi in spans:
            if name != outer:
                continue
            t = lo
            for s, e in _intervals(events, lo, hi) + [[hi, hi]]:
                if s > t:
                    mid = 0.5 * (t + s)
                    open_ = [(b - a, n) for n, a, b in spans if a <= mid <= b]
                    total += s - t
                    if open_ and min(open_)[1] == inner:
                        charged += s - t
                t = max(t, e)
    return 100.0 * charged / total if total > 0 else None


def kind_of(name):
    """"c" for a memcpy, "s" for a memset, "k" for a kernel.  A graph's
    memcpy node shows as "Memcpy DtoD (Device -> Device)" where a copy
    engine runs it and as CUDA's "memcpy32_post" kernel where an SM
    does (an H100 does either, process by process); memsets likewise."""
    low = name[:6].lower()
    return "c" if low == "memcpy" else "s" if low == "memset" else "k"


def kinds_of(events):
    """One letter an event (kind_of)."""
    return "".join(kind_of(e.name) for e in events)


def find_replays(events, kinds):
    """Start indices of the complete replays of a graph whose nodes have
    the kinds ``kinds`` (a NodeMap's) among ``events`` (one card's, in the
    order they ran): the run of ``len(kinds)`` events whose kinds match
    and whose names repeat the most times, not overlapping.  Empty where
    two different runs repeat equally often: a replay is never guessed.
    A replay that lost an event matches no run and is left out."""
    n = len(kinds)
    if not n or len(events) < n:
        return []
    ks = kinds_of(events)
    code = {}
    names = "".join(chr(0x100 + code.setdefault(e.name, len(code)))
                    for e in events)
    best, tie = (0, None), False
    seen = set()
    p = ks.find(kinds)
    while p >= 0:
        w = names[p:p + n]
        if w not in seen:
            seen.add(w)
            c = names.count(w)
            if c > best[0]:
                best, tie = (c, w), False
            elif c == best[0]:
                tie = True
        p = ks.find(kinds, p + 1)
    if best[1] is None or tie:
        return []
    out, p = [], names.find(best[1])
    while p >= 0:
        if ks.startswith(kinds, p):
            out.append(p)
        p = names.find(best[1], p + n)
    return out


def replays(rec):
    """{card: [NodeMap of each replay recorded there]}."""
    out = defaultdict(list)
    for s in spans_named(rec, "step.replay"):
        m = s.tag
        if m is not None and getattr(m, "kinds", None):
            out[m.device].append(m)
    return out


def replay_phase_ms(trace, rec, span="solve"):
    """{phase: device ms a replay} over the complete replays found among
    each card's events inside the harness span ``span`` (mean over the
    replays; "busy": the union of each replay's intervals), or None
    where no complete replay was found or more were found than recorded."""
    if rec is None or not trace.events:
        return None
    sums, found = defaultdict(float), 0
    for card, maps in replays(rec).items():
        events = sorted(trace.in_span(span, card), key=lambda e: e.start)
        for m in {m.key: m for m in maps}.values():
            recorded = sum(1 for x in maps if x.key == m.key)
            starts = find_replays(events, m.kinds)
            if len(starts) > recorded:
                return None
            per = m.per_node()
            for p in starts:
                block = events[p:p + m.nodes]
                for e, ph in zip(block, per):
                    sums[ph] += 1e3 * (e.end - e.start)
                sums["busy"] += 1e3 * tracing.busy_s(block)
            found += len(starts)
    if not found:
        return None
    return {k: v / found for k, v in sums.items()}


def phase_device_ms(trace, phases):
    """Device ms a replayed step spends in ``phases`` (summed), None where
    no replay was found or its map has none of them."""
    ms = replay_phase_ms(trace, recording(trace))
    if ms is None or not any(p in ms for p in phases):
        return None
    return sum(ms.get(p, 0.0) for p in phases)


def map_nodes(trace, phases, kind="k"):
    """Nodes of ``kind`` a replayed step has in ``phases`` (the mean over
    the traced replays' maps), None without any."""
    rec = recording(trace)
    if rec is None:
        return None
    maps = [m for ms in replays(rec).values() for m in ms]
    if not maps or not any(ph in phases for m in maps for ph, _ in m.phases):
        return None
    total = 0
    for m in maps:
        i = 0
        for ph, n in m.phases:
            if ph in phases:
                total += m.kinds[i:i + n].count(kind)
            i += n
    return total / len(maps)
