"""The benchmark's spans and its reading of torch.profiler's device trace.

``Spans`` times the benchmark's calls into each layer on the host clock
(every unit of the window).  The traced units are profiled with CUDA
activity alone (no host operator is recorded, so the profile adds little
to the host's work); while it records, each span also launches a marker
kernel on every card at its start and at its end.  A marker runs in
stream order, so a span's pair of markers on a card delimits the device
work the span enqueued there, and the first marker, launched on an idle
card, maps the host clock onto the profiler's.  ``Trace`` is what the
per-layer readers (metrics/<name>.py) are handed.

``device_events`` and ``busy_s`` are chip_smoke.py's ``device_events`` /
``busy_ms``: any range's GPU-side copy is left out (it would span
the kernels it holds), and busy time is the union of the intervals.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

MARKER = "spin_kernel"   # the kernel torch.cuda._sleep launches


class MarkersLost(RuntimeError):
    """The profile holds fewer (or more) markers than were launched."""


class Spans:
    """Host spans (name, start s, end s) on time.perf_counter."""

    def __init__(self):
        self.items = []
        self.devices = []        # cards to mark each span on (while traced)
        self.marks = []          # (span name, "begin" | "end", card, host s)

    def _mark(self, name, edge):
        import torch

        for d in self.devices:
            with torch.cuda.device(d):
                self.marks.append((name, edge, d.index, time.perf_counter()))
                torch.cuda._sleep(0)

    @contextlib.contextmanager
    def __call__(self, name):
        self._mark(name, "begin")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._mark(name, "end")
            self.items.append((name, t0, t1))

    def durations(self, name):
        """Seconds of every span called ``name``."""
        return [b - a for n, a, b in self.items if n == name]


@dataclasses.dataclass
class Event:
    name: str
    start: float          # seconds on the profiler's clock
    end: float
    card: int


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads.

    ``spans``: the host spans of every unit of the window; ``events``:
    the device events of the traced units, on ``cards`` (the markers
    left out); ``ranges``: the host spans of the traced units on the
    profiler's clock; ``device_spans``: {card: [(name, start, end)]},
    the device work each traced span enqueued on a card, between its
    markers; ``window``: (start, end) of the traced units on the
    profiler's clock; ``steps``: solver steps a card ran in the traced
    units; ``shape``: the cell's sizes (see harness.shape); ``units``:
    how many units were traced; ``unit_s``: the host seconds of each
    unit of the (untraced) window."""

    spans: Spans
    events: list
    ranges: list
    window: tuple
    steps: int
    cards: list
    shape: dict
    device_spans: dict = dataclasses.field(default_factory=dict)
    units: int = 1
    unit_s: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def card_events(self, card):
        return [e for e in self.events if e.card == card]

    def in_span(self, name, card):
        """The card's events that start inside the device work of a
        traced span called ``name``."""
        iv = [(a, b) for n, a, b in self.device_spans.get(card, ())
              if n == name]
        return [e for e in self.card_events(card)
                if any(a <= e.start < b for a, b in iv)]

    def kernels(self, pattern=None):
        """Kernel events (no memcpy or memset), those whose name matches
        the regular expression ``pattern`` if given."""
        import re
        out = [e for e in self.events
               if not e.name.startswith(("Memcpy", "Memset"))]
        if pattern is not None:
            out = [e for e in out if re.search(pattern, e.name)]
        return out


def device_events(prof):
    """The device work of a finished profile as Events: kernels, memcpys
    and memsets, without any range's GPU-side copy."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6,
                  e.device_index)
            for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def split_markers(events, marks, items, host_window):
    """(work events within the window, host ranges, device spans,
    window) of a traced stretch: ``events`` its device events, ``marks``
    and ``items`` the Spans' markers and spans launched in it,
    ``host_window`` its (start, end) on the host clock.  Each card's
    marker events pair in order with its launches; the first launch (on
    an idle card) gives the offset from the host clock to the
    profiler's."""
    work = [e for e in events if MARKER not in e.name]
    found = sorted((e for e in events if MARKER in e.name),
                   key=lambda e: e.start)
    by_card = defaultdict(list)
    for e in found:
        by_card[e.card].append(e)
    launched = defaultdict(list)
    for m in marks:
        launched[m[2]].append(m)
    if {c: len(v) for c, v in by_card.items()} != \
            {c: len(v) for c, v in launched.items()}:
        raise MarkersLost(
            f"marker kernels: {sum(map(len, launched.values()))} launched, "
            f"{len(found)} traced ({sorted({e.name for e in found})})")
    first = min(marks, key=lambda m: m[3])
    offset = by_card[first[2]][0].start - first[3]
    device_spans = {}
    for card, ms in launched.items():
        open_, out = {}, []
        for (name, edge, _, _), e in zip(ms, by_card[card]):
            if edge == "begin":
                open_.setdefault(name, []).append(e.start)
            else:
                out.append((name, open_[name].pop(), e.start))
        device_spans[card] = out
    ranges = [(n, a + offset, b + offset) for n, a, b in items]
    window = (host_window[0] + offset, host_window[1] + offset)
    work = [e for e in work if e.end > window[0] and e.start < window[1]]
    return work, ranges, device_spans, window


def intervals(events):
    """The union of the events' intervals, as sorted disjoint (start,
    end) pairs."""
    out = []
    for s, e in sorted((e.start, e.end) for e in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(events, lo=float("-inf"), hi=float("inf")):
    """Seconds in which some event ran (the union of their intervals),
    within (lo, hi) if given."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in intervals(events))


def mean_span_ms(trace, name):
    """Host ms of the spans called ``name``, the mean over every unit of
    the window; None where there is none."""
    d = trace.spans.durations(name)
    return 1e3 * sum(d) / len(d) if d else None


def idle_pct(trace):
    """Percent of a unit of the window in which a card runs nothing: 100
    × (1 − a traced unit's busy time on the card / the mean host time of
    the window's units), the largest over the cards; None without device
    events or untraced units.  The busy time is the trace's; the time of
    a unit is the untraced window's, since the profile slows the host's
    launches of the step graph and would read idle time that the timed
    path does not have."""
    if not trace.events or not trace.unit_s:
        return None
    lo, hi = trace.window
    unit = sum(trace.unit_s) / len(trace.unit_s)
    return max(100.0 * (1.0 - busy_s(trace.card_events(c), lo, hi)
                        / trace.units / unit) for c in trace.cards)


def breakdown(trace, top=10):
    """The traced window's ``device_ops`` (the device operations that
    took most time, summed over cards) and ``idle_gaps`` (each card's
    idle time, within the window, charged to the innermost host span
    open at its middle, or "host" outside every span), seconds, the
    largest first."""
    ops = defaultdict(float)
    for e in trace.events:
        ops[e.name] += e.end - e.start
    gaps = defaultdict(float)
    lo, hi = trace.window
    for card in trace.cards:
        t = lo
        for s, e in intervals(trace.card_events(card)) + [[hi, hi]]:
            s, e = max(s, lo), min(e, hi)
            if s > t:
                mid = 0.5 * (t + s)
                open_ = [r for r in trace.ranges if r[1] <= mid <= r[2]]
                name = (min(open_, key=lambda r: r[2] - r[1])[0] if open_
                        else "host")
                gaps[name] += s - t
            t = max(t, e)

    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": first(ops), "idle_gaps": first(gaps)}
