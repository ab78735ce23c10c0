"""CPU tests of the readers of the program's own spans and counters
(portbench/program_spans.py and the metrics built on it), on made-up
recordings and traces: the alignment of the program's spans to the
harness's ranges and its 20 µs residual, the traced unit's spans and
counters kept apart from an earlier profile's, the split of a replay's
events by the step graph's node map (and nothing read where a replay
lost an event), idle time charged to the innermost program span, and
every new reader's None where the program records nothing.

    python -m pytest portbench/tests/test_program_spans.py -q
"""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from portbench import harness, program_spans, tracing  # noqa: E402
from or_cdchomp_tpu_torch.utils import profiling  # noqa: E402

NEW = ("fk_ms.batch", "fk_kernels.batch", "smooth_ms.batch",
       "constraint_ms.batch", "build_rows_ms.batch", "host_syncs.plan",
       "rebuilds.plan")
US = 1e-6


def _span(name, a_us, b_us, parent=-1, rid=1, tag=None):
    """A closed program span from a_us to b_us µs on perf_counter."""
    s = profiling.Span(name, rid, tag)
    s.start, s.end, s.parent = int(a_us * 1e3), int(b_us * 1e3), parent
    return s


def _rec(spans, counters=None, rid=1):
    """A recording of ``spans`` with ``counters`` counted under ``rid``."""
    r = profiling.Recording()
    r.spans = spans
    r.counters.update(counters or {})
    r.by_request[rid].update(counters or {})
    return r


def _trace(ranges, events=(), cards=(0,), device_spans=None):
    return tracing.Trace(tracing.Spans(), list(events), list(ranges),
                         (0.0, 1.0), 1, list(cards), {},
                         device_spans or {}, 1, [1.0])


OFF = 5.0     # the profiler's clock is 5 s ahead of perf_counter


def _ranges(*spans_and_gaps):
    """Harness ranges around top-level program spans: (harness name,
    span, µs before its start, µs after its end)."""
    return [(name, OFF + s.start / 1e9 - lead * US,
             OFF + s.end / 1e9 + lag * US)
            for name, s, lead, lag in spans_and_gaps]


def _traced(monkeypatch, t, rec):
    _recorded(monkeypatch, rec)
    return program_spans.recording(t)


def test_align_maps_spans_inside_their_ranges(monkeypatch):
    build = _span("batch.build", 1000, 3000)
    rows = _span("build.rows", 1100, 1900, parent=0)
    solve = _span("batch.solve", 3010, 9000)
    replay = _span("step.replay", 3100, 3300, parent=2)
    rec = _rec([build, rows, solve, replay])
    t = _trace(_ranges(("build", build, 3, 4), ("solve", solve, 2, 2),
                       ("fetch", solve, -9000, 0)))
    off, residual, paired = program_spans.align(t, rec)
    # build allows offsets OFF - 3 .. OFF + 4 µs, solve OFF - 2 .. OFF + 2:
    # the offset is the middle of both, the residual their width
    assert off == pytest.approx(OFF, abs=1e-12)
    assert residual == pytest.approx(4 * US, abs=1e-12)
    assert paired == {0: tuple(t.ranges[0][1:]), 2: tuple(t.ranges[1][1:])}
    got = _traced(monkeypatch, t, rec)
    assert got.spans == [build, rows, solve, replay]
    assert got.offset == off and got.residual == residual
    for s in got.spans:
        top = 0 if s.name.startswith(("batch.build", "build.")) else 1
        assert t.ranges[top][1] <= s.start / 1e9 + off <= \
            s.end / 1e9 + off <= t.ranges[top][2]


def test_a_residual_over_20_us_leaves_idle_unread(monkeypatch):
    """The residual limits what is placed in time (idle charged to a
    span), not durations and counts; a pairing that no offset fits, or
    that lacks a span, reads nothing."""
    solve = _span("batch.solve", 0, 5000)
    replay = _span("step.replay", 100, 200, parent=0)
    ev = [tracing.Event("k", OFF + a * US, OFF + b * US, 0)
          for a, b in ((0, 100), (300, 5000))]
    ok = _trace(_ranges(("solve", solve, 11, 8)), ev)
    assert program_spans.align(ok, _rec([solve]))[1] == pytest.approx(
        19 * US, abs=1e-12)
    got = _traced(monkeypatch, ok, _rec([solve, replay]))
    assert program_spans.idle_share(ok, got, "batch.solve",
                                    "step.replay") is not None
    far = _trace(_ranges(("solve", solve, 15, 6)), ev)
    assert program_spans.align(far, _rec([solve]))[1] == pytest.approx(
        21 * US, abs=1e-12)
    got = _traced(monkeypatch, far, _rec([solve, replay]))
    assert got.spans == [solve, replay]
    assert program_spans.idle_share(far, got, "batch.solve",
                                    "step.replay") is None
    # the tightest pair decides: build leaves 30 µs open, solve 19
    build = _span("batch.build", 7000, 8000)
    both = _trace(_ranges(("solve", solve, 11, 8), ("build", build, 25, 5)))
    assert program_spans.align(both, _rec([solve, build]))[1] == \
        pytest.approx(16 * US, abs=1e-12)
    # no offset puts both spans inside their ranges: the clocks disagree
    late = _trace(_ranges(("solve", solve, 11, 8), ("build", build, -30,
                                                      40)))
    assert program_spans.align(late, _rec([solve, build])) is None
    # a harness range without a program span to pair
    two = _trace(_ranges(("solve", solve, 11, 8), ("solve", solve, 1, 1)))
    assert program_spans.align(two, _rec([solve])) is None
    # a child that ends after its top-level span's range
    child = _span("step.replay", 4990, 5030, parent=0)
    assert program_spans.align(ok, _rec([solve, child])) is not None
    assert _traced(monkeypatch, ok, _rec([solve, child])) is None
    assert program_spans.align(ok, None) is None


def test_an_earlier_profiles_spans_and_counters_are_left_out(monkeypatch):
    """The recording gathers every profile of a run (a traced unit is
    retaken where markers were lost): the traced unit's spans are the
    newest, and only the counters of their requests count."""
    old = [_span("module.create", 0, 500, rid=1),
           _span("module.iterate", 510, 900, rid=1),
           _span("step.replay", 600, 650, parent=1, rid=1)]
    new = [_span("module.create", 10000, 10500, rid=2),
           _span("module.iterate", 10510, 10900, rid=2),
           _span("step.replay", 10600, 10650, parent=4, rid=2),
           _span("step.replay", 10700, 10750, parent=4, rid=2)]
    rec = _rec(old + new, {"host_sync": 5}, rid=1)
    rec.by_request[2].update({"host_sync": 7, "engine_cache.hit": 1})
    rec.by_request[None].update({"graph.capture": 1})
    t = _trace(_ranges(("create", new[0], 2, 2), ("iterate", new[1], 3, 3)))
    got = _traced(monkeypatch, t, rec)
    assert got.spans == new
    assert got.counters == {"host_sync": 7, "engine_cache.hit": 1}
    assert harness.reader("host_syncs.plan")(t) == 7
    assert harness.reader("rebuilds.plan")(t) == 0


def _replay_events(t0, names, kinds_dur, card=0):
    out, t = [], t0
    for name, d in zip(names, kinds_dur):
        out.append(tracing.Event(name, t, t + d, card))
        t += d + 1e-7
    return out, t


MAP = profiling.NodeMap(11, 0, (("fk", 2), ("obstacle", 1), ("other", 1)),
                        "kkkc")
NAMES = ["fk_a", "fk_b", "obstacle_kernel", "Memcpy DtoD (Device -> Device)"]
DUR = [4e-6, 2e-6, 3e-6, 1e-6]


def _solve_events(replays=3, drop=None):
    """A solve's events on card 0: two prelude copies, then each replay's
    four nodes and one eager copy kernel, then the final costs."""
    ev, t = _replay_events(0.1, ["Memcpy DtoD (Device -> Device)"] * 2,
                           [1e-6, 1e-6])
    for r in range(replays):
        names, dur = list(NAMES), list(DUR)
        if r == drop:
            del names[1], dur[1]
        block, t = _replay_events(t + 1e-6, names, dur)
        ev += block
        eager, t = _replay_events(t, ["copy_kernel"], [5e-7])
        ev += eager
    tail, _ = _replay_events(t, ["fk_a", "obstacle_kernel"], [4e-6, 3e-6])
    return ev + tail


def _solve_trace(events):
    return _trace([], events, device_spans={0: [("solve", 0.0, 1.0)]})


def _replay_rec(n, m=MAP):
    solve = _span("batch.solve", 0, 1000)
    return _rec([solve] + [_span("step.replay", 10 + i, 11 + i, parent=0,
                                 tag=m) for i in range(n)])


def test_node_map_splits_each_replays_events():
    ev = _solve_events()
    assert program_spans.find_replays(ev, MAP.kinds) == [2, 7, 12]
    ms = program_spans.replay_phase_ms(_solve_trace(ev), _replay_rec(3))
    assert ms["fk"] == pytest.approx(6e-3)
    assert ms["obstacle"] == pytest.approx(3e-3)
    assert ms["other"] == pytest.approx(1e-3)
    # the phases add up to the replay's busy time (less its 3 gaps)
    assert sum(ms[p] for p in ("fk", "obstacle", "other")) == \
        pytest.approx(ms["busy"], abs=1e-9)


def test_a_replay_that_lost_an_event_reads_nothing():
    ev = _solve_events(drop=1)
    assert program_spans.find_replays(ev, MAP.kinds) == [2, 11]
    ms = program_spans.replay_phase_ms(_solve_trace(ev), _replay_rec(3))
    assert ms["fk"] == pytest.approx(6e-3)
    one = _solve_events(replays=1, drop=0)
    assert program_spans.find_replays(one, MAP.kinds) == []
    assert program_spans.replay_phase_ms(_solve_trace(one),
                                         _replay_rec(1)) is None
    # more whole replays found than the program recorded: no reading
    assert program_spans.replay_phase_ms(_solve_trace(_solve_events()),
                                         _replay_rec(2)) is None
    # a map whose kinds no run of events has
    other = MAP._replace(key=12, kinds="kkkkk",
                         phases=(("fk", 2), ("obstacle", 3)))
    assert program_spans.replay_phase_ms(
        _solve_trace(_solve_events()), _replay_rec(3, other)) is None


def test_a_memcpy_node_run_by_a_copy_kernel_is_a_memcpy():
    """A graph's memcpy node shows as a copy engine's memcpy or as the
    CUDA's copy kernel: either is a memcpy, so the replays are found
    either way."""
    ev = _solve_events()
    as_kernel = [tracing.Event("memcpy32_post", e.start, e.end, e.card)
                 if e.name.startswith("Memcpy") and 2 <= i < 17 else e
                 for i, e in enumerate(ev)]
    assert program_spans.find_replays(as_kernel, MAP.kinds) == [2, 7, 12]
    assert [program_spans.kind_of(n) for n in (
        "Memcpy DtoD (Device -> Device)", "memcpy32_post",
        "Memset (Unknown)", "void at::native::memcpy_like_kernel")] == \
        ["c", "c", "s", "k"]


def test_two_runs_that_repeat_alike_are_not_guessed():
    # "x y x y x": "x y" and "y x" each twice
    ev, _ = _replay_events(0.0, ["x", "y"] * 2 + ["x"], [1e-6] * 5)
    assert program_spans.find_replays(ev, "kk") == []
    assert program_spans.find_replays(ev[:4], "kk") == [0, 2]


def test_idle_is_charged_to_the_innermost_program_span(monkeypatch):
    solve = _span("batch.solve", 0, 1000)
    r1 = _span("step.replay", 100, 200, parent=0)
    r2 = _span("step.replay", 500, 600, parent=0)
    costs = _span("step.costs", 700, 800, parent=0)
    rec = _rec([solve, r1, r2, costs])
    ranges = _ranges(("solve", solve, 0, 0))
    us = [(0, 100), (210, 480), (610, 690), (800, 1000)]
    ev = [tracing.Event("k", OFF + a * US, OFF + b * US, 0) for a, b in us]
    t = _trace(ranges, ev)
    traced = _traced(monkeypatch, t, rec)
    # gaps: 100-210 (middle 155, in a replay), 480-610 (545, replay),
    # 690-800 (745, step.costs): 240 of 350 µs under step.replay
    assert program_spans.idle_share(t, traced, "batch.solve",
                                    "step.replay") == \
        pytest.approx(100 * 240 / 350)
    assert program_spans.idle_share(t, traced, "batch.solve",
                                    "step.costs") == \
        pytest.approx(100 * 110 / 350)
    assert program_spans.idle_share(t, None, "batch.solve",
                                    "step.replay") is None


def _recorded(monkeypatch, rec):
    monkeypatch.setattr(profiling, "recorded", lambda: rec)


def test_readers_of_a_recording(monkeypatch):
    build = _span("batch.build", 0, 3000)
    spans = [build, _span("build.rows", 100, 1100, parent=0),
             _span("build.expand", 1100, 1300, parent=0),
             _span("build.copy", 1300, 2800, parent=0),
             _span("batch.solve", 3010, 9000)]
    spans += [_span("step.replay", 3100 + 100 * i, 3150 + 100 * i, parent=4,
                    tag=MAP) for i in range(3)]
    _recorded(monkeypatch, _rec(spans))
    ev = _solve_events()
    t = _trace(_ranges(("build", spans[0], 1, 1), ("solve", spans[4], 1, 1)),
               [tracing.Event(e.name, e.start + OFF, e.end + OFF, 0)
                for e in ev],
               device_spans={0: [("solve", OFF, OFF + 1.0)]})
    read = {m: harness.reader(m)(t) for m in NEW}
    assert read["build_rows_ms.batch"] == pytest.approx(1.0)
    assert read["fk_ms.batch"] == pytest.approx(6e-3)
    assert read["fk_kernels.batch"] == pytest.approx(2.0)
    assert read["smooth_ms.batch"] is None
    assert read["constraint_ms.batch"] is None
    assert read["host_syncs.plan"] is None
    assert read["rebuilds.plan"] is None

    create = _span("module.create", 0, 500)
    req = [create, _span("module.iterate", 510, 4000),
           _span("step.replay", 600, 650, parent=1),
           _span("module.gettraj", 4010, 5000),
           _span("gettraj.check", 4100, 4900, parent=3),
           _span("module.destroy", 5010, 5020)]
    _recorded(monkeypatch, _rec(req, {"host_sync": 81,
                                      "engine_cache.hit": 1}))
    ranges = _ranges(("create", req[0], 2, 2), ("iterate", req[1], 2, 2),
                     ("gettraj", req[3], 2, 2), ("destroy", req[5], 2, 2))
    busy = [(600, 700), (1000, 3990)]
    t = _trace(ranges, [tracing.Event("k", OFF + a * US, OFF + b * US, 0)
                        for a, b in busy])
    read = {m: harness.reader(m)(t) for m in NEW}
    assert read["host_syncs.plan"] == 81
    assert read["rebuilds.plan"] == 0
    for m in ("fk_ms.batch", "fk_kernels.batch", "build_rows_ms.batch"):
        assert read[m] is None


@pytest.mark.parametrize("rec", [None, "no recorder", "empty"])
def test_readers_read_nothing_without_the_programs_spans(monkeypatch, rec):
    """A program without the recorder (an older commit), or a recording
    that holds nothing: every new reader returns None and raises
    nothing."""
    if rec == "no recorder":
        monkeypatch.delattr(profiling, "recorded")
    else:
        _recorded(monkeypatch, None if rec is None else profiling.Recording())
    ev = _solve_events()
    t = _trace([("solve", 0.0, 1.0), ("iterate", 0.0, 1.0)], ev,
               device_spans={0: [("solve", 0.0, 1.0)]})
    for m in NEW:
        assert harness.reader(m)(t) is None, m


def test_new_metrics_are_declared():
    bench = harness.load_benchmark()
    per = {m["name"]: m for m in bench["per_layer"]}
    for m in NEW:
        assert m in per and per[m]["workloads"], m
        assert (CHECKOUT / "portbench" / "metrics" / f"{m}.py").is_file()
    assert per["constraint_ms.batch"]["workloads"] == ["floating_tsr.batch256"]
    assert {per[m]["source"] for m in NEW} == {"device_trace", "host_clock"}

