"""The port's phase profiling (counterpart of tests/test_profiling.py): the
taxonomy is the JAX package's; a CPU profile of the step holds every
phase range the JAX test finds in its compiled step (and ``constraint``
on a TSR run, the SDF build's ``voxelize`` / ``flood`` / ``edt``); time is
charged to the innermost phase, on the CPU from a real profile and on
the device from kernel events linked to their ops; ``PhaseTimers`` and
``format_phase_report`` keep the JAX package's formats."""

import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from or_cdchomp_tpu.utils import profiling as jprof

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp.problem import as_batch
from or_cdchomp_tpu_torch.utils import profiling as prof_mod
from or_cdchomp_tpu_torch.utils.profiling import (
    PHASES, PhaseTimers, capture_trace, format_phase_report, phase,
    phase_device_report, phase_host_report, phase_kernels)

from torch_parity import GOAL, config4_kw, table_module

# the ranges tests/test_profiling.py finds in the JAX compiled step
STEP_PHASES = ("callbacks", "callback_pre", "fk", "pre_velsaccs",
               "obstacle", "selfcol", "jtmap", "smoothgrad", "limits")


@pytest.fixture(scope="module")
def mod():
    m = table_module(pt, dtype=torch.float64, device="cpu")
    m.robots["wam"].enabled = False
    m.computedistancefield(kinbody="table", cube_extent=0.15)
    m.robots["wam"].enabled = True
    return m


def _cpu_profile(fn):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return p


def _names(p):
    return {e.name for e in p.events()}


def test_taxonomy_is_the_jax_packages():
    assert PHASES == jprof.PHASES


def test_step_profile_holds_the_phases(mod):
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=8)]
    probs = as_batch(run.problem)
    p = _cpu_profile(lambda: run.engine.step_batched(probs))
    names = _names(p)
    for ph in STEP_PHASES + ("smoothcost",):
        assert ph in names, f"phase range {ph} missing from the step"
    assert "constraint" not in names          # no TSR on this run
    p = _cpu_profile(lambda: run.engine.final_costs_batch(probs))
    names = _names(p)
    for ph in ("callbacks", "callback_pre", "fk", "obstacle", "selfcol",
               "smoothcost"):
        assert ph in names, f"phase range {ph} missing from final costs"
    assert "jtmap" not in names and "smoothgrad" not in names


def test_constraint_phase(mod):
    run = mod.runs[mod.create(**config4_kw(pt.TSR, 8))]
    probs = as_batch(run.problem)
    p = _cpu_profile(lambda: run.engine.step_batched(probs))
    assert "constraint" in _names(p)


def test_cpu_time_charged_to_the_innermost_phase():
    x = torch.randn(64, 64, dtype=torch.float64)

    def work():
        with phase("callbacks"):
            with phase("fk"):
                y = x @ x
            z = y + 1.0
        return z * 2.0

    p = _cpu_profile(work)
    seen = {}
    for e in p.events():
        if e.name in ("aten::mm", "aten::add", "aten::mul"):
            seen[e.name] = prof_mod._phase_of(e)
    assert seen == {"aten::mm": "fk", "aten::add": "callbacks",
                    "aten::mul": "other"}
    host = phase_host_report(p)
    assert set(host) == {"fk", "callbacks", "other"}
    top = sum(e.cpu_time_total for e in p.events()
              if e.cpu_parent is None) / 1e3
    assert abs(sum(host.values()) - top) <= 1e-9 * max(top, 1.0)
    # no device kernels recorded: the report is the CPU op time
    assert phase_device_report(p) == host


def _evt(id_, name, start=0.0, end=0.0, cuda=False, us=0.0,
         annotation=False):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        id=id_, name=name, time_range=types.SimpleNamespace(start=start,
                                                            end=end),
        device_type=dt.CUDA if cuda else dt.CPU, is_async=False,
        device_time=us, is_user_annotation=annotation, cpu_parent=None,
        self_cpu_time_total=0.0)


def test_kernels_charged_to_the_innermost_phase():
    """A kernel shares its id with the runtime call that launched it; the
    innermost range open when that call began takes it (a ctypes launch
    inside a range with no op around it too).  An op whose id repeats a
    launch's (another count), GPU-side copies of ranges and a kernel
    whose launch was not recorded do not mislead it."""
    events = [_evt(1, "callbacks", 0, 100), _evt(2, "callback_pre", 0, 40),
              _evt(3, "fk", 5, 35), _evt(4, "obstacle", 40, 60),
              _evt(5, "selfcol", 60, 80),
              _evt(102, "aten::mm", 95, 99),             # id clash, an op
              _evt(101, "cudaLaunchKernel", 10, 11),
              _evt(102, "cudaLaunchKernel", 50, 51),     # ctypes, in obstacle
              _evt(103, "cudaLaunchKernel", 70, 71),
              _evt(104, "cudaMemsetAsync", 90, 91),
              _evt(105, "cudaLaunchKernel", 120, 121),   # outside every range
              _evt(101, "gemm", cuda=True, us=4.0),
              _evt(102, "obstacle_kernel", cuda=True, us=10.0),
              _evt(103, "selfcol_kernel", cuda=True, us=6.0),
              _evt(104, "Memset (Device)", cuda=True, us=1.0),
              _evt(105, "add_kernel", cuda=True, us=0.5),
              _evt(106, "lost_launch_kernel", cuda=True, us=2.0),
              _evt(107, "obstacle", cuda=True, us=50.0, annotation=True)]
    fake = types.SimpleNamespace(events=lambda: events)
    assert sorted(phase_kernels(fake)) == sorted([
        ("gemm", "fk", 4.0), ("obstacle_kernel", "obstacle", 10.0),
        ("selfcol_kernel", "selfcol", 6.0),
        ("Memset (Device)", "callbacks", 1.0), ("add_kernel", "other", 0.5),
        ("lost_launch_kernel", "other", 2.0)])
    rep = phase_device_report(fake)
    assert rep == pytest.approx({"fk": 0.004, "obstacle": 0.010,
                                 "selfcol": 0.006, "callbacks": 0.001,
                                 "other": 0.0025}, rel=1e-12)


def test_phase_ranges():
    """A range without a profiler runs its body; under one it records."""
    with phase("fk"):
        x = torch.ones(3) + 1
    assert float(x[0]) == 2.0

    def ranged():
        with phase("jtmap"):
            torch.ones(2).sum()
    assert "jtmap" in _names(_cpu_profile(ranged))
    with pytest.raises(RuntimeError, match="inside"):
        with phase("fk"):
            raise RuntimeError("inside")


def test_phase_timers_report_matches_jax():
    """Each tic is a span recorded with nothing else recording; the ticks
    are the spans' seconds, and the report keeps the JAX package's
    format."""
    t, j = PhaseTimers(), jprof.PhaseTimers()
    for timers in (t, j):
        with timers.tic("fk"):
            pass
        with timers.tic("custom"):
            pass
    assert [s.name for s in t.spans] == ["fk", "custom"]
    assert dict(t.ticks) == {s.name: s.seconds for s in t.spans}
    assert all(s.parent == -1 and s.end >= s.start for s in t.spans)
    for timers in (t, j):
        timers.ticks.update(fk=0.125, custom=2.5, smoothgrad=1e-3)
    assert t.report() == j.report()
    assert "ticks_fk" in t.report() and "ticks_custom" in t.report()


def test_format_phase_report():
    """The JAX test's numbers: the same rows, order and shares; the header
    names the time."""
    ms = {"fk": 1000.0, "selfcol": 2000.0, "smoothgrad": 300.0,
          "other": 50.0}
    got = format_phase_report(ms).splitlines()
    want = jprof.format_phase_report(
        {k: int(v) for k, v in ms.items()}).splitlines()
    assert got[0] == "Per-step phase breakdown (device ms):"
    assert [ln.split()[0] for ln in got[1:]] == \
        [ln.split()[0] for ln in want[1:]]
    assert [ln.split()[-1] for ln in got[1:]] == \
        [ln.split()[-1] for ln in want[1:]]
    assert "( 59.7%)" in got[2]
    assert format_phase_report(ms, "host ms").startswith(
        "Per-step phase breakdown (host ms):")


def test_sdf_timers_and_build_phases(tmp_path):
    """computedistancefield's cache_read, sdf_build and cache_write are
    spans: sdf_timers keeps its keys and report, derived from them, and a
    profile's recording holds them with the build's voxelize, flood and
    edt spans inside sdf_build."""
    cache = str(tmp_path / "sdf_table.dat")
    m = table_module(pt, dtype=torch.float64, device="cpu")
    m.robots["wam"].enabled = False
    with prof_mod.recording() as rec:     # a new recording, for the profile
        pass
    p = _cpu_profile(lambda: m.computedistancefield(
        kinbody="table", cube_extent=0.15, cache_filename=cache))
    assert set(m.sdf_timers.ticks) == {"cache_read", "sdf_build",
                                       "cache_write"}
    assert all(v >= 0.0 for v in m.sdf_timers.ticks.values())
    assert dict(m.sdf_timers.ticks) == {
        s.name: s.seconds for s in m.sdf_timers.spans}
    assert {"voxelize", "flood", "edt"} <= _names(p)
    assert "ticks_sdf_build" in m.sdf_timers.report()
    assert prof_mod.recorded() is rec
    build = rec.named("sdf_build")
    assert len(build) == 1 and build[0] in m.sdf_timers.spans
    assert [s.name for s in rec.children(build[0])] == ["voxelize", "flood",
                                                        "edt"]
    m2 = table_module(pt, dtype=torch.float64, device="cpu")
    m2.robots["wam"].enabled = False
    m2.computedistancefield(kinbody="table", cube_extent=0.15,
                            cache_filename=cache, require_cache=True)
    assert set(m2.sdf_timers.ticks) == {"cache_read"}
    assert [s.name for s in m2.sdf_timers.spans] == ["cache_read"]
    np.testing.assert_array_equal(m2.sdfs[0].grid.data.numpy(),
                                  m.sdfs[0].grid.data.numpy())


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with capture_trace(d):
        with phase("smoothcost"):
            torch.ones(4).sum()
    files = os.listdir(d)
    assert files and all(f.endswith(".json") for f in files)
    text = open(os.path.join(d, files[0])).read()
    assert '"smoothcost"' in text


# -- the recorder: spans, counters, node maps -------------------------------

def _request(m, n_iter=3):
    h = m.create(robot="wam", adofgoal=GOAL, n_points=8)
    m.iterate(run=h, n_iter=n_iter)
    m.gettraj(run=h, no_collision_exception=True, no_collision_details=True)
    m.destroy(run=h)


def test_recording_off_leaves_no_span_or_counter(mod):
    """With nothing recording, phase is one shared null context, and a
    whole request (spans, host syncs, the engine cache) leaves the newest
    recording as it was."""
    with prof_mod.recording():
        pass
    rec = prof_mod.recorded()
    assert not prof_mod.recording_now()
    assert phase("fk") is phase("module.create")
    assert phase("fk").__enter__() is None
    _request(mod)
    prof_mod.count("graph.capture")
    prof_mod.host_sync(3)
    assert prof_mod.recorded() is rec
    assert rec.spans == [] and not rec.counters and rec.node_maps == {}


def test_spans_nest_and_a_request_shares_an_id(mod):
    """A request's commands are top-level spans with their children
    nested (the step's phases inside module.iterate), each span's parent
    opened before it and enclosing it, one id over the whole request and
    another for the next; a batch's build and solve share an id."""
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    with prof_mod.recording() as rec:
        _request(mod)
        _request(mod)
    top = rec.top_level()
    assert [s.name for s in top] == ["module.create", "module.iterate",
                                     "module.gettraj", "module.destroy"] * 2
    assert len({s.rid for s in top[:4]}) == 1
    assert len({s.rid for s in top[4:]}) == 1 and top[0].rid != top[4].rid
    for i, s in enumerate(rec.spans):
        assert s.end is not None and s.end >= s.start
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert s.parent < i and p.start <= s.start and s.end <= p.end
            assert s.rid == p.rid
    names = [s.name for s in rec.children(top[1])]
    assert names.count("module.fetch") == 1
    assert names[-1] == "module.final_costs"
    assert [s.name for s in rec.children(top[2])] == ["gettraj.retime",
                                                      "gettraj.check"]
    fk = rec.named("fk")
    assert fk and all(rec.spans[s.parent].name == "callback_pre" for s in fk)
    steps = rec.named("step.costs")
    assert len(steps) == 6
    assert {rec.spans[s.parent].name for s in steps} == {"module.iterate"}

    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=8)]
    starts = np.tile(run.problem.traj[0].numpy(), (3, 1))
    goals = np.tile(run.problem.traj[-1].numpy(), (3, 1))
    with prof_mod.recording() as rec:
        for _ in range(2):
            probs = problem_batch_from_grid(run.problem, starts, goals,
                                            run.engine)
            BatchSolver(run.engine).solve(probs, 2, tol=None)
    top = rec.top_level()
    assert [s.name for s in top] == ["batch.build", "batch.solve"] * 2
    assert top[0].rid == top[1].rid != top[2].rid == top[3].rid
    assert [s.name for s in rec.children(top[0])] == [
        "build.rows", "build.expand", "build.copy"]
    # P rows a batch built on a card; none from a CPU engine
    assert rec.counters["build.rows_on_card"] == (
        2 * 3 if run.engine.device.type == "cuda" else 0)
    kids = [s.name for s in rec.children(top[1])]
    assert kids[0] == "solve.scatter" and kids[-2:] == ["solve.final_costs",
                                                        "solve.gather"]
    assert kids.count("step.costs") == 2


def test_host_sync_counts_the_chunk_fetches(mod):
    """iterate brings its costs to the host once per ITER_CHUNK steps (a
    host sync each) and its final costs once: 40 steps at a chunk of 16
    are three fetches and one final read."""
    h = mod.create(robot="wam", adofgoal=GOAL, n_points=8)
    try:
        assert mod.runs[h].engine.ITER_CHUNK == 16
        with prof_mod.recording() as rec:
            mod.iterate(run=h, n_iter=40)
    finally:
        mod.destroy(run=h)
    assert len(rec.named("module.fetch")) == 3
    assert rec.counters["host_sync"] == 4
    assert len(rec.named("step.costs")) == 40


def test_engine_cache_counts_hits_and_misses():
    """A create that builds its engine counts a miss inside a
    module.engine_build span; a second create with the same key counts a
    hit and builds nothing."""
    m = table_module(pt, dtype=torch.float64, device="cpu")
    m.robots["wam"].enabled = False
    m.computedistancefield(kinbody="table", cube_extent=0.15)
    m.robots["wam"].enabled = True
    with prof_mod.recording() as rec:
        m.create(robot="wam", adofgoal=GOAL, n_points=8)
        m.create(robot="wam", adofgoal=GOAL, n_points=8)
    assert rec.counters["engine_cache.miss"] == 1
    assert rec.counters["engine_cache.hit"] == 1
    builds = rec.named("module.engine_build")
    assert len(builds) == 1
    assert rec.spans[builds[0].parent] is rec.top_level()[0]
    m.create(robot="wam", adofgoal=GOAL, n_points=9)
    assert prof_mod.recorded() is rec and \
        rec.counters["engine_cache.miss"] == 1


def test_profiles_add_to_the_recording_in_progress():
    """Each profile adds its spans and counters to the recording in
    progress, a recording context inside a profile too; a recording
    context entered where nothing records starts a new one."""
    with prof_mod.recording() as first:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with phase("fk"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with prof_mod.recording() as inner:
            with phase("jtmap"):
                prof_mod.count("graph.evict")
    assert inner is first and prof_mod.recorded() is first
    assert [s.name for s in first.spans] == ["fk", "jtmap"]
    assert first.counters == {"graph.evict": 1}
    assert first.by_request[first.spans[1].rid] == {"graph.evict": 1}
    with prof_mod.recording() as second:
        prof_mod.count("graph.evict")
    assert second is not first and prof_mod.recorded() is second
    assert second.spans == [] and second.by_request[None] == {
        "graph.evict": 1}


def test_a_tic_after_a_profile_keeps_its_recording():
    """PhaseTimers times its spans with nothing recording and leaves the
    recording in progress as it was; inside a profile its span is
    recorded."""
    with prof_mod.recording() as rec:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with phase("fk"):
            pass
    timers = PhaseTimers()
    with timers.tic("sdf_build"):
        with phase("voxelize"):
            pass
    assert prof_mod.recorded() is rec
    assert [s.name for s in rec.spans] == ["fk"]
    assert timers.ticks["sdf_build"] == timers.spans[0].seconds >= 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.tic("cache_read"):
            pass
    assert [s.name for s in rec.spans] == ["fk", "cache_read"]
    assert rec.spans[1] is timers.spans[1]


def test_node_map_charges_nodes_to_the_innermost_phase():
    """The capture's node count at each phase edge splits its nodes: a
    node belongs to the innermost step phase open when it was captured,
    "other" outside them; spans of other names do not split; only the
    kinds a profiler reports are kept."""
    nodes = []

    def count(kinds):
        return "".join(nodes) if kinds else len(nodes)

    with prof_mod.node_map(count, device=2) as b:
        nodes += "k"
        with phase("callbacks"):
            nodes += "kk"
            with phase("fk"):
                nodes += "k-k"
            with phase("step.replay"):
                nodes += "s"
        nodes += "c"
        with phase("limits"):
            pass
        with phase("smoothcost"):
            nodes += "kc"
        m = b.finish()
    assert m.device == 2 and m.kinds == "kkkkkscKc".replace("K", "k")
    assert m.phases == (("other", 1), ("callbacks", 2), ("fk", 2),
                        ("callbacks", 1), ("other", 1), ("smoothcost", 2))
    assert m.nodes == 9 and len(m.per_node()) == 9
    assert prof_mod.recorded().spans == [] or not prof_mod.recording_now()

    def broken(kinds):
        raise RuntimeError("not capturing")

    with prof_mod.node_map(broken) as b:
        with phase("fk"):
            pass
        assert b.finish() is None


def test_replayed_kernels_split_by_the_node_map():
    """A replay's kernels share the id of its cudaGraphLaunch: they take
    the phases of the node map with as many nodes, in the order they ran;
    a replay that lost one reads None, and so does the report."""
    m = prof_mod.NodeMap(1, 0, (("fk", 2), ("obstacle", 1), ("other", 1)),
                         "kkkc")
    events = [_evt(7, "cudaGraphLaunch", 10, 12),
              _evt(8, "cudaGraphLaunch", 20, 22),
              _evt(9, "cudaLaunchKernel", 30, 31),
              _evt(10, "fk", 29, 40)]
    for i, name in enumerate(["a", "b", "obstacle_kernel", "Memcpy DtoD"]):
        ev = _evt(7, name, cuda=True, us=1.0 + i)
        ev.time_range.start = 100 + i
        events.append(ev)
    events.append(_evt(9, "eager_kernel", cuda=True, us=0.5))
    fake = types.SimpleNamespace(events=lambda: events)
    got = prof_mod.phase_kernels(fake, maps=[m])
    assert sorted(got) == sorted([
        ("a", "fk", 1.0), ("b", "fk", 2.0), ("obstacle_kernel", "obstacle",
                                             3.0),
        ("Memcpy DtoD", "other", 4.0), ("eager_kernel", "fk", 0.5)])
    assert prof_mod.phase_device_report(fake, maps=[m]) == pytest.approx(
        {"fk": 0.0035, "obstacle": 0.003, "other": 0.004}, rel=1e-12)
    lost = _evt(8, "a", cuda=True, us=1.0)
    events.append(lost)
    got = prof_mod.phase_kernels(fake, maps=[m])
    assert ("a", None, 1.0) in got
    assert prof_mod.phase_device_report(fake, maps=[m]) is None
    assert prof_mod.replay_phases(4, [m, m._replace(key=2)]) == \
        ["fk", "fk", "obstacle", "other"]
    assert prof_mod.replay_phases(4, [m, m._replace(
        phases=(("fk", 4),))]) is None


def test_eager_steps_record_draw_and_costs_spans(mod):
    """Off the card every step is eager: its phases nest under nothing
    but its caller; step.draw appears with HMC only, step.costs always."""
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=8,
                              use_hmc=True, seed=4)]
    probs = as_batch(run.problem)
    with prof_mod.recording() as rec:
        run.engine.iterate_batched(probs, 3)
    assert len(rec.named("step.draw")) == 3
    assert len(rec.named("step.costs")) == 3
    assert not rec.named("step.replay")
    run2 = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=8)]
    with prof_mod.recording() as rec:
        run2.engine.iterate_batched(as_batch(run2.problem), 2)
    assert not rec.named("step.draw") and len(rec.named("step.costs")) == 2
