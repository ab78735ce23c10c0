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
    t, j = PhaseTimers(), jprof.PhaseTimers()
    for timers in (t, j):
        with timers.tic("fk"):
            pass
        with timers.tic("custom"):
            pass
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
    cache = str(tmp_path / "sdf_table.dat")
    m = table_module(pt, dtype=torch.float64, device="cpu")
    m.robots["wam"].enabled = False
    p = _cpu_profile(lambda: m.computedistancefield(
        kinbody="table", cube_extent=0.15, cache_filename=cache))
    assert set(m.sdf_timers.ticks) == {"cache_read", "sdf_build",
                                       "cache_write"}
    assert all(v >= 0.0 for v in m.sdf_timers.ticks.values())
    assert {"voxelize", "flood", "edt"} <= _names(p)
    assert "ticks_sdf_build" in m.sdf_timers.report()
    m2 = table_module(pt, dtype=torch.float64, device="cpu")
    m2.robots["wam"].enabled = False
    m2.computedistancefield(kinbody="table", cube_extent=0.15,
                            cache_filename=cache, require_cache=True)
    assert set(m2.sdf_timers.ticks) == {"cache_read"}
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
