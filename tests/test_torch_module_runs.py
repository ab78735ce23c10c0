"""The port's per-run module commands against the JAX package's, float64
on the CPU, on config 1's scene (torch_parity.config1_module): runchomp,
iterate (costs, .dat rows, verbose report, max_time,
trajs_fileformstr), an HMC run fed the JAX keys, the engine cache, and
problem_batch_from_grid's JAX signature.  Tolerances: 1e-9 for solves
(the two step forms round differently), exact for counts and messages.
"""

import gc
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import metric as tmetric
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)
from torch_parity import (GOAL, START, JaxKeyDraw, close, config1_module,
                          share_fields)

KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
          n_points=9)
SOLVE = 1e-9


@pytest.fixture(scope="module")
def mods():
    return share_fields(config1_module(pt, dtype=torch.float64, device="cpu"),
                        config1_module(oc, dtype=jnp.float64))


def _dat(path):
    return np.loadtxt(path, ndmin=2)


def _costs(line):
    return [float(v) for v in re.findall(r"cost_\w+:(\S+)", line)]


def test_runchomp_matches_jax(mods, tmp_path):
    """runchomp (create + iterate + gettraj + destroy): the returned
    cost, the .dat rows but their time column, and the trajectory."""
    tm, jm = mods
    out = []
    for mod, name in ((tm, "t"), (jm, "j")):
        cost = [None]
        traj = mod.runchomp(n_iter=5, cost=cost, no_collision_exception=True,
                            dat_filename=str(tmp_path / f"{name}.dat"), **KW)
        out.append((cost[0], traj, _dat(tmp_path / f"{name}.dat")))
    (tc, tt, td), (jc, jt, jd) = out
    assert not tm.runs and tt.in_collision == jt.in_collision
    close(tc, jc, SOLVE)
    assert td.shape == jd.shape == (5, 5)
    np.testing.assert_array_equal(td[:, 0], jd[:, 0])
    close(td[:, 2:], jd[:, 2:], SOLVE)
    close(tt.times, jt.times, SOLVE)
    close(tt.positions, jt.positions, SOLVE)


def test_iterate_reentrant_and_report_match_jax(mods, capsys):
    """iterate 3 then 17 (crossing the 16-step chunk): the verbose
    report lines, the returned costs and the trajectory; the iteration
    counter of the run."""
    tm, jm = mods
    res = []
    for mod in (tm, jm):
        h = mod.create(**KW)
        c = [mod.iterate(run=h, n_iter=n, verbose=True) for n in (3, 17)]
        lines = capsys.readouterr().out.splitlines()
        res.append((c, lines, mod.runs[h]))
        mod.destroy(run=h)
    (tc, tl, trun), (jc, jl, jrun) = res
    assert trun.iteration == jrun.iteration == 20
    assert len(tl) == len(jl) == 22
    for a, b in zip(tl, jl):
        assert a.split("cost_total:")[0] == b.split("cost_total:")[0]
        assert a.endswith("[FINAL]") == b.endswith("[FINAL]")
        # printed with 6 decimals
        close(_costs(a), _costs(b), 1e-6)
    close(tc, jc, SOLVE)
    close(trun.problem.traj.numpy(), np.asarray(jrun.problem.traj), SOLVE)


def test_no_report_cost_keeps_dat_rows(mods, tmp_path, capsys):
    """no_report_cost hides the per-iteration report, not the .dat rows
    or the final line (JAX api.py:896-901)."""
    tm, jm = mods
    rows = []
    for mod, name in ((tm, "t"), (jm, "j")):
        h = mod.create(no_report_cost=True,
                       dat_filename=str(tmp_path / name), **KW)
        mod.iterate(run=h, n_iter=2, verbose=True)
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 1 and lines[0].endswith("[FINAL]")
        rows.append(_dat(tmp_path / name))
        mod.destroy(run=h)
    assert rows[0].shape == rows[1].shape == (2, 5)
    close(rows[0][:, 2:], rows[1][:, 2:], SOLVE)


def test_max_time_and_trajs_fileformstr(mods, tmp_path):
    """max_time=0 stops after the first iteration; with a budget that
    never runs out the run equals the chunked one; trajs_fileformstr
    writes the trajectory before each iteration, as the JAX package."""
    tm, jm = mods
    for mod in (tm, jm):
        h = mod.create(**KW)
        mod.iterate(run=h, n_iter=5, max_time=0.0)
        assert mod.runs[h].iteration == 1
        mod.destroy(run=h)
    h1, h2 = tm.create(**KW), tm.create(**KW)
    c1 = tm.iterate(run=h1, n_iter=4, max_time=1e9)
    c2 = tm.iterate(run=h2, n_iter=4)
    assert c1 == c2 and torch.equal(tm.runs[h1].problem.traj,
                                    tm.runs[h2].problem.traj)
    for h in (h1, h2):
        tm.destroy(run=h)
    for mod, name in ((tm, "t"), (jm, "j")):
        h = mod.create(**KW)
        mod.iterate(run=h, n_iter=3,
                    trajs_fileformstr=str(tmp_path / f"{name}_%d.txt"))
        mod.destroy(run=h)
    for i in range(3):
        close(np.loadtxt(tmp_path / f"t_{i}.txt"),
              np.loadtxt(tmp_path / f"j_{i}.txt"), SOLVE)
    assert not (tmp_path / "t_3.txt").exists()


def test_hmc_run_replays_jax_keys(mods):
    """An HMC run (frequent resamples) whose draw source replays the JAX
    run's key, PRNGKey(seed): the same trajectory and final cost."""
    tm, jm = mods
    kw = dict(KW, use_hmc=True, hmc_resample_lambda=2.0, seed=5)
    th, jh = tm.create(**kw), jm.create(**kw)
    trun = tm.runs[th]
    trun.draw = JaxKeyDraw(jax.random.PRNGKey(5)[None], trun.spec.m,
                           trun.spec.n)
    tc = tm.iterate(run=th, n_iter=6)
    jc = jm.iterate(run=jh, n_iter=6)
    assert trun.draw.calls == 6
    close(tc, jc, SOLVE)
    close(trun.problem.traj.numpy(), np.asarray(jm.runs[jh].problem.traj),
          SOLVE)
    assert int(trun.problem.resample_iter) == \
        int(jm.runs[jh].problem.hmc.resample_iter)
    tm.destroy(run=th)
    jm.destroy(run=jh)


def test_concurrent_hmc_runs_share_no_random_state(mods):
    """Two HMC runs with different seeds on one cached engine, iterated
    in turns: each equals the same run iterated alone."""
    tm, _ = mods
    kw = dict(KW, use_hmc=True, hmc_resample_lambda=2.0)
    h1, h2 = tm.create(seed=1, **kw), tm.create(seed=2, **kw)
    assert tm.runs[h1].engine is tm.runs[h2].engine
    tm.iterate(run=h1, n_iter=3)
    tm.iterate(run=h2, n_iter=3)
    tm.iterate(run=h1, n_iter=3)
    for h, seed, n in ((h1, 1, 6), (h2, 2, 3)):
        solo = tm.create(seed=seed, **kw)
        tm.iterate(run=solo, n_iter=n)
        assert torch.equal(tm.runs[h].problem.traj,
                           tm.runs[solo].problem.traj)
        tm.destroy(run=solo)
    for h in (h1, h2):
        tm.destroy(run=h)


def _small_module():
    mod = config1_module(pt, cube_extent=0.15, dtype=torch.float64,
                         device="cpu")
    return mod


def test_stale_engines_evicted_and_freed():
    """Changing the field registry evicts the engines built on the old
    one; once their runs are destroyed nothing keeps them or their field
    stack alive (JAX tests/test_engine_lifecycle.py)."""
    mod = _small_module()
    h = mod.create(**dict(KW, n_points=7))
    assert len(mod._engine_cache) == 1
    mod.iterate(run=h, n_iter=2)
    eng_ref = weakref.ref(mod.runs[h].engine)
    fields_ref = weakref.ref(mod.runs[h].engine.fields.data)
    mod.removefield(kinbody="table")
    assert len(mod._engine_cache) == 0
    mod.destroy(run=h)
    gc.collect()
    assert eng_ref() is None and fields_ref() is None


def test_engine_cache_lru_bound():
    mod = _small_module()
    cap = mod.ENGINE_CACHE_MAX
    for i in range(cap + 4):
        mod._engine_cache[("spec%d" % i, 0, mod._fields_version, i)] = \
            object()
        mod._evict_engines()
    assert len(mod._engine_cache) == cap
    assert ("spec0", 0, mod._fields_version, 0) not in mod._engine_cache
    assert ("spec%d" % (cap + 3), 0, mod._fields_version, cap + 3) in \
        mod._engine_cache


def test_engine_cache_hit_refreshes_recency():
    mod = _small_module()
    h1 = mod.create(**dict(KW, n_points=7))
    key1 = next(iter(mod._engine_cache))
    mod.create(**dict(KW, n_points=9))
    h3 = mod.create(**dict(KW, n_points=7))
    assert mod.runs[h1].engine is mod.runs[h3].engine
    assert len(mod._engine_cache) == 2
    assert list(mod._engine_cache)[-1] == key1


def test_clear_engine_cache():
    mod = _small_module()
    mod.create(**dict(KW, n_points=7))
    assert mod._engine_cache
    mod.clear_engine_cache()
    assert not mod._engine_cache


def test_create_takes_static_parts_from_the_engine_cache(monkeypatch):
    """A second create for the same robot takes the metric and the
    trajectory check's float64 FK from the engine cache: it builds no
    metric and no CompiledFK, and its run shares the first run's check
    FK.  A grab makes a new model, so the next create builds both anew:
    the metric, the engine's FK and the check FK."""
    mod = _small_module()
    h1 = mod.create(**dict(KW, n_points=7))
    built = []
    build_metric, fk_init = tmetric.build_metric, CompiledFK.__init__

    def counted_metric(*a, **kw):
        built.append("metric")
        return build_metric(*a, **kw)

    def counted_fk(self, *a, **kw):
        built.append("fk")
        fk_init(self, *a, **kw)

    monkeypatch.setattr(tmetric, "build_metric", counted_metric)
    monkeypatch.setattr(CompiledFK, "__init__", counted_fk)
    h2 = mod.create(**dict(KW, n_points=7))
    assert built == []
    r1, r2 = mod.runs[h1], mod.runs[h2]
    assert r2.engine is r1.engine and r2.fk is r1.fk
    assert r2.fk.dtype == torch.float64 and r2.fk.model is r2.robot.model

    robot = mod.robots["wam"]
    robot.grab(mod.bodies["mug"], robot.model.link_names[-1])
    r3 = mod.runs[mod.create(**dict(KW, n_points=7))]
    assert sorted(built) == ["fk", "fk", "metric"]
    assert r3.engine is not r1.engine and r3.fk is not r1.fk
    assert r3.fk.model is robot.model
    assert len(r3.fk.sphere_subset) == len(r1.fk.sphere_subset) + 1


def test_batch_from_grid_takes_jax_signature(mods):
    """bench.py's call, problem_batch_from_grid(problem, starts, goals,
    engine, ops), works and equals the call without ops; seeds become
    the hmc_seed leaf and change nothing else."""
    tm, _ = mods
    run = tm.runs[tm.create(**KW)]
    rng = np.random.default_rng(3)
    starts = START + 0.02 * rng.normal(size=(3, 7))
    goals = GOAL + 0.02 * rng.normal(size=(3, 7))
    a = problem_batch_from_grid(run.problem, starts, goals, run.engine,
                                run.engine.metric_ops)
    b = problem_batch_from_grid(run.problem, starts, goals, run.engine)
    for k, v in a.leaves().items():
        assert torch.equal(v, b.leaves()[k]), k
    probs, _ = BatchSolver(run.engine).iterate(a, 2)
    assert bool(torch.isfinite(probs.traj).all())
    c = problem_batch_from_grid(run.problem, starts, goals, run.engine,
                                None, 5 + np.arange(3))
    assert torch.equal(c.hmc_seed, torch.tensor([5, 6, 7]))
    assert a.hmc_seed is None and set(c.leaves()) == set(a.leaves()) | {
        "hmc_seed"}
    for k, v in a.leaves().items():
        assert torch.equal(v, c.leaves()[k]), k
