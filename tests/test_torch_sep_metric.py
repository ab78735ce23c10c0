"""The port's semiseparable metric against the JAX package at float64 on
the CPU: the five closed-form operators, the engine's batch step with
the dense and the semiseparable metric, ``create`` + ``iterate`` past
the threshold (and start_tsr keeping the dense metric there), and an
everyn-TSR projection under the semiseparable metric.

The JAX CPU compile of long-m graphs is slow, so the threshold
``SEP_MIN_M`` is set to 16 in both packages (as tests/test_sep_metric.py
does) and the trajectories are n_points 20 (m = 18) at most."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.chomp import metric as jmm
from or_cdchomp_tpu.chomp.solver import ChompEngine as JaxEngine
from or_cdchomp_tpu.tsr import TSR as JaxTSR

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import constraints as tcons
from or_cdchomp_tpu_torch.chomp import metric as tmm
from or_cdchomp_tpu_torch.chomp.constraints import TSRConstraintSet
from or_cdchomp_tpu_torch.chomp.problem import ChompProblem, ChompSpec
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.convert import fields_from_numpy
from or_cdchomp_tpu_torch.tsr import TSR

from torch_parity import (GOAL, close, jax_batch, port_probs, share_fields,
                          start_tsr, table_module)

MATH_RTOL = 1e-12
STEP_RTOL = 1e-9
N_POINTS = 20          # m = 18, past the patched threshold
SMALL_MIN_M = 16
UPRIGHT = [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
           [-np.pi, np.pi]]
KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
          n_points=N_POINTS)


@pytest.fixture
def small_threshold(mods, monkeypatch):
    """SEP_MIN_M = 16 in both packages, with both modules' engine caches
    emptied before and after (a cached engine keeps its metric)."""
    monkeypatch.setattr(jmm, "SEP_MIN_M", SMALL_MIN_M)
    monkeypatch.setattr(tmm, "SEP_MIN_M", SMALL_MIN_M)
    for mod in mods:
        mod._engine_cache.clear()
    yield
    for mod in mods:
        mod._engine_cache.clear()


@pytest.fixture(scope="module")
def mods():
    """tests/test_sep_metric.py's scene (a table at 0.6 m, one SDF at
    0.15 m) in both packages, the port given the JAX field values."""
    out = []
    for pkg, kw in ((pt, dict(dtype=torch.float64, device="cpu")),
                    (oc, dict(dtype=jnp.float64))):
        mod = table_module(pkg, **kw)
        robot = mod.robots["wam"]
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.15)
        robot.enabled = True
        out.append(mod)
    return share_fields(*out)


@pytest.mark.parametrize("m", [1, 2, 5, 33])
def test_sep_operators_match_jax(m):
    """sep_solve, sep_apply_A (batched (2, m, 7)), sep_ainv_entries
    (tensor and numpy indices), sep_B_trC and sep_Evels."""
    rng = np.random.default_rng(m)
    dt = 1.0 / (m + 1)
    G = rng.normal(size=(2, m, 7))
    for name in ("sep_solve", "sep_apply_A"):
        want = np.asarray(getattr(jmm, name)(jnp.asarray(G), dt))
        got = getattr(tmm, name)(torch.as_tensor(G), dt)
        assert got.dtype == torch.float64
        close(got, want, MATH_RTOL)
    p = np.arange(m)
    want = np.asarray(jmm.sep_ainv_entries(jnp.asarray(p)[:, None],
                                           jnp.asarray(p)[None, :], m, dt))
    close(tmm.sep_ainv_entries(torch.as_tensor(p)[:, None],
                               torch.as_tensor(p)[None, :], m, dt), want,
          MATH_RTOL)
    close(tmm.sep_ainv_entries(p[:, None], p[None, :], m, dt), want,
          MATH_RTOL)
    # and the dense inverse they stand for
    close(tmm.sep_ainv_entries(p[:, None], p[None, :], m, dt),
          tmm.build_metric(m, dt).Ainv, 1e-9)
    init0, final0 = rng.normal(size=7), rng.normal(size=7)
    Bt, trt = tmm.sep_B_trC(m, dt, init0, final0, 7)
    Bj, trj = jmm.sep_B_trC(m, dt, init0, final0, 7)
    close(Bt, Bj, MATH_RTOL)
    close(np.float64(trt), np.float64(trj), MATH_RTOL)
    close(tmm.sep_Evels(m, dt, init0, final0, 7),
          jmm.sep_Evels(m, dt, init0, final0, 7), MATH_RTOL)


def test_metric_mode_rule_and_errors(mods):
    """JAX's rule: "auto" takes sep from SEP_MIN_M on where it holds; "sep"
    with start_tsr raises JAX's ValueError."""
    tm, _ = mods
    run = tm.runs[tm.create(**dict(KW, n_points=9))]
    fields = run.engine.fields
    spec = ChompSpec(n_points=300, n=7, m=298, n_fields=1)
    eng = ChompEngine(spec, pt.wam7(), fields, dtype=torch.float64,
                      device="cpu")
    assert eng.metric_mode == "sep" and eng.A is None and eng.Ainv is None
    assert eng.metric_ops is None
    assert ChompEngine(spec, pt.wam7(), fields, dtype=torch.float64,
                       device="cpu", metric_mode="dense").metric_mode == \
        "dense"
    tsr_spec = spec._replace(start_tsr=True, m=299)
    with pytest.raises(ValueError, match="semiseparable metric requires"):
        ChompEngine(tsr_spec, pt.wam7(), fields, dtype=torch.float64,
                    device="cpu", metric_mode="sep")
    with pytest.raises(ValueError, match="metric_mode"):
        ChompEngine(spec, pt.wam7(), fields, dtype=torch.float64,
                    device="cpu", metric_mode="banded")


def _engines(jrun, mode):
    """(JAX engine, port engine) of a run's static structure with
    ``metric_mode`` ``mode``, on the same fields."""
    je = jrun.engine
    jeng = JaxEngine(je.spec, oc.wam7(), je.fields, cons=je.cons,
                     dtype=jnp.float64, metric_mode=mode)
    f = je.fields
    fields = fields_from_numpy(np.asarray(f.data), np.asarray(f.sizes),
                               np.asarray(f.lengths), device="cpu",
                               dtype=torch.float64)
    cons = TSRConstraintSet.build(list(zip(je.cons.point_idx,
                                           je.cons.enabled)))
    teng = ChompEngine(ChompSpec(*je.spec), pt.wam7(), fields,
                       dtype=torch.float64, device="cpu", cons=cons,
                       metric_mode=mode)
    return jeng, teng


@pytest.mark.parametrize("mode", ["dense", "sep"])
def test_engine_step_matches_jax(mods, mode):
    """Three batch steps (B = 3) of the dense and the semiseparable engine
    against the JAX engine in the same mode; the two modes agree."""
    _, jm = mods
    jrun = jm.runs[jm.create(**KW)]
    jeng, teng = _engines(jrun, mode)
    assert teng.metric_mode == jeng.metric_mode == mode
    jp = jax_batch(jrun, 3, seed=4)
    # the metric affine terms of each mode's own engine
    B, trC, Ev = jeng.build_affine_batch(np.asarray(jp.traj[:, 0]),
                                         np.asarray(jp.traj[:, -1]), 7)
    jp = jp._replace(B=jnp.asarray(B), trC=jnp.asarray(trC),
                     Evels=jnp.asarray(Ev))
    tp = port_probs(jp)
    tB, ttrC, tEv = teng.build_affine_batch(tp.traj[:, 0].numpy(),
                                            tp.traj[:, -1].numpy(), 7)
    close(tB, B, MATH_RTOL)
    close(ttrC, trC, MATH_RTOL)
    close(tEv, Ev, MATH_RTOL)
    tp, tc = teng.iterate_batched(tp, 3)
    # JAX's per-problem iterate (one compile, reused for each row)
    for b in range(3):
        jprob, jc = jeng.iterate(jax.tree.map(lambda x: x[b], jp), 3)
        close(tp.traj[b], jprob.traj, STEP_RTOL)
        close(tc[b], jc, STEP_RTOL)
        row = ChompProblem(**{k: v[b] for k, v in tp.leaves().items()})
        close(teng.costs_only(row)[0], jeng.costs_only_jit(jprob)[0],
              STEP_RTOL)


def test_create_iterate_past_threshold(mods, small_threshold):
    """create at n_points 20 (m = 18 ≥ 16) takes sep in both packages and
    holds no m×m tensor; its problem and three iterations match JAX."""
    tm, jm = mods
    th, jh = tm.create(**KW), jm.create(**KW)
    trun, jrun = tm.runs[th], jm.runs[jh]
    assert trun.engine.metric_mode == jrun.engine.metric_mode == "sep"
    assert trun.engine.A is None and trun.engine.Ainv is None
    for k in ("traj", "B", "trC", "Evels"):
        close(getattr(trun.problem, k), getattr(jrun.problem, k), MATH_RTOL)
    tcost = tm.iterate(run=th, n_iter=3)
    jcost = jm.iterate(run=jh, n_iter=3)
    close(tm.runs[th].problem.traj, jm.runs[jh].problem.traj, STEP_RTOL)
    close(np.float64(tcost), np.float64(jcost), STEP_RTOL)


def test_start_tsr_stays_dense_past_threshold(mods, small_threshold):
    """start_tsr frees the start point: both packages keep the dense
    metric at m = 20 and build the same A⁻¹."""
    tm, jm = mods
    trun = tm.runs[tm.create(**KW, start_tsr=start_tsr(TSR))]
    jrun = jm.runs[jm.create(**KW, start_tsr=start_tsr(JaxTSR))]
    assert trun.spec.m == N_POINTS - 1 >= SMALL_MIN_M
    assert trun.engine.metric_mode == jrun.engine.metric_mode == "dense"
    close(trun.engine.Ainv, jrun.engine.Ainv, MATH_RTOL)


@pytest.mark.parametrize("path", ["dense", "sss"])
def test_everyn_projection_under_sep(mods, small_threshold, monkeypatch,
                                     path):
    """An everyn TSR at m = 18 under sep: the projection's A⁻¹ entries
    come from the closed form (ProjectionOps from the engine's
    ainv_block / ainv_cols); three iterations against JAX (which solves
    by its scan) on each of the port's solve paths."""
    tm, jm = mods
    monkeypatch.setattr(tcons, "_DENSE_MAX_ELEMS",
                        0 if path == "sss" else 1 << 40)
    tsr = (TSR, JaxTSR)
    kw = [dict(KW, everyn_tsr=c.from_matrices(np.eye(4), np.eye(4),
                                             Bw=np.asarray(UPRIGHT)))
          for c in tsr]
    trun = tm.runs[tm.create(**kw[0])]
    jrun = jm.runs[jm.create(**kw[1])]
    te = trun.engine
    assert te.metric_mode == "sep" and te.cons.n_constraints == N_POINTS - 2
    pts = np.asarray(te.cons.point_idx)
    close(te.proj_ops.ainv_block,
          jrun.engine.ainv_block(pts), MATH_RTOL)
    close(te.proj_ops.ainv_cols, jrun.engine.ainv_cols(pts), MATH_RTOL)
    assert tcons.use_sss(te.spec, te.cons, 1) == (path == "sss")
    tp, tc = te.iterate(trun.problem, 3)
    jp, jc = jrun.engine.iterate(jrun.problem, 3)
    close(tp.traj, jp.traj, STEP_RTOL)
    close(tc, jc, STEP_RTOL)
