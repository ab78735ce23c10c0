"""start_tsr in the port against the JAX package at float64 on the CPU:
create's metric and affine terms, the moving-point window of the
kinematics that feed both kernels, the per-problem entry points
(``step``, ``iterate``, ``costs_only``) against their JAX twins, a
B = 3 batch against the JAX BatchSolver (its vmap of the per-problem
step), the constraint at point 0, start_tsr with everyn_tsr, and the
engine's metric choice at m >= 256."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.chomp import cost as jcost
from or_cdchomp_tpu.chomp.problem import ChompSpec as JaxSpec
from or_cdchomp_tpu.chomp.solver import ChompEngine as JaxEngine
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver
from or_cdchomp_tpu.parallel.batch import \
    problem_batch_from_grid as jax_batch_from_grid
from or_cdchomp_tpu.tsr import TSR as JaxTSR

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp.cost_soa import sphere_kinematics
from or_cdchomp_tpu_torch.chomp.problem import ChompSpec, as_batch
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)
from or_cdchomp_tpu_torch.tsr import TSR

from torch_parity import (GOAL, START, close, config1_module, share_fields,
                          start_tsr)

MATH_RTOL = 1e-12   # host metric terms, FK and finite differences
STEP_RTOL = 1e-9    # float64 through whole steps: summation order only
N_POINTS = 9
N_ITER = 4
UPRIGHT = [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
           [-np.pi, np.pi]]
KW = dict(robot="wam", adofgoal=GOAL, lambda_=150.0, obs_factor=200.0,
          n_points=N_POINTS)


def _kw(tsr_cls, case):
    kw = dict(KW, start_tsr=start_tsr(tsr_cls))
    if case == "with_everyn":
        kw["everyn_tsr"] = tsr_cls.from_matrices(np.eye(4), np.eye(4),
                                                 Bw=np.asarray(UPRIGHT))
    return kw


CASES = ["start_tsr", "with_everyn"]


@pytest.fixture(scope="module")
def mods():
    return share_fields(
        config1_module(pt, dtype=torch.float64, device="cpu"),
        config1_module(oc, dtype=jnp.float64))


@pytest.fixture(scope="module")
def runs(mods):
    """{case: (port run, JAX run)} created from the same kwargs."""
    tm, jm = mods
    return {c: (tm.runs[tm.create(**_kw(TSR, c))],
                jm.runs[jm.create(**_kw(JaxTSR, c))]) for c in CASES}


@pytest.fixture(scope="module")
def jax_iterated(runs):
    """{case: (problem, costs (N_ITER, 3))} of JAX ``engine.iterate``."""
    return {c: jrun.engine.iterate(jrun.problem, N_ITER)
            for c, (_, jrun) in runs.items()}


@pytest.mark.parametrize("case", CASES)
def test_create_matches_jax(runs, case):
    trun, jrun = runs[case]
    assert tuple(trun.spec) == tuple(jrun.spec)
    assert trun.spec.start_tsr and trun.spec.m == N_POINTS - 1
    assert trun.engine.cons == type(trun.engine.cons).build(
        list(zip(jrun.engine.cons.point_idx, jrun.engine.cons.enabled)))
    te, je = trun.engine, jrun.engine
    close(te.A, je.A, MATH_RTOL)
    close(te.Ainv, je.Ainv, MATH_RTOL)
    for k in ("traj", "B", "trC", "Evels", "tsr_T0w_inv", "tsr_Twe_inv",
              "AG"):
        close(getattr(trun.problem, k), getattr(jrun.problem, k), MATH_RTOL)
    # the start point is free: no init term in B, Evels or trC
    assert float(trun.problem.Evels[0].abs().max()) == 0.0


def test_kinematics_window_matches_jax(runs):
    """The kernels' inputs: x_mov, vel and acc over the n_points − 1
    moving points, point 0 with its one-sided velocity."""
    trun, jrun = runs["start_tsr"]
    te, je = trun.engine, jrun.engine
    _, x, vel, acc = sphere_kinematics(te.spec, te.fk,
                                       as_batch(trun.problem))
    kin = jcost.trajectory_kinematics(je.spec, je.fk, jrun.problem.traj,
                                      jrun.problem.robot_pose)
    assert tuple(x.shape) == (3, N_POINTS - 1, te.n_spheres_active, 1)
    for got, want in ((x, kin.x_mov), (vel, kin.vel), (acc, kin.acc)):
        close(got[..., 0].permute(1, 2, 0), want, MATH_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_step_and_iterate_match_jax(runs, jax_iterated, case):
    """N_ITER iterations: the port's ``iterate`` and N_ITER ``step``s
    against JAX ``engine.iterate``."""
    trun, _ = runs[case]
    jprob, jcosts = jax_iterated[case]
    eng = trun.engine
    tprob, tcosts = eng.iterate(trun.problem, N_ITER)
    close(tprob.traj, jprob.traj, STEP_RTOL)
    close(tcosts, jcosts, STEP_RTOL)
    p = trun.problem
    for i in range(N_ITER):
        p, c = eng.step(p)
        close(torch.stack(c), jcosts[i], STEP_RTOL)
    close(p.traj, jprob.traj, STEP_RTOL)
    assert int(p.iteration) == N_ITER


@pytest.mark.parametrize("case", CASES)
def test_costs_only_matches_jax(runs, jax_iterated, case):
    trun, jrun = runs[case]
    jprob, _ = jax_iterated[case]
    tprob, _ = trun.engine.iterate(trun.problem, N_ITER)
    for tp, jp in ((trun.problem, jrun.problem), (tprob, jprob)):
        got = torch.stack(trun.engine.costs_only(tp))
        close(got, jnp.stack(jrun.engine.costs_only(jp)), STEP_RTOL)


def test_batch_matches_jax_batch_solver(runs):
    """B = 3 perturbed problems built by both packages, N_ITER steps of
    each BatchSolver (the JAX one vmaps the per-problem step)."""
    trun, jrun = runs["start_tsr"]
    rng = np.random.default_rng(4)
    starts = START + 0.02 * rng.normal(size=(3, 7))
    goals = GOAL + 0.02 * rng.normal(size=(3, 7))
    tb = problem_batch_from_grid(trun.problem, starts, goals, trun.engine)
    jb = jax_batch_from_grid(jrun.problem, starts, goals, jrun.engine)
    for k in ("traj", "B", "trC", "Evels"):
        close(getattr(tb, k), getattr(jb, k), MATH_RTOL)
    tout, tcosts = BatchSolver(trun.engine).iterate(tb, N_ITER)
    jout, jcosts = JaxBatchSolver(jrun.engine).iterate(jb, N_ITER)
    assert tuple(tcosts.shape) == (N_ITER, 3, 3)
    close(tout.traj, jout.traj, STEP_RTOL)
    close(tcosts, jcosts, STEP_RTOL)


def test_point0_moves_and_its_constraint_shrinks(mods):
    """The start point is a moving point and is pulled onto its TSR
    (tests/test_oracle_full_matrix.py:258-302)."""
    tm, _ = mods
    rn = tm.runs[tm.create(**_kw(TSR, "start_tsr"))]
    eng = rn.engine
    before = eng.constraint_values(as_batch(rn.problem))[0]
    prob, _ = eng.iterate(rn.problem, 12)
    after = eng.constraint_values(as_batch(prob))[0]
    assert float(torch.linalg.norm(prob.traj[0] - rn.problem.traj[0])) > 1e-6
    torch.testing.assert_close(prob.traj[-1], rn.problem.traj[-1], rtol=0,
                               atol=0)
    assert float(before.abs().max()) > 0.02
    assert float(after.abs().max()) < 0.1 * float(before.abs().max())


def test_floating_base_error_matches_jax(mods):
    tm, jm = mods
    msgs = []
    for mod, tsr_cls in ((jm, JaxTSR), (tm, TSR)):
        with pytest.raises(ValueError) as e:
            mod.create(**dict(_kw(tsr_cls, "start_tsr"), floating_base=True,
                              basegoal=[0, 0, 0, 0, 0, 0, 1.0]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == \
        "floating_base and start_tsr together is not yet implemented!"


@pytest.mark.parametrize("start", [True, False])
def test_metric_choice_at_long_trajectories(runs, start):
    """m = 256: with start_tsr both engines take the dense metric (the
    semiseparable form needs a fixed start); without it both take the
    semiseparable metric and hold no m×m tensor."""
    trun, jrun = runs["start_tsr"]
    n_points = 256 + 2 - start
    jspec = JaxSpec(n_points=n_points, n=7, m=256, start_tsr=start,
                    n_fields=1)
    spec = ChompSpec(*jspec)
    jeng = JaxEngine(jspec, oc.wam7(), jrun.engine.fields,
                     dtype=jnp.float64)
    assert jeng.metric_mode == ("dense" if start else "sep")
    eng = ChompEngine(spec, pt.wam7(), trun.engine.fields,
                      dtype=torch.float64, device="cpu")
    assert eng.metric_mode == jeng.metric_mode
    if not start:
        assert eng.A is None and eng.Ainv is None and jeng.A is None
        return
    assert not eng.metric_ops.has_init0
    close(eng.A, jeng.A, MATH_RTOL)
