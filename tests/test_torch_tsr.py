"""The port's TSR constraints against the JAX package at float64 on the
CPU: the batch-native evaluation (values and Jacobians), the goal-set
projection on each of its solve paths, the quasiseparable solve, the
non-positive-definite fault, and the TSR serialization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.chomp import constraints as jcons
from or_cdchomp_tpu.chomp.metric import sep_ainv_entries
from or_cdchomp_tpu.parallel.batch import problem_batch_from_grid
from or_cdchomp_tpu.tsr import TSR as JaxTSR

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import constraints as tcons
from or_cdchomp_tpu_torch.chomp.cost_soa import sphere_kinematics
from or_cdchomp_tpu_torch.tsr import TSR

from torch_parity import close, perturbed, port_engine, port_probs

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
UPRIGHT = [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
           [-np.pi, np.pi]]
POSED = [[0, 0], [-10, 10], [0, 0], [0, 0], [-1, 1], [0, 0]]
BASEGOAL = np.array([0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0])
B = 5


@pytest.fixture(scope="module")
def jmod():
    """tests/test_tsr_eval_soa.py's scene (one coarse SDF): the
    constraints do not read the field."""
    mod = oc.CHOMPModule(dtype=jnp.float64)
    mod.add_kinbody(oc.KinBody("table", oc.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = oc.Robot("wam", oc.wam7(), q_active=START)
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    r.enabled = True
    return mod


def _tsr(bw):
    return JaxTSR.from_matrices(np.eye(4), np.eye(4), Bw=np.asarray(bw))


CASES = {   # as tests/test_tsr_eval_soa.py has them
    "fixed_con_tsr_end": dict(n_points=9, con_tsr=("end", UPRIGHT)),
    "fixed_everyn_posed": dict(n_points=9, everyn_tsr=POSED),
    "floating_everyn": dict(n_points=7, everyn_tsr=UPRIGHT,
                            floating_base=True),
    "noncontiguous_start_end": dict(
        n_points=9, con_tsrs=[("start", UPRIGHT), ("end", UPRIGHT)]),
    "mixed_start_end": dict(
        n_points=9, con_tsrs=[("start", UPRIGHT), ("end", POSED)]),
}


def _run(jmod, case):
    kw = dict(CASES[case])
    floating = kw.pop("floating_base", False)
    if "everyn_tsr" in kw:
        kw["everyn_tsr"] = _tsr(kw["everyn_tsr"])
    if "con_tsr" in kw:
        kw["con_tsr"] = (kw["con_tsr"][0], _tsr(kw["con_tsr"][1]))
    if "con_tsrs" in kw:
        kw["con_tsrs"] = [(t, _tsr(bw)) for t, bw in kw["con_tsrs"]]
    if floating:
        kw.update(floating_base=True, basegoal=BASEGOAL, lambda_=200.0,
                  obs_factor=200.0)
    else:
        kw.update(lambda_=100.0, obs_factor=500.0)
    return jmod.runs[jmod.create(robot="wam", adofgoal=GOAL, **kw)]


def _batch(run):
    """B problems around the run's endpoints (σ = 0.05, seed 2, base
    quaternions kept), built by the JAX package."""
    starts, goals = perturbed(run, B, seed=2, sigma=0.05)
    return problem_batch_from_grid(run.problem, starts, goals, run.engine)


def _jax_fk(eng, probs):
    Tt = jnp.transpose(probs.traj, (1, 2, 0))
    if eng.spec.floating_base:
        return eng.fk.fk_soa(Tt[:, 7:, :],
                             tuple(Tt[:, i, :] for i in range(3)),
                             tuple(Tt[:, i, :] for i in range(3, 7)))
    return eng.fk.fk_soa(Tt, tuple(probs.robot_pose[:, i] for i in range(3)),
                         tuple(probs.robot_pose[:, i] for i in range(3, 7)))


def _both(jmod, case):
    """(JAX run, JAX batch, its val and jac, port engine, port batch,
    port val and jac)."""
    run = _run(jmod, case)
    jeng = run.engine
    jp = _batch(run)
    jval, jjac = jcons.eval_tsr_all_soa(jeng.spec, jeng.fk, jp, jp.traj,
                                        jeng.cons, _jax_fk(jeng, jp))
    teng = port_engine(jeng)
    tp = port_probs(jp)
    fk_out = sphere_kinematics(teng.spec, teng.fk, tp)[0]
    tval, tjac = tcons.eval_tsr_all_soa(teng.spec, teng.fk, tp, tp.traj,
                                        teng.cons, fk_out)
    return run, jp, jval, jjac, teng, tp, tval, tjac


@pytest.mark.parametrize("case", ["fixed_con_tsr_end", "fixed_everyn_posed",
                                  "floating_everyn",
                                  "noncontiguous_start_end"])
def test_eval_tsr_all_soa_matches_jax(jmod, case):
    _, _, jval, jjac, teng, _, tval, tjac = _both(jmod, case)
    C = teng.cons.n_constraints
    assert tuple(tval.shape) == (B, C, 6)
    assert tuple(tjac.shape) == (B, C, 6, teng.spec.n)
    close(tval, jval, 1e-12)
    close(tjac, jjac, 1e-10)


@pytest.mark.parametrize("case, path", [
    ("floating_everyn", "sss"),        # C = 5 uniform: JAX takes the scan
    ("floating_everyn", "dense"),      # the port's dense solve of it
    ("noncontiguous_start_end", "dense"),   # C = 2 < 4: dense in both
    ("mixed_start_end", "general"),    # two enabled masks: per-row system
])
def test_project_constraints_matches_jax(jmod, monkeypatch, case, path):
    run, jp, jval, jjac, teng, tp, tval, tjac = _both(jmod, case)
    spec, cons = teng.spec, teng.cons
    uniform = len(set(cons.enabled)) == 1
    assert uniform == (path != "general")
    monkeypatch.setattr(tcons, "_DENSE_MAX_ELEMS",
                        0 if path == "sss" else 1 << 40)
    if uniform:
        assert tcons.use_sss(spec, cons, B) == (path == "sss")
    rng = np.random.default_rng(7)
    AG = rng.normal(size=(B, spec.m, spec.n)) * 0.1
    jeng = run.engine

    def one(lam, ag, tm, v, j):
        return jcons.project_constraints(jeng.spec, jeng.cons, jeng, lam, ag,
                                         tm, v, j)

    want = jax.vmap(one)(jp.lambda_, jnp.asarray(AG), jp.traj[:, 1:-1],
                         jval, jjac)
    got = tcons.project_constraints(spec, cons, teng.proj_ops, tp.lambda_,
                                    torch.as_tensor(AG), tp.traj[:, 1:-1],
                                    tval, tjac)
    assert float(np.abs(np.asarray(want)).max()) > 1e-6
    close(got, want, 1e-9)


def _sss_system(seed, m, n, k, pts):
    rng = np.random.default_rng(seed)
    dt = 1.0 / (m + 1)
    C = len(pts)
    J = rng.normal(size=(2, C, k, n))
    h = rng.normal(size=(2, C, k))
    Acc = np.asarray(sep_ainv_entries(pts[:, None], pts[None, :], m, dt))
    JJt = np.einsum("baip,bdjp->baidj", J, J)
    M = (JJt * Acc[None, :, None, :, None]).reshape(2, C * k, C * k)
    return J, h, M, dt * dt * (pts + 1.0), float(m) - pts


@pytest.mark.parametrize("pts", [np.arange(23), np.array([0, 3, 4, 11, 30])],
                         ids=["contiguous", "sorted_gaps"])
def test_sss_solve_matches_spd_solve(pts):
    """The scan and the dense Cholesky solve one system alike."""
    J, h, M, alpha, beta = _sss_system(3, 40, 14, 2, pts)
    x_sss = tcons._sss_solve(torch.as_tensor(J), torch.as_tensor(h),
                             alpha, beta)
    x_spd = tcons._spd_solve(torch.as_tensor(M),
                             torch.as_tensor(h.reshape(2, -1)))
    close(x_sss.reshape(2, -1), x_spd, 1e-9)
    want = jcons._sss_solve(jnp.asarray(J[0]), jnp.asarray(h[0]),
                            jnp.asarray(alpha), jnp.asarray(beta))
    close(x_sss[0], want, 1e-9)


def test_spd_solve_not_positive_definite_gives_nan():
    """A problem whose J A⁻¹ Jᵀ is not positive definite gets NaN, as
    in the JAX package (a reference fault reproduced, ROADMAP §3); the
    other problems of the batch are untouched."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 4))
    M = np.stack([a @ a.T + 4 * np.eye(4), -np.eye(4)])
    b = rng.normal(size=(2, 4))
    want = jax.vmap(jcons._spd_solve)(jnp.asarray(M), jnp.asarray(b))
    got = tcons._spd_solve(torch.as_tensor(M), torch.as_tensor(b))
    assert np.isnan(np.asarray(want)[1]).all()
    assert torch.isnan(got[1]).all()
    close(got[0], np.asarray(want)[0], 1e-12)


def test_tsr_copy_parses_jax_serialization():
    t = JaxTSR.from_matrices(
        np.array([[1, 0, 0, 0.5], [0, 0, -1, 0.2], [0, 1, 0, 0.8],
                  [0, 0, 0, 1]]), np.eye(4),
        Bw=np.array([[0, 0], [0, 0], [-0.1, 0.1], [0, 0], [-np.pi, np.pi],
                     [0, 0]]))
    got = TSR.parse(t.serialize())
    for k in ("T0w", "Twe", "Bw"):
        np.testing.assert_array_equal(getattr(got, k), getattr(t, k))
    assert got.enabled_mask() == t.enabled_mask()
    assert pt.TSR is TSR
    assert got.serialize() == t.serialize()
