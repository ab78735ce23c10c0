"""The port's CHOMPModule against the JAX package's: create's problem on
the bench scene, and the error probe set (same message strings); the
port's entry points default to the card."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.api import KinBody as JaxKinBody, Robot as JaxRobot

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.api import KinBody, Robot
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine, HmcDraw
from or_cdchomp_tpu_torch.convert import fields_from_numpy, problem_from_numpy
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.ops.grid import Grid3D, pad_stack_grids
from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])


def _scene(pkg, kinbody, robot_cls, with_field=True, **mod_kw):
    mod = pkg.CHOMPModule(**mod_kw)
    mod.add_kinbody(kinbody("table", pkg.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(kinbody("mug", pkg.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = robot_cls("wam", pkg.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    if with_field:
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.04)
        robot.enabled = True
    return mod


@pytest.fixture(scope="module")
def mods():
    return (_scene(pt, KinBody, Robot, dtype=torch.float64, device="cpu"),
            _scene(oc, JaxKinBody, JaxRobot, dtype=jnp.float64))


@pytest.mark.parametrize("n_points", [11, 101])
def test_create_matches_jax(mods, n_points):
    tm, jm = mods
    kw = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
              n_points=n_points)
    trun = tm.runs[tm.create(**kw)]
    jrun = jm.runs[jm.create(**kw)]
    assert tuple(trun.spec) == tuple(jrun.spec)
    tl = trun.problem.leaves()
    jl = {k: np.asarray(v) for k, v in jrun.problem._asdict().items()
          if k != "hmc"}
    jl.update(resample_iter=np.asarray(jrun.problem.hmc.resample_iter),
              leapfrog_first=np.asarray(jrun.problem.hmc.leapfrog_first))
    assert set(tl) == set(jl)
    for k, v in jl.items():
        got = tl[k].numpy()
        assert got.shape == v.shape and got.dtype == v.dtype, k
        np.testing.assert_allclose(got, v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    te, je = trun.engine, jrun.engine
    np.testing.assert_array_equal(te._sphere_order, je._sphere_order)
    np.testing.assert_allclose(te.A.numpy(), np.asarray(je.A), rtol=1e-12)
    np.testing.assert_allclose(te.Ainv.numpy(), np.asarray(je.Ainv),
                               rtol=1e-12)


def test_batch_from_grid_matches_jax(mods):
    from or_cdchomp_tpu.parallel.batch import \
        problem_batch_from_grid as jax_batch
    tm, jm = mods
    kw = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
              n_points=11)
    trun = tm.runs[tm.create(**kw)]
    jrun = jm.runs[jm.create(**kw)]
    rng = np.random.default_rng(0)
    starts = START + 0.02 * rng.normal(size=(3, 7))
    goals = GOAL + 0.02 * rng.normal(size=(3, 7))
    tb = problem_batch_from_grid(trun.problem, starts, goals, trun.engine)
    jb = jax_batch(jrun.problem, starts, goals, jrun.engine)
    jhmc = jb.hmc._asdict()
    for k, v in tb.leaves().items():
        want = np.asarray(jhmc[k] if k in jhmc else getattr(jb, k))
        assert v.is_contiguous() and tuple(v.shape) == want.shape, k
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def _probe(mod, case):
    base = dict(robot="wam", adofgoal=GOAL, n_points=11)
    if case == "create_before_sdf":
        return mod.create(**base)
    if case == "duplicate_field":
        return mod.computedistancefield(kinbody="table", cube_extent=0.04)
    if case == "bad_lambda":
        return mod.create(**base, lambda_=0.001)
    if case == "wrong_goal_size":
        return mod.create(**dict(base, adofgoal=GOAL[:5]))
    if case == "goal_and_starttraj":
        return mod.create(**base, starttraj=np.zeros((3, 7)))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["create_before_sdf", "duplicate_field",
                                  "bad_lambda", "wrong_goal_size",
                                  "goal_and_starttraj"])
def test_error_probes_match_jax(mods, case):
    if case == "create_before_sdf":
        tm = _scene(pt, KinBody, Robot, with_field=False, device="cpu")
        jm = _scene(oc, JaxKinBody, JaxRobot, with_field=False)
    else:
        tm, jm = mods
    with pytest.raises(Exception) as want:
        _probe(jm, case)
    with pytest.raises(type(want.value)) as got:
        _probe(tm, case)
    assert str(got.value) == str(want.value)


_UPRIGHT = np.array([[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
                     [-np.pi, np.pi]])
_POSED = np.array([[0, 0], [-10, 10], [0, 0], [0, 0], [-1, 1], [0, 0]])


def _tsr_kw(tsr_cls, case):
    up = tsr_cls.from_matrices(np.eye(4), np.eye(4), Bw=_UPRIGHT)
    posed = tsr_cls.from_matrices(
        np.array([[1, 0, 0, 0.5], [0, 0, -1, 0.2], [0, 1, 0, 0.8],
                  [0, 0, 0, 1]]), np.eye(4), Bw=_POSED)
    if case == "everyn_tsr":
        return dict(adofgoal=GOAL, everyn_tsr=posed)
    if case == "con_tsrs":
        return dict(adofgoal=GOAL, con_tsrs=[("all", up), ("start", posed)])
    if case == "con_tsr":
        return dict(adofgoal=GOAL, con_tsr=("end", posed))
    if case == "starttraj":
        return dict(starttraj=np.stack([START, 0.5 * (START + GOAL), GOAL]))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["everyn_tsr", "con_tsrs", "con_tsr",
                                  "starttraj"])
def test_tsr_and_starttraj_kwargs_match_jax(mods, case):
    """create with TSR constraints or a start trajectory on a fixed base:
    the same problem, spec and constraint layout as the JAX package."""
    from or_cdchomp_tpu.tsr import TSR as JaxTSR

    tm, jm = mods
    base = dict(robot="wam", lambda_=100.0, n_points=11)
    trun = tm.runs[tm.create(**base, **_tsr_kw(pt.TSR, case))]
    jrun = jm.runs[jm.create(**base, **_tsr_kw(JaxTSR, case))]
    assert tuple(trun.spec) == tuple(jrun.spec)
    assert tuple(trun.engine.cons) == tuple(jrun.engine.cons)
    tl = trun.problem.leaves()
    for k, v in jrun.problem._asdict().items():
        if k != "hmc":
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(v),
                                       rtol=1e-12, atol=1e-12, err_msg=k)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("entry", [
    ChompEngine, CompiledFK, Grid3D.create, pad_stack_grids,
    problem_from_numpy, fields_from_numpy, HmcDraw,
], ids=lambda f: f.__qualname__)
def test_entry_point_defaults_to_cuda(entry):
    default = inspect.signature(entry).parameters["device"].default
    assert torch.device(default) == CUDA


def test_module_defaults_to_cuda():
    """CHOMPModule() allocates nothing, so it builds without a card."""
    assert pt.CHOMPModule().device == CUDA


@pytest.mark.parametrize("build", [
    lambda: Grid3D.create((2, 3, 4), (0.2, 0.3, 0.4)).data,
    lambda: pad_stack_grids([Grid3D.create((2, 3, 4), (0.2, 0.3, 0.4),
                                           device="cpu")]).data,
    lambda: fields_from_numpy(np.zeros((1, 2, 2, 2)), [[2, 2, 2]],
                              [[0.2, 0.2, 0.2]]).data,
], ids=["Grid3D.create", "pad_stack_grids", "fields_from_numpy"])
def test_default_never_falls_back_to_cpu(build):
    """By default a tensor lands on the card, or the call raises where
    there is none: never quietly on the CPU."""
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()
