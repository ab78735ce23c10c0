"""The port's scripts (drive_torch.py, examples/torch_*.py) against the
JAX package, float64 on the CPU at a small size: each script's ``main``
runs with ``--device cpu --dtype float64``, n_points 9, 10 iterations
and B = 4, and the same calls go through the JAX package's module at
float64.  Trajectories and costs are held within 1e-9, collision
verdicts and best indices equal.

The port's modules get the JAX module's field values (the two packages'
float32 EDTs differ by an ulp on some cells, which moves a solve by
~5e-9 relative; torch_parity.share_fields): ``computedistancefield`` is
wrapped to replace each new field's values with the JAX field of the
same kinbody, after the port has built or read it.  The two WAM7 demos
share one JAX world, as the scripts share one.  Each script's defaults
ask for the card: on a host without one, ``main([])`` raises."""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu import client as jclient
from or_cdchomp_tpu.api import KinBody as JaxKinBody
from or_cdchomp_tpu.api import Robot as JaxRobot
from or_cdchomp_tpu.models.kdata import parse_spheres_xml
from or_cdchomp_tpu.models.urdf import parse_urdf
from or_cdchomp_tpu.ops import voxelize as jv
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver
from or_cdchomp_tpu.parallel.batch import best_of_batch as jax_best_of
from or_cdchomp_tpu.parallel.batch import problem_batch_from_grid

from or_cdchomp_tpu_torch import api

from chip_smoke import SCRIPTS
from torch_parity import GOAL, START, close, config1_module

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-9
N_POINTS, N_ITER, B = 9, 10, 4
SMALL = ["--device", "cpu", "--dtype", "float64",
         "--n-points", str(N_POINTS), "--n-iter", str(N_ITER)]
F64 = dict(dtype=jnp.float64)
KW = dict(lambda_=100.0, obs_factor=500.0, n_points=N_POINTS)


def _load(rel):
    """A script of the repository as a module (examples/ is no package)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "script_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(monkeypatch, jmod):
    """Wrap the port's computedistancefield so that each new field takes
    the values of ``jmod``'s field of the same kinbody."""
    build = api.CHOMPModule.computedistancefield
    jax_data = {s.kinbody_name: np.array(s.grid.data) for s in jmod.sdfs}

    def shared(self, kinbody=None, **kw):
        out = build(self, kinbody=kinbody, **kw)
        entry = self.sdfs[-1]
        want = jax_data[entry.kinbody_name]
        assert tuple(entry.grid.data.shape) == want.shape
        entry.grid.data = torch.as_tensor(want,
                                          device=entry.grid.data.device)
        self.clear_engine_cache()
        return out

    monkeypatch.setattr(api.CHOMPModule, "computedistancefield", shared)


def _jax_batch(run, batch, start, goal):
    """The demos' B perturbed problems (rng 0), built by the JAX package."""
    rng = np.random.default_rng(0)
    starts = np.tile(start, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    goals = np.tile(goal, (batch, 1)) + 0.02 * rng.normal(size=(batch, 7))
    return problem_batch_from_grid(run.problem, starts, goals, run.engine)


@pytest.fixture(scope="module")
def demo_world():
    """The two WAM7 demos' world (config 1's scene) in JAX at float64."""
    return config1_module(oc, **F64)


def test_drive_matches_jax(monkeypatch):
    jm = oc.CHOMPModule(**F64)
    jm.add_kinbody(JaxKinBody("table", oc.Scene.build(
        boxes=[((0.75, 0.0, 0.35, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    r = JaxRobot("wam", oc.wam7(), q_active=START.copy())
    jm.add_robot(r)
    r.enabled = False
    jm.computedistancefield(kinbody="table", cube_extent=0.04)
    r.enabled = True
    _fields(monkeypatch, jm)
    got = _load("drive_torch.py").main(SMALL)

    jt = jm.runchomp(robot="wam", n_iter=N_ITER, adofgoal=GOAL, **KW)
    h = jm.create(robot="wam", adofgoal=GOAL, **KW)
    cost = [0.0]
    jm.iterate(run=h, n_iter=N_ITER, cost=cost)
    jm.iterate(run=h, n_iter=N_ITER)
    close(got["traj"], jt.positions, RTOL)
    assert got["in_collision"] == jt.in_collision is False
    close(np.float64(got["cost"]), np.float64(cost[0]), RTOL)
    close(got["run_traj"], jm.runs[h].problem.traj, RTOL)


def test_wam7_demo_matches_jax(monkeypatch, tmp_path, demo_world):
    jm = demo_world
    script = _load("examples/torch_wam7_demo.py")
    monkeypatch.setattr(script, "CACHE_FILE", tmp_path / "wam7_demo_sdf.npy")
    _fields(monkeypatch, jm)
    got = script.main(SMALL + ["--batch", str(B)])
    assert (tmp_path / "wam7_demo_sdf.npy").exists()

    jt = jm.runchomp(robot="wam", adofgoal=GOAL, n_iter=N_ITER,
                     no_collision_exception=True, **KW)
    close(got["traj"], jt.positions, RTOL)
    assert got["in_collision"] == jt.in_collision
    h = jm.create(robot="wam", adofgoal=GOAL, **KW)
    run = jm.runs[h]
    out, _ = JaxBatchSolver(run.engine).iterate(
        _jax_batch(run, B, START, GOAL), N_ITER)
    finals = jnp.stack(run.engine.final_costs_batch(out), axis=-1)
    _, idx = jax_best_of(out, finals)
    jm.destroy(run=h)
    close(got["batch_traj"], out.traj, RTOL)
    close(got["finals"], finals, RTOL)
    assert got["best"] == int(idx)


def test_batch_validate_demo_matches_jax(monkeypatch, tmp_path, demo_world):
    jm = demo_world
    script = _load("examples/torch_batch_validate_demo.py")
    monkeypatch.setattr(script, "CACHE_FILE", tmp_path / "demo_sdf.npy")
    _fields(monkeypatch, jm)
    got = script.main(SMALL + ["--batch", str(B)])

    h = jm.create(robot="wam", adofgoal=GOAL, **KW)
    run = jm.runs[h]
    out, costs = JaxBatchSolver(run.engine).iterate(
        _jax_batch(run, B, START, GOAL), N_ITER)
    final = np.asarray(costs[-1, :, 0])
    trajs, in_col = jm.gettraj_batch(run=h, probs=out)
    jm.destroy(run=h)
    close(got["traj"], out.traj, RTOL)
    close(got["final"], final, RTOL)
    np.testing.assert_array_equal(got["in_collision"], in_col)
    close(got["positions"], np.stack([t.positions for t in trajs]), RTOL)
    ok = ~in_col
    want = int(np.flatnonzero(ok)[np.argmin(final[ok])]) if ok.any() \
        else None
    assert got["best"] == want


def test_urdf_client_demo_matches_jax(monkeypatch):
    jdemo = _load("examples/urdf_client_demo.py")
    script = _load("examples/torch_urdf_client_demo.py")
    assert (script.URDF, script.SPHERES_XML) == (jdemo.URDF,
                                                 jdemo.SPHERES_XML)
    model = parse_urdf(jdemo.URDF, use_collision_spheres=False)
    world = oc.CHOMPModule(**F64)
    world.add_kinbody(JaxKinBody("pillar", oc.Scene.build(
        cylinders=[((0.95, -0.15, 0.1, 0, 0, 0, 1), 0.06, 0.12)])))
    world.add_robot(JaxRobot(
        "planar3", model.with_spheres(parse_spheres_xml(jdemo.SPHERES_XML)),
        q_active=np.array([0.4, 0.3, -0.2])))
    mod = jclient.SendCommandModule(world)
    jclient.bind(mod)
    world.robots["planar3"].enabled = False
    mod.computedistancefield(kinbody="pillar", cube_extent=0.04)
    world.robots["planar3"].enabled = True
    _fields(monkeypatch, world)
    got = script.main(SMALL)

    want = json.loads(mod.runchomp(
        robot="planar3", adofgoal=[-0.8, 0.5, 0.4], n_iter=N_ITER,
        lambda_=50.0, obs_factor=500.0, n_points=N_POINTS))
    assert got["positions"].shape == (N_POINTS, 3)
    close(got["positions"], want["positions"], RTOL)
    close(got["times"], want["times"], RTOL)


def test_wam7_mesh_demo_matches_jax(monkeypatch):
    top_v, top_f = jv.box_trimesh((0.25, 0.4, 0.02))
    leg_v, leg_f = jv.box_trimesh((0.08, 0.08, 0.25))
    mug_v, mug_f = jv.cylinder_trimesh(0.04, 0.06, n=24)
    jm = oc.CHOMPModule(**F64)
    jm.add_kinbody(JaxKinBody("table", oc.Scene.build(
        meshes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), top_v, top_f),
                ((0.75, 0.0, 0.25, 0, 0, 0, 1), leg_v, leg_f)])))
    jm.add_kinbody(JaxKinBody("mug", oc.Scene.build(
        meshes=[((0.65, 0.15, 0.58, 0, 0, 0, 1), mug_v, mug_f)])))
    robot = JaxRobot("wam", oc.wam7(), q_active=START.copy())
    jm.add_robot(robot)
    robot.enabled = False
    jm.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    _fields(monkeypatch, jm)
    got = _load("examples/torch_wam7_mesh_demo.py").main(SMALL)

    jt = jm.runchomp(robot="wam", n_iter=N_ITER, adofgoal=GOAL,
                     no_collision_exception=True, **KW)
    close(got["traj"], jt.positions, RTOL)
    assert got["in_collision"] == jt.in_collision is False


@pytest.mark.parametrize("rel", SCRIPTS)
def test_script_defaults_to_the_card(rel, monkeypatch, tmp_path):
    script = _load(rel)
    if hasattr(script, "CACHE_FILE"):
        monkeypatch.setattr(script, "CACHE_FILE", tmp_path / "sdf.npy")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        script.main([])
