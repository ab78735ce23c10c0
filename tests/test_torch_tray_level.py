"""CPU tests of the benchmark's configuration ``wam7_tray_level``
(portbench/configs/wam7_tray_level.json): config 1's WAM7 carrying a
tray of 110 spheres level, under the upright everyn_tsr on a fixed base.

- The port's float64 batch path agrees with the plain reference
  (portbench/reference/chomp.py), shrunk as portbench/tests shrinks a
  cell: 9 to 11 points, 3 or 4 iterations, 3 or 4 seeded problems.
- The file's robot, whose tray spheres sit on ``handbase``, is config
  1's robot after ``Robot.grab(tray, "handbase")`` through CHOMPModule:
  the same spheres, the same active and inactive ones, the same pairs.
- Its endpoints hold the tool upright inside the joint limits.
- In float32 it takes K2's tiled path, and its FK table fits the FK
  kernel's shared memory.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tray_level.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))

from portbench import traffic, world  # noqa: E402
from portbench.reference import chomp as reference  # noqa: E402

import or_cdchomp_tpu_torch as pt  # noqa: E402
from or_cdchomp_tpu_torch.api import KinBody  # noqa: E402
from or_cdchomp_tpu_torch.models.robot import link_poses_np  # noqa: E402
from or_cdchomp_tpu_torch.ops import fk as fk_kernel, selfcol  # noqa: E402
from or_cdchomp_tpu_torch.parallel.batch import (  # noqa: E402
    BatchSolver, problem_batch_from_grid)
from or_cdchomp_tpu_torch.utils import np_pose  # noqa: E402

CONFIGS = CHECKOUT / "portbench" / "configs"
TRAY_OFFSET = [0.0, 0.0, 0.22, 0.0, 0.0, 0.0, 1.0]
N_TRAY = 110


def tray_cfg(n_points=None, n_iter=None):
    cfg = world.load(CONFIGS / "wam7_tray_level.json")
    if n_points is not None:
        cfg["create"]["n_points"] = n_points
    if n_iter is not None:
        cfg["n_iter"] = n_iter
    return cfg


def tray_spheres():
    """The tray of the grab tests: 10 x 11 spheres of 1.5 cm radius, 3 cm
    apart, in its own frame."""
    return [((0.03 * (i - 4.5), 0.03 * (j - 5.0), 0.0), 0.015)
            for i in range(10) for j in range(11)]


@pytest.mark.parametrize("n_points,n_iter,B,seed", [
    (11, 3, 3, 7), (9, 4, 4, 2 ** 31 + 19)])
def test_port_agrees_with_the_reference_in_float64(n_points, n_iter, B,
                                                   seed):
    cfg = tray_cfg(n_points, n_iter)
    ref = reference.Solver(cfg, "cpu")
    w = world.build(cfg, "cpu", torch.float64)
    traj = w.run.problem.traj.double().numpy()
    starts, goals = traffic.endpoints(seed, 0, traj[0], traj[-1],
                                      cfg["sigma"], B)
    probs = problem_batch_from_grid(w.run.problem, starts, goals,
                                    w.run.engine)
    out, fin, done = BatchSolver(w.run.engine).solve(probs, n_iter)
    assert done == n_iter
    T_ref, F_ref = ref.solve(starts, goals)
    assert np.abs(out.traj.numpy() - T_ref.numpy()).max() < 1e-6
    assert np.abs(fin.numpy() - F_ref.numpy()).max() < 1e-5
    moved = T_ref.numpy() - ref.lines(starts, goals).numpy()
    assert np.abs(moved).max() > 1e-4


def _grabbed_module(cfg):
    """Config 1's world in float64 on the CPU with the tray added at the
    hand and grabbed there, as chip_smoke's grab phase does."""
    mug = world.load(CONFIGS / "wam7_table_mug.json")
    w = world.build(mug, "cpu", torch.float64)
    robot = w.robot
    hand = link_poses_np(robot.model, robot.q_active, robot.pose)[
        robot.model.link_names.index("handbase")]
    tray = w.module.add_kinbody(KinBody(
        "tray", pt.Scene.build(spheres=tray_spheres()),
        pose=np_pose.compose(hand, TRAY_OFFSET)))
    robot.grab(tray, "handbase")
    return w, robot


def test_file_robot_is_the_grabbed_tray():
    cfg = tray_cfg(n_points=9)
    grabbed, robot = _grabbed_module(cfg)
    filed = world.build(cfg, "cpu", torch.float64)
    a, b = filed.robot.model, robot.model
    assert len(a.sphere_radius) == len(b.sphere_radius) == 16 + N_TRAY
    assert a.link_names == b.link_names
    assert np.array_equal(a.sphere_link, b.sphere_link)
    # a grab takes the tray's spheres from its Scene, which holds them in
    # float32: equal to that rounding (~1e-8 m at 0.22 m)
    assert np.abs(a.sphere_radius - b.sphere_radius).max() < 1e-8
    assert np.abs(np.asarray(a.sphere_pos)
                  - np.asarray(b.sphere_pos)).max() < 1e-8
    assert np.array_equal(a.sphere_active_mask(), b.sphere_active_mask())
    # the engines of a create with the file's arguments on each module
    h = grabbed.module.create(robot=robot.name, **filed.kwargs)
    ea, eb = filed.run.engine, grabbed.module.runs[h].engine
    assert ea.n_spheres_active == eb.n_spheres_active == 125
    assert filed.run.problem.inactive_pos.shape[0] == 1
    assert torch.equal(ea.pairs[0], eb.pairs[0])
    assert torch.equal(ea.pairs[1], eb.pairs[1])
    assert (ea.pairs[2] - eb.pairs[2]).abs().max() < 1e-8
    assert ea.pairs[0].shape[0] == 3617


def test_endpoints_are_upright_inside_the_limits():
    cfg = tray_cfg()
    mug = world.load(CONFIGS / "wam7_table_mug.json")
    rb = reference.Robot(cfg, False)
    ends = [np.asarray(cfg["robot"]["start"]),
            np.asarray(cfg["create"]["adofgoal"])]
    given = [np.asarray(mug["robot"]["start"]),
             np.asarray(mug["create"]["adofgoal"])]
    for q, q0 in zip(ends, given):
        R, _ = rb.tool(torch.as_tensor(q))
        roll, pitch, _ = reference.ypr_rows(R)
        assert max(abs(float(roll)), abs(float(pitch))) < 1e-6
        assert np.all((q >= rb.lo) & (q <= rb.hi))
        # only J4-J6 moved from test_wam7.py's endpoints
        assert np.array_equal(q[[0, 1, 2, 6]], q0[[0, 1, 2, 6]])
        R0, _ = rb.tool(torch.as_tensor(q0))
        assert max(abs(float(v)) for v in reference.ypr_rows(R0)[:2]) > 0.3
    assumed = cfg["assumed"]["endpoints"]
    assert assumed["start"] == cfg["robot"]["start"]
    assert assumed["goal"] == cfg["create"]["adofgoal"]


def test_float32_takes_the_tiled_path_and_the_fk_table_fits():
    w = world.build(tray_cfg(n_points=9), "cpu")
    eng = w.run.engine
    Sa = eng.n_spheres_active
    SI = int(w.run.problem.inactive_pos.shape[0])
    assert (Sa, SI) == (125, 1)
    assert eng.fields.data.dtype == torch.float32
    assert selfcol.launch_shape(Sa, SI)[0] == "tiled"
    # config 1's 16 spheres stay on the staged path
    assert selfcol.launch_shape(15, 1)[0] == "staged"
    table = eng.fk.fk_table
    assert table.dtype == torch.float32
    assert table.numel() * table.element_size() <= fk_kernel.TABLE_BYTES_MAX
    assert eng.cons.k_total == 2 * eng.spec.m
